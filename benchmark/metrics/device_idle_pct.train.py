"""device_idle_pct.train: the share of an iteration in which no device
operation ran, in percent: the device's busy time an iteration in the
profiled chunk (the union of its operations) over the time an iteration
takes unprofiled and unbracketed (a chunk timed by the host's clock)."""


def read(run):
    tr = run.trace
    if run.kind != "train" or tr is None or not tr.device_ops or not run.traced_units \
            or not run.unit_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / run.traced_units / run.unit_s)
