"""device_idle_pct.render: the share of a view in which no device
operation ran, in percent: the device's busy time a view in the profiled
pass (the union of its operations) over the time a view takes in the
window, which runs unprofiled."""


def read(run):
    tr = run.trace
    if run.kind != "render" or tr is None or not tr.device_ops or not run.traced_units \
            or not run.unit_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / run.traced_units / run.unit_s)
