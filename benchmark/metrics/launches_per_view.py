"""launches_per_view: device operations per rendered view over the
profiled pass (torch.profiler, CUPTI)."""


def read(run):
    tr = run.trace
    if run.kind != "render" or tr is None or not tr.device_ops or not run.traced_units:
        return None
    return tr.device_ops / run.traced_units
