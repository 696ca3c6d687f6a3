"""launches_per_iter: device operations (kernels, copies, sets) per
training iteration over the profiled chunk (torch.profiler, CUPTI)."""


def read(run):
    tr = run.trace
    if run.kind != "train" or tr is None or not tr.device_ops or not run.traced_units:
        return None
    return tr.device_ops / run.traced_units
