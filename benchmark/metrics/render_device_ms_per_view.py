"""render_device_ms_per_view: the card's time a served view, in ms: the
device's busy time (the union of its operations: K1-K3 and the facade's
small ops) over a profiled pass of the whole path after the window
(torch.profiler, CUPTI), per view. The frame's copy to pageable host
memory is left out: the host's staging sets its length (0.16-0.65 ms a
view on one H100, as the host's speed moves), not the card."""

import sys

PAGEABLE_COPY = "Memcpy DtoH (Device -> Pageable)"


def read(run):
    tr = run.trace
    if run.kind != "render" or tr is None or not tr.device_ops or not run.traced_units:
        return None
    copy_s = sum(s for name, (s, _) in tr.by_name.items() if name.startswith(PAGEABLE_COPY))
    print(f"render_device_ms_per_view: the copy to pageable host memory left out, "
          f"{1e3 * copy_s / run.traced_units:.4f} ms a view", file=sys.stderr)
    return 1e3 * tr.busy_s_without(PAGEABLE_COPY) / run.traced_units
