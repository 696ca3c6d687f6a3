"""Reading the device trace of a traced window.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities, CUPTI on the card) and returns a ``Trace``: every device
operation (kernels, copies, sets) with its start and end, the device's
busy time (the union of those intervals), the traced window's length, the
device time by kernel name, and the idle gaps labelled by what the host
was doing in them (the innermost host event, one of the benchmark's
``bench.*`` spans or an aten op, around each gap's middle). The
kernel-name matching is ``chip_smoke.py``'s ``PROFILED`` map, copied.
"""

from __future__ import annotations

import heapq
import re
from dataclasses import dataclass, field

import torch

# the port's kernels by function, as the profiler names them
KERNELS = {
    "K1": ("preprocess_fwd_kernel",),
    "K2": ("cover_words_kernel", "bin_table_kernel"),
    "K3": ("composite_fwd_kernel",),
    "K4": ("preprocess_bwd_kernel",),
    "K5": ("composite_bwd_kernel", "entry_map_kernel", "reduce_kernel"),
    "K6": ("zbuf_cluster_kernel", "fill_kernel", "zbuf_kernel", "finalize_kernel"),
}
_PREFIX = re.compile(r"^(void )?(\(anonymous namespace\)::)?")
TOP = 10


def kernel_matches(event_name: str, kernel: str) -> bool:
    """Whether a profiler name is the port's ``kernel`` (not a library
    kernel that shares the word, as ``at::native::reduce_kernel<...>``)."""
    rest = _PREFIX.sub("", event_name, count=1)
    return rest == kernel or rest.startswith(kernel + "(") or rest.startswith(kernel + "<")


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    device_ops: int = 0
    by_name: dict = field(default_factory=dict)     # name -> (seconds, count)
    idle_by_host: dict = field(default_factory=dict)  # host label -> seconds
    ops: list = field(default_factory=list, repr=False)  # (name, start_us, end_us), by start

    def busy_s_without(self, prefix: str) -> float:
        """The busy time with the operations whose name starts with
        ``prefix`` left out (the union of the others' intervals)."""
        busy, cur_a, cur_b = 0.0, None, None
        for name, a, b in self.ops:
            if name.startswith(prefix):
                continue
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            busy += cur_b - cur_a
        return busy * 1e-6

    def kernel_s(self, kernel: str) -> float:
        return sum(s for name, (s, _) in self.by_name.items()
                   if any(kernel_matches(name, k) for k in KERNELS[kernel]))

    def kernel_launches(self, kernel: str) -> int:
        return sum(n for name, (_, n) in self.by_name.items()
                   if any(kernel_matches(name, k) for k in KERNELS[kernel]))

    def breakdown(self) -> dict:
        ops = sorted(((n, s) for n, (s, _) in self.by_name.items()), key=lambda x: -x[1])
        gaps = sorted(self.idle_by_host.items(), key=lambda x: -x[1])
        return {"device_ops": [[n[:120], s] for n, s in ops[:TOP]],
                "idle_gaps": [[n[:120], s] for n, s in gaps[:TOP]]}


def summarize(device: list, host: list) -> Trace:
    """``device``: (name, start_us, end_us) of every device operation;
    ``host``: (name, start_us, end_us) of host events."""
    tr = Trace()
    if not device:
        return tr
    device.sort(key=lambda e: e[1])
    tr.ops = device
    t0 = min([e[1] for e in device] + [e[1] for e in host])
    t1 = max([e[2] for e in device] + [e[2] for e in host])
    tr.window_s = (t1 - t0) * 1e-6
    tr.device_ops = len(device)
    for name, a, b in device:
        s, n = tr.by_name.get(name, (0.0, 0))
        tr.by_name[name] = (s + (b - a) * 1e-6, n + 1)
    # the busy union and the gaps between its intervals
    gaps, busy, cur_a, cur_b = [], 0.0, device[0][1], device[0][2]
    if cur_a > t0:
        gaps.append((t0, cur_a))
    for _, a, b in device[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    if t1 > cur_b:
        gaps.append((cur_b, t1))
    tr.busy_s = busy * 1e-6
    # label each gap by the innermost host event around its middle: sweep
    # the middles in order, keeping the started events in a heap by start;
    # the latest-started one that has not ended holds the middle
    host = sorted(host, key=lambda e: e[1])
    heap, h = [], 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while h < len(host) and host[h][1] <= mid:
            heapq.heappush(heap, (-host[h][1], host[h][2], host[h][0]))
            h += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        label = heap[0][2] if heap else "host (no event)"
        tr.idle_by_host[label] = tr.idle_by_host.get(label, 0.0) + (b - a) * 1e-6
    return tr


def profiled(fn) -> Trace:
    """Run ``fn()`` under the profiler and read its trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    device, host = [], []
    # the profiler's raw events: building its Python event tree costs
    # minutes for the million host events of a pseudo chunk
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() * 1e-3
        rng = (e.name(), a, a + e.duration_ns() * 1e-3)
        (device if e.device_type().name == "CUDA" else host).append(rng)
    # a host span (record_function, an autograd Function) also shows on the
    # device's timeline as an annotation of the same name; it is no operation
    spans = {name for name, _, _ in host}
    device = [e for e in device if e[0] not in spans]
    return summarize(device, host)
