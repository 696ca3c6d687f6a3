"""prefetch_ms_per_cam: milliseconds of the window's pseudo-camera
prefetches (train/loop.prefetch_pseudo_reproj, K6), a synchronised bracket
around each refill of the queue (host clock), over the cameras made."""


def read(run):
    ms, cams = run.brackets.get("prefetch") or [], run.brackets.get("prefetch_cams") or []
    return sum(ms) / sum(cams) if ms and sum(cams) else None
