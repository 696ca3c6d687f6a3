"""render_ms_p95: the 95th percentile of every view's latency in the
window, request to bytes on the host (host clock)."""

import statistics
import sys


def read(run):
    lat = run.latencies_ms
    if run.kind != "render" or len(lat) < 20:
        return None
    print(f"render_ms_p95 over {len(lat)} views", file=sys.stderr)
    return statistics.quantiles(lat, n=20)[18]
