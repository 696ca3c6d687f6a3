"""depth_net_ms: milliseconds of the depth net's forward and input
gradient per pseudo iteration of the window, synchronised brackets around
each (host clock)."""


def read(run):
    ms = run.brackets.get("depth_net") or []
    return sum(ms) / run.pseudo_units if ms and run.pseudo_units else None
