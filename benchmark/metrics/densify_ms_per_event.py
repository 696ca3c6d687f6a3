"""densify_ms_per_event: milliseconds of each densify-and-prune event of
the window (train/loop._maybe_densify, opt/densify), a synchronised
bracket around the call (host clock); their mean."""


def read(run):
    ms = run.brackets.get("densify") or []
    return sum(ms) / len(ms) if ms else None
