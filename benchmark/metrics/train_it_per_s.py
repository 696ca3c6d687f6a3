"""train_it_per_s: training iterations completed in the window over the
window's seconds (host clock, ending in a synchronise)."""


def read(run):
    if run.kind != "train" or run.window_s <= 0:
        return None
    return run.units / run.window_s
