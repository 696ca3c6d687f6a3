"""render_views_per_s.host: views rendered and on the host as 8-bit RGB in
the window over the window's seconds (host clock). The host sets this
rate and its speed moves it by some 13% from run to run, so it is read per
layer; ``render_device_ms_per_view`` is the cell's end-to-end metric."""


def read(run):
    if run.kind != "render" or run.window_s <= 0:
        return None
    return run.units / run.window_s
