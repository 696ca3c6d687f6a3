"""idle_ms_per_view.viewer: milliseconds a served view in which the device
is idle in ``viewer.send`` (the viewer's 8-bit conversion and the frame's
bytes to its connection; viewer/network_gui.GuiServer.send), over the
profiled pass (benchmark/spans.py)."""

from benchmark.spans import idle_ms


def read(run):
    return idle_ms(run, "render", ("viewer.send",))
