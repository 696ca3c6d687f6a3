"""Live-viewer server (SIBR remote-viewer wire protocol)."""

from sdpgs_torch.viewer.network_gui import GuiServer  # noqa: F401
