"""Depth networks (counterpart of ``sdpgs_tpu/models``)."""
