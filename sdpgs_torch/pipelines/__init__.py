"""Offline depth-prior pipeline: COLMAP runs, dense-depth extraction, MVS
camera export, segment-wise RANSAC depth alignment, and geometric-consistency
depth fusion (counterpart of ``sdpgs_tpu/pipelines``)."""
