"""Multi-view geometric-consistency depth fusion -> initialization point
cloud (reference depthfusion.py:155-409, MVSNet-style).

Counterpart of ``sdpgs_tpu/pipelines/fusion.py``. Per reference view:

1. scale-and-shift the mono depth to the view's sparse depth (host numpy),
2. reproject into every source view and back (``reproject_with_depth``),
3. geometric consistency: reprojection error < 5 px AND relative depth
   error < 0.2 (depthfusion.py:186-211; ``check_geometric_consistency``),
4. keep pixels consistent in >= ``min_consistent`` views; the fused depth is
   the mean over the consistent views,
5. back-project to world points, concatenate over views, subsample.

Steps 2-4 are torch on ``device`` (``cuda`` unless the caller asks for
another), one (reference, source) pair per call; step 5 is host numpy, as in
the JAX package. The products keep JAX's order (``(inv(K) @ uv1) * depth``,
``R.T @ (cam - t)``), and each 3x3 inverse is taken on the host in f32 so
the card and the CPU share it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from sdpgs_torch.pipelines.depth_align import compute_scale_and_shift


def _pixel_index(x: torch.Tensor, hi: int) -> torch.Tensor:
    """Round half to even and clip to [0, hi] as int32, giving what XLA's
    ``jnp.clip(jnp.round(x).astype(int32), 0, hi)`` gives for every input:
    XLA's conversion saturates (NaN to 0, +-inf and |x| >= 2^31 to the int32
    ends), where torch's cast of a non-finite value is undefined and
    differs between the CPU and CUDA. Clipping in float first, with NaN
    taken to 0, is the same map."""
    r = torch.round(x)
    r = torch.where(torch.isnan(r), torch.zeros_like(r), r)
    return torch.clamp(r, 0, hi).to(torch.int32)


def _on(m, dev) -> torch.Tensor:
    return torch.as_tensor(m, dtype=torch.float32).to(dev)


def _inv_on(m, dev) -> torch.Tensor:
    return torch.linalg.inv(torch.as_tensor(m, dtype=torch.float32).cpu()).to(dev)


def reproject_with_depth(depth_ref, K_ref, R_ref, t_ref, depth_src, K_src, R_src, t_src):
    """Project the reference pixels into the source view, sample the source
    depth there (nearest), and project back (reference
    depthfusion.py:155-185). Depths are [H, W] tensors on one device; the
    camera matrices (w2c) may be numpy or tensors anywhere. Returns
    (reprojected depth in ref, x2d_reprojected, y2d_reprojected, x2d_src,
    y2d_src). The sample index is clipped to the *reference* view's size,
    as in the reference: views of unequal size are not supported."""
    dev = depth_ref.device
    H, W = depth_ref.shape
    iK_ref, iK_src = _inv_on(K_ref, dev), _inv_on(K_src, dev)
    K_ref, R_ref, t_ref = _on(K_ref, dev), _on(R_ref, dev), _on(t_ref, dev)
    K_src, R_src, t_src = _on(K_src, dev), _on(R_src, dev), _on(t_src, dev)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    uv1 = torch.stack([xs.reshape(-1), ys.reshape(-1),
                       torch.ones(H * W, dtype=torch.float32, device=dev)], 0)

    # ref pixel -> world
    cam_pts = (iK_ref @ uv1) * depth_ref.reshape(1, -1)
    world = R_ref.T @ (cam_pts - t_ref[:, None])
    # world -> src
    src_cam = R_src @ world + t_src[:, None]
    src_uv = K_src @ src_cam
    x_src = src_uv[0] / src_uv[2]
    y_src = src_uv[1] / src_uv[2]

    xi = _pixel_index(x_src, W - 1)
    yi = _pixel_index(y_src, H - 1)
    sampled = depth_src[yi.long(), xi.long()]

    # src pixel (at the sampled depth) -> world -> ref
    src_pts = (iK_src @ torch.stack([x_src, y_src, torch.ones_like(x_src)], 0)
               ) * sampled[None, :]
    world2 = R_src.T @ (src_pts - t_src[:, None])
    ref_cam = R_ref @ world2 + t_ref[:, None]
    depth_reproj = ref_cam[2].reshape(H, W)
    ref_uv = K_ref @ ref_cam
    x_reproj = (ref_uv[0] / ref_uv[2]).reshape(H, W)
    y_reproj = (ref_uv[1] / ref_uv[2]).reshape(H, W)
    return depth_reproj, x_reproj, y_reproj, x_src.reshape(H, W), y_src.reshape(H, W)


def check_geometric_consistency(depth_ref, K_ref, R_ref, t_ref, depth_src, K_src, R_src, t_src,
                                pix_thresh: float = 5.0, rel_depth_thresh: float = 0.2):
    """reference depthfusion.py:186-211. Returns (mask, reprojected depth
    where the mask holds, else 0)."""
    dev = depth_ref.device
    H, W = depth_ref.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    depth_reproj, x_r, y_r, _, _ = reproject_with_depth(
        depth_ref, K_ref, R_ref, t_ref, depth_src, K_src, R_src, t_src)
    dist = torch.sqrt((x_r - xs) ** 2 + (y_r - ys) ** 2)
    depth_diff = torch.abs(depth_reproj - depth_ref)
    rel = depth_diff / torch.clamp_min(depth_ref, 1e-8)
    mask = (dist < pix_thresh) & (rel < rel_depth_thresh) & (depth_ref > 0)
    return mask, torch.where(mask, depth_reproj, torch.zeros_like(depth_reproj))


def fuse_depths(
    mono_depths: Sequence[np.ndarray],     # per-view mono depth [H, W]
    sparse_depths: Sequence[np.ndarray],   # per-view sparse depth (0 holes)
    Ks: Sequence[np.ndarray],
    Rs: Sequence[np.ndarray],              # w2c rotations
    ts: Sequence[np.ndarray],
    colors: Sequence[np.ndarray] | None = None,   # [H, W, 3] per view
    min_consistent: int = 1,
    downsample_to: int | None = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (points [N, 3], colors [N, 3]); reference filter_depth
    (depthfusion.py:234-409). The consistency checks run on ``device``
    (``cuda`` unless the caller asks for another)."""
    from sdpgs_torch import default_device

    dev = default_device(device)
    V = len(mono_depths)
    aligned = []
    for v in range(V):
        valid = sparse_depths[v] > 0
        if valid.sum() >= 2:
            a, b = compute_scale_and_shift(mono_depths[v][valid], sparse_depths[v][valid])
        else:
            a, b = 1.0, 0.0
        aligned.append(torch.as_tensor(np.asarray(a * mono_depths[v] + b, np.float32),
                                       device=dev))

    all_pts, all_cols = [], []
    for ref in range(V):
        H, W = aligned[ref].shape
        geo_count = torch.zeros((H, W), dtype=torch.float32, device=dev)
        depth_sum = aligned[ref]
        for src in range(V):
            if src == ref:
                continue
            mask, d = check_geometric_consistency(
                aligned[ref], Ks[ref], Rs[ref], ts[ref], aligned[src], Ks[src], Rs[src], ts[src])
            geo_count = geo_count + mask
            depth_sum = depth_sum + d
        fused = (depth_sum / (geo_count + 1.0)).cpu().numpy()
        keep = (geo_count >= min_consistent).cpu().numpy() & (fused > 0)

        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        uv1 = np.stack([xs[keep], ys[keep], np.ones(keep.sum())], 0)
        cam = np.linalg.inv(Ks[ref]) @ uv1 * fused[keep][None]
        world = Rs[ref].T @ (cam - ts[ref][:, None])
        all_pts.append(world.T)
        if colors is not None:
            all_cols.append(colors[ref][keep])
        else:
            all_cols.append(np.full((int(keep.sum()), 3), 0.5))

    pts = np.concatenate(all_pts, 0).astype(np.float32)
    cols = np.concatenate(all_cols, 0).astype(np.float32)
    if downsample_to is not None and len(pts) > downsample_to:
        step = len(pts) // downsample_to
        pts, cols = pts[::step], cols[::step]
    return pts, cols


def voxel_downsample(points: np.ndarray, colors: np.ndarray, voxel: float):
    """Average points and colors per voxel (open3d replacement); exact cell
    identity through unique rows (hashes would merge distinct cells)."""
    q = np.floor(points / voxel).astype(np.int64)
    _, inv, counts = np.unique(q, axis=0, return_inverse=True, return_counts=True)
    m = counts.shape[0]
    out_p = np.zeros((m, 3), np.float64)
    out_c = np.zeros((m, 3), np.float64)
    np.add.at(out_p, inv, points)
    np.add.at(out_c, inv, colors)
    return (out_p / counts[:, None]).astype(np.float32), (
        out_c / counts[:, None]
    ).astype(np.float32)
