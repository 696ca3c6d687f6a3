"""Segment-wise alignment of monocular depth to sparse stereo depth — the
"SDP" core (reference conclude.py:57-411).

Per train view:
1. For each segment with >= 20 valid sparse-depth pixels: robust linear fit
   stereo ~ a * mono + b via RANSAC (min_samples=70%, 500 trials, inlier
   threshold = MAD of the targets — sklearn RANSACRegressor defaults used
   by the reference, conclude.py:91).
2. Segments with too few points inherit (a, b) from boundary-adjacent
   segments (largest first), falling back to the global closed-form
   scale-and-shift; then the line with minimum mean residual
   |stereo - a*mono - b| / sqrt(a^2+1) among all known lines wins
   (conclude.py:111-161).
3. The adjusted map is a_seg * mono + b_seg per pixel.
4. No sparse depth at all -> inverted mono (max - mono), conclude.py:67-71.

The RANSAC trials are fully vectorized ([trials, n] matrix ops) instead of
the reference's sklearn loop. Host numpy: a copy of
``sdpgs_tpu/pipelines/depth_align.py``, operation for operation, so both
packages draw the same RANSAC subsets and pick the same lines.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def compute_scale_and_shift(x: np.ndarray, y: np.ndarray) -> Tuple[float, float]:
    """Closed-form least squares y ~ a*x + b (reference's missing
    ``compare_llff.compute_scale_and_shift``, re-derived)."""
    x = x.reshape(-1).astype(np.float64)
    y = y.reshape(-1).astype(np.float64)
    n = len(x)
    if n == 0:
        return 1.0, 0.0
    sx, sy = x.sum(), y.sum()
    sxx, sxy = (x * x).sum(), (x * y).sum()
    det = n * sxx - sx * sx
    if abs(det) < 1e-12:
        return 1.0, float(y.mean() - x.mean())
    a = (n * sxy - sx * sy) / det
    b = (sy * sxx - sx * sxy) / det
    return float(a), float(b)


def ransac_line(
    x: np.ndarray,
    y: np.ndarray,
    min_samples_frac: float = 0.7,
    trials: int = 500,
    seed: int = 10,
) -> Tuple[float, float]:
    """Vectorized RANSAC linear regression (reference conclude.py:91:
    RANSACRegressor(min_samples=0.7, max_trials=500, random_state=10))."""
    x = x.reshape(-1).astype(np.float64)
    y = y.reshape(-1).astype(np.float64)
    n = len(x)
    if n < 2:
        return 1.0, 0.0
    m = max(2, int(np.ceil(min_samples_frac * n)))
    rng = np.random.default_rng(seed)
    # [trials, m] random subsets
    idx = np.argsort(rng.random((trials, n)), axis=1)[:, :m]
    xs, ys = x[idx], y[idx]
    sx = xs.sum(1)
    sy = ys.sum(1)
    sxx = (xs * xs).sum(1)
    sxy = (xs * ys).sum(1)
    det = m * sxx - sx * sx
    det = np.where(np.abs(det) < 1e-12, 1e-12, det)
    a = (m * sxy - sx * sy) / det
    b = (sy * sxx - sx * sxy) / det
    # inliers: residual < MAD(y) (sklearn's default residual threshold)
    thresh = np.median(np.abs(y - np.median(y))) + 1e-12
    resid = np.abs(y[None, :] - a[:, None] * x[None, :] - b[:, None])
    inliers = resid < thresh
    best = int(np.argmax(inliers.sum(1)))
    mask = inliers[best]
    if mask.sum() >= 2:
        return compute_scale_and_shift(x[mask], y[mask])
    return float(a[best]), float(b[best])


def _boundary_neighbor_ids(seg: np.ndarray, region: np.ndarray) -> list:
    """Segment ids adjacent to ``region`` (reference get_boundary_pixels,
    conclude.py:18-54 — Sobel + 4-neighborhood, re-derived with shifts)."""
    out = []
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        shifted = np.roll(region, (dy, dx), axis=(0, 1))
        # pixels outside the region adjacent to region pixels
        edge = shifted & ~region
        for sid in np.unique(seg[edge]):
            if sid not in out:
                out.append(int(sid))
    return out


def _connected_components(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """4-connected labeling (cv2.connectedComponents replacement)."""
    labels = np.zeros(mask.shape, np.int32)
    cur = 0
    stack = []
    H, W = mask.shape
    for sy in range(H):
        for sx in range(W):
            if mask[sy, sx] and labels[sy, sx] == 0:
                cur += 1
                stack.append((sy, sx))
                labels[sy, sx] = cur
                while stack:
                    y, x = stack.pop()
                    for ny, nx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
                        if 0 <= ny < H and 0 <= nx < W and mask[ny, nx] and labels[ny, nx] == 0:
                            labels[ny, nx] = cur
                            stack.append((ny, nx))
    return labels, cur


def align_depth_segments(
    depth_mono: np.ndarray,    # [H, W] monocular depth (already inverted if needed)
    depth_stereo: np.ndarray,  # [H, W] sparse stereo depth, 0 = hole
    seg: np.ndarray,           # [H, W] int segment ids
    robust_num: int = 20,
    min_component_px: int = 1000,
) -> Tuple[np.ndarray, Dict[int, Tuple[float, float]]]:
    """-> (aligned depth map, per-segment (a, b))."""
    valid = depth_stereo > 0
    if valid.sum() == 0:
        adjusted = depth_mono.max() - depth_mono
        return adjusted, {}

    seg_ids = [int(s) for s in np.unique(seg)]
    lines: Dict[int, Tuple[float, float]] = {}

    for sid in seg_ids:
        m = valid & (seg == sid)
        if m.sum() >= robust_num:
            lines[sid] = ransac_line(depth_mono[m], depth_stereo[m])

    total_a, total_b = compute_scale_and_shift(depth_mono[valid], depth_stereo[valid])
    if not lines:
        lines[seg_ids[0] if seg_ids else 0] = (1.0, 0.0)

    for sid in seg_ids:
        if sid in lines:
            continue
        seg_mask = seg == sid
        # neighbor inheritance over large connected components
        from sdpgs_torch import native

        labels, n_comp = native.connected_components(seg_mask)
        neighbors: list = []
        for lab in range(1, n_comp + 1):
            region = labels == lab
            if region.sum() < min_component_px:
                continue
            neighbors.extend(
                i for i in _boundary_neighbor_ids(seg, region) if i not in neighbors
            )
        neighbors.sort(key=lambda i: (seg == i).sum(), reverse=True)
        for nid in neighbors:
            if nid in lines:
                lines[sid] = lines[nid]
                break
        if sid not in lines:
            lines[sid] = (total_a, total_b)

        m = valid & seg_mask
        if m.sum() > 0:
            # pick the known line with minimal mean residual (conclude.py:150-161)
            dm = depth_mono[m]
            ds = depth_stereo[m]
            best, best_r = lines[sid], np.inf
            for a, b in set(lines.values()):
                r = np.abs(ds - a * dm - b) / np.sqrt(a * a + 1.0)
                if r.mean() < best_r:
                    best_r = r.mean()
                    best = (a, b)
            lines[sid] = best

    adjusted = np.empty_like(depth_mono, dtype=np.float32)
    for sid in seg_ids:
        a, b = lines[sid]
        mask = seg == sid
        adjusted[mask] = a * depth_mono[mask] + b
    return adjusted, lines


def fit_diagnostics(
    depth_mono: np.ndarray,
    depth_stereo: np.ndarray,
    seg: np.ndarray,
    lines: Dict[int, Tuple[float, float]],
    max_scatter: int = 2000,
) -> Dict:
    """Per-unique-line fit diagnostics (reference conclude.py:225-283's
    debugging surface as data): for each distinct (a, b) — several segments
    can share one inherited line — the member segment ids, valid-pixel
    count, mean orthogonal residual |stereo - a*mono - b|/sqrt(a^2+1), and a
    subsampled (mono, stereo) scatter for plotting."""
    valid = depth_stereo > 0
    by_line: Dict[Tuple[float, float], list] = {}
    for sid, ab in lines.items():
        by_line.setdefault(ab, []).append(sid)
    out = []
    for (a, b), sids in sorted(by_line.items()):
        m = valid & np.isin(seg, sids)
        dm = depth_mono[m]
        ds = depth_stereo[m]
        resid = (
            float(np.mean(np.abs(ds - a * dm - b)) / np.sqrt(a * a + 1.0))
            if dm.size
            else float("nan")
        )
        if dm.size > max_scatter:
            pick = np.linspace(0, dm.size - 1, max_scatter).astype(int)
            dm, ds = dm[pick], ds[pick]
        out.append({
            "a": float(a), "b": float(b), "segments": sids,
            "n_valid": int(m.sum()), "mean_residual": resid,
            "scatter_mono": dm.astype(np.float32),
            "scatter_stereo": ds.astype(np.float32),
        })
    return {"lines": out}


def save_fit_diagnostics(
    diag: Dict,
    depth_mono: np.ndarray,
    depth_stereo: np.ndarray,
    adjusted: np.ndarray,
    seg: np.ndarray,
    out_base,
) -> None:
    """Write the diagnostics to ``<out_base>_diag.npz`` and (when matplotlib
    is importable) ``<out_base>_ransac.jpg`` — a grid of per-line segment
    masks + scatter/fit plots — plus mono/stereo/adjust grayscale previews
    (reference conclude.py:225-320 artifacts)."""
    from pathlib import Path

    out_base = Path(out_base)
    flat = {"n_lines": np.int32(len(diag["lines"]))}
    for i, ln in enumerate(diag["lines"]):
        flat[f"line{i}_ab"] = np.array([ln["a"], ln["b"]], np.float64)
        flat[f"line{i}_segments"] = np.asarray(ln["segments"], np.int32)
        flat[f"line{i}_stats"] = np.array(
            [ln["n_valid"], ln["mean_residual"]], np.float64
        )
        flat[f"line{i}_scatter"] = np.stack(
            [ln["scatter_mono"], ln["scatter_stereo"]]
        )
    np.savez_compressed(out_base.parent / f"{out_base.name}_diag.npz", **flat)

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    n = max(len(diag["lines"]), 1)
    n_cols = min(4, n)
    n_rows = -(-n // n_cols)
    fig, ax = plt.subplots(n_rows, 2 * n_cols,
                           figsize=(6 * n_cols, 3.2 * n_rows), squeeze=False)
    xline = np.linspace(depth_mono.min(), depth_mono.max(), 64)
    for i, ln in enumerate(diag["lines"]):
        r, c = divmod(i, n_cols)
        mask = np.isin(seg, ln["segments"])
        ax[r, 2 * c].imshow(mask, cmap="gray")
        ax[r, 2 * c].set_title(f"segs {ln['segments'][:6]}", fontsize=8)
        ax[r, 2 * c].axis("off")
        ax[r, 2 * c + 1].scatter(ln["scatter_mono"], ln["scatter_stereo"], s=0.5)
        ax[r, 2 * c + 1].plot(xline, ln["a"] * xline + ln["b"], "r")
        ax[r, 2 * c + 1].set_title(
            f"a={ln['a']:.3f} b={ln['b']:.3f} r={ln['mean_residual']:.3f}",
            fontsize=8,
        )
    for i in range(len(diag["lines"]), n_rows * n_cols):
        r, c = divmod(i, n_cols)
        ax[r, 2 * c].axis("off")
        ax[r, 2 * c + 1].axis("off")
    fig.savefig(out_base.parent / f"{out_base.name}_ransac.jpg", dpi=80)
    plt.close(fig)
    for arr, tag in ((depth_stereo, "stereo"), (adjusted, "adjust"),
                     (depth_mono, "mono")):
        plt.imsave(out_base.parent / f"{out_base.name}_{tag}.jpg", arr,
                   cmap="gray")


def conclude_depth_for_scene(
    scene_path,
    mono_depth_dir: str = "depth_maps_anything",
    seg_dir: Optional[str] = None,
    out_dir: str = "depth_adjust_maps_stereo_anything",
    invert_mono: bool = True,
    diagnostics: bool = False,
) -> None:
    """Batch run over a scene's train views (reference conclude.py:331-411):
    reads per-view mono PFM + sparse stereo depth + seg maps, writes
    ``depth_<name>.npy`` (+ fit diagnostics artifacts when ``diagnostics``,
    conclude.py:225-320)."""
    from pathlib import Path

    from sdpgs_torch.data.readers import read_pfm

    scene_path = Path(scene_path)
    outp = scene_path / out_dir
    outp.mkdir(parents=True, exist_ok=True)
    for pfm in sorted((scene_path / mono_depth_dir).glob("depth_*.pfm")):
        name = pfm.stem.replace("depth_", "")
        mono = read_pfm(pfm).astype(np.float32)
        if invert_mono:
            mono = mono.max() - mono                # conclude.py:350-351
        stereo_path = scene_path / "stereo_depth" / f"depth_{name}.npy"
        stereo = (
            np.load(stereo_path)
            if stereo_path.exists()
            else np.zeros_like(mono)
        )
        if seg_dir is not None:
            seg = np.load(scene_path / seg_dir / f"{name}_s.npy")
            if seg.ndim == 3:
                seg = seg[0]
        else:
            seg = np.zeros_like(mono, dtype=np.int32)
        seg = seg.astype(np.int32)
        adjusted, lines = align_depth_segments(mono, stereo, seg)
        np.save(outp / f"depth_{name}.npy", adjusted)
        if diagnostics and lines:
            diag = fit_diagnostics(mono, stereo, seg, lines)
            save_fit_diagnostics(
                diag, mono, stereo, adjusted, seg, outp / f"depth_{name}"
            )
