"""Metrics over saved renders: PSNR, SSIM, LPIPS (when weights are given)
and their AVGE.

Counterpart of ``sdpgs_tpu/eval/metrics.py``: reference metrics.py:36-93
(the ``results.json`` / ``per_view.json`` layout), metrics_dtu.py:28-118
(DTU object masks, white composite, masked PSNR, the skimage SSIM) and
utils/image_utils.py:28-33 (AVGE, the geometric mean of sqrt(1 - SSIM),
10^(-PSNR/10) and LPIPS). Images load on the host and are scored on
``device`` (``cuda`` unless the caller asks for another). PSNR and SSIM
are computed in float64: in f32, SSIM's mean of terms of both signs over
near-zero variances carries ~1e-5 of summation-order error on a poorly
reconstructed view, so the card's GEMMs and the CPU's would report
different digits; in float64 every device reports the same (the JAX
package computes them in f32, the values agree to its rounding).

LPIPS needs pretrained VGG16 weights converted by ``tools/convert_lpips.py``;
without them its scores are ``None``, as in the JAX package.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from sdpgs_torch import default_device
from sdpgs_torch.losses.basic import psnr as psnr_fn
from sdpgs_torch.losses.basic import ssim as ssim_fn
from sdpgs_torch.losses.basic import ssim_skimage


def avge(ssim_v: float, psnr_v: float, lpips_v: Optional[float]) -> Optional[float]:
    """reference utils/image_utils.py:28-33."""
    if lpips_v is None:
        return None
    terms = [math.sqrt(max(1.0 - ssim_v, 1e-12)), 10.0 ** (-psnr_v / 10.0), max(lpips_v, 1e-12)]
    return math.exp(sum(math.log(t) for t in terms) / 3.0)


def load_image(path) -> np.ndarray:
    from PIL import Image

    return (np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0).transpose(2, 0, 1)


def make_lpips_fn(weights_path: Optional[str] = None, device=None):
    """A callable (img [3, H, W], gt [3, H, W]) -> float or None, scoring
    on ``device`` (``cuda`` unless the caller asks for another). Without
    converted VGG16 weights (no path, or no file there) every pair scores
    None rather than a random network's distance."""
    dev = default_device(device)
    if weights_path is None or not Path(weights_path).exists():
        return lambda a, b: None
    from sdpgs_torch.models.lpips import LPIPS

    model = LPIPS.load(weights_path, device=dev)
    return lambda a, b: float(model(torch.as_tensor(a, device=dev),
                                    torch.as_tensor(b, device=dev)))


def evaluate_dirs(renders_dir, gt_dir, masks_dir=None, lpips_weights: Optional[str] = None,
                  device=None) -> Dict:
    """Metrics over a directory pair (reference metrics.py:24-93). With
    ``masks_dir`` both images are composited on white outside the DTU object
    mask, PSNR is masked and the skimage SSIM is reported too
    (metrics_dtu.py:28-46,92-104)."""
    dev = default_device(device)
    renders_dir, gt_dir = Path(renders_dir), Path(gt_dir)
    names = sorted(p.name for p in renders_dir.iterdir())
    lpips = make_lpips_fn(lpips_weights, device=dev)

    per_view: Dict[str, Dict[str, float]] = {"SSIM": {}, "PSNR": {}, "LPIPS": {}, "AVGE": {},
                                             "SSIM_sk": {}}
    ssims, psnrs, lpipss, avges, ssims_sk = [], [], [], [], []
    for name in names:
        img = load_image(renders_dir / name)
        gt = load_image(gt_dir / name)
        mask = None
        if masks_dir is not None:
            from PIL import Image

            mp = Path(masks_dir) / name
            if mp.exists():
                mask = (np.asarray(Image.open(mp).convert("L"), np.float32) / 255.0)
                mask = (mask > 0.5).astype(np.float32)[None]
                img = img * mask + (1 - mask)
                gt = gt * mask + (1 - mask)
        img_t, gt_t = (torch.as_tensor(x, dtype=torch.float64, device=dev) for x in (img, gt))
        p = float(psnr_fn(img_t, gt_t, torch.as_tensor(mask, dtype=torch.float64, device=dev)
                          if mask is not None else None))
        s = float(ssim_fn(img_t, gt_t))
        if masks_dir is not None:
            sk = float(ssim_skimage(img_t, gt_t))
            ssims_sk.append(sk)
            per_view["SSIM_sk"][name] = sk
        l = lpips(img_t.float(), gt_t.float())
        a = avge(s, p, l)
        psnrs.append(p)
        ssims.append(s)
        per_view["PSNR"][name] = p
        per_view["SSIM"][name] = s
        if l is not None:
            lpipss.append(l)
            per_view["LPIPS"][name] = l
        if a is not None:
            avges.append(a)
            per_view["AVGE"][name] = a

    summary = {
        "SSIM": float(np.mean(ssims)),
        "PSNR": float(np.mean(psnrs)),
        "LPIPS": float(np.mean(lpipss)) if lpipss else None,
        "AVGE": float(np.mean(avges)) if avges else None,
        "SSIM_sk": float(np.mean(ssims_sk)) if ssims_sk else None,
    }
    return {"summary": summary, "per_view": per_view}


def evaluate_model_paths(model_paths: List[str], lpips_weights=None, masks_root=None,
                         device=None) -> None:
    """reference evaluate() (metrics.py:36-93): walk
    ``<model>/test/ours_<iter>/{renders,gt}`` and write ``results.json``
    and ``per_view.json``, scoring on ``device``."""
    dev = default_device(device)
    for scene_dir in model_paths:
        scene_dir = Path(scene_dir)
        full, per_view = {}, {}
        test_dir = scene_dir / "test"
        if not test_dir.exists():
            print(f"no test renders under {scene_dir}")
            continue
        for method_dir in sorted(test_dir.iterdir()):
            if not method_dir.is_dir():
                continue
            res = evaluate_dirs(method_dir / "renders", method_dir / "gt", masks_dir=masks_root,
                                lpips_weights=lpips_weights, device=dev)
            full[method_dir.name] = res["summary"]
            per_view[method_dir.name] = res["per_view"]
            print(f"{scene_dir.name}/{method_dir.name}: "
                  f"PSNR {res['summary']['PSNR']:.4f} SSIM {res['summary']['SSIM']:.4f} "
                  f"LPIPS {res['summary']['LPIPS']}")
        (scene_dir / "results.json").write_text(json.dumps(full, indent=2))
        (scene_dir / "per_view.json").write_text(json.dumps(per_view, indent=2))


def aggregate_results(root) -> Dict:
    """Mean metrics over every scene's ``results.json`` under ``root``,
    written to ``<root>/results_all.json`` (the reference pipeline's
    aggregation step, not vendored there)."""
    root = Path(root)
    rows: Dict[str, Dict[str, list]] = {}
    for res in sorted(root.glob("*/results.json")):
        data = json.loads(res.read_text())
        for method, metrics in data.items():
            bucket = rows.setdefault(method, {})
            for k, v in metrics.items():
                if v is not None:
                    bucket.setdefault(k, []).append(v)
    summary = {
        method: {k: float(np.mean(v)) for k, v in ms.items()}
        for method, ms in rows.items()
    }
    (root / "results_all.json").write_text(json.dumps(summary, indent=2))
    for method, ms in summary.items():
        print(method, " ".join(f"{k}={v:.4f}" for k, v in ms.items()))
    return summary
