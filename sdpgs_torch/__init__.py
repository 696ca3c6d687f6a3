"""SDP-GS in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The PyTorch counterpart of ``sdpgs_tpu``: module names mirror that package
so each function's reference is easy to find. It imports neither JAX nor
anything of ``sdpgs_tpu``.

So far the port covers these paths. Serving: load a trained cloud from a
PLY, render views (preprocess + SH, tile binning, compositing) and write
them out (``cli/render_cli.render_set``). Training: the plain train step
(``train/step.make_train_step``), one combined loss, one backward and one
Adam step. Pseudo-view training: the same step with ``with_pseudo=True``,
which renders a second view from a pseudo camera and adds the depth net's
Pearson (``models/``: DPT-Hybrid, differentiable into the image), the
per-segment Pearson and the reprojection consistency against z-buffers
that ``train/loop.prefetch_pseudo_reproj`` builds for 64 pseudo cameras at
a time. The training loop: ``train/loop.Trainer`` runs both steps on a
schedule with densify and prune (``opt/densify.py``, the k-NN of
``ops/knn.py``), the opacity reset, the capacity ladder, evaluation and
checkpoints, on a dataset loaded from disk (``data/scene.Scene``: COLMAP,
Blender and mip-NeRF-360 trees) or an in-memory
``data/synthetic.SyntheticScene``; ``python -m sdpgs_torch.cli.train_cli
-s <scene> -m <out>`` drives it with the JAX package's flags. Evaluation:
``cli/render_cli`` and ``cli/metrics_cli`` (PSNR, SSIM, LPIPS-VGG16 of
``models/lpips.py``). The depth prior: ``pipelines/`` (segment-wise depth
alignment, multi-view fusion, the MVS and COLMAP helpers) over the
``native/`` I/O library; ``viewer/`` serves SIBR's remote viewer and
``utils/profiling`` traces and spans the port's phases. Multi-card training: ``parallel/`` puts the
train step and the ``Trainer`` on a (data, gauss, tile) mesh of
``torch.distributed`` ranks. Ten
kernels in ``csrc/`` carry them on the card: three forward (preprocess,
binning, compositing), two backward (preprocess, compositing), the
reprojection z-buffer, the fused Adam update (``opt/adam.py``), the
k-NN of densify and the init scales (``ops/knn.py``), and two that serve
their own entry points, the stable depth sort (``ops/sort.py``) and the
launch-floor probe (``ops/launch_floor.py``). Beside each wrapper sits a plain PyTorch
version of the same function, used for CPU tensors and as the kernel's
check.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device and without that request they raise.
"""

from __future__ import annotations

__version__ = "0.1.0"

import torch

# Geometry (projection, covariance, conic inversion) needs true f32: keep
# TF32 off for matmuls and cuDNN, the counterpart of the JAX package's
# "highest" default matmul precision.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda``; raises when no CUDA device exists and none was asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "sdpgs_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return torch.device("cuda")


from sdpgs_torch.core.camera import Camera  # noqa: E402,F401
from sdpgs_torch.core.gaussians import Gaussians  # noqa: E402,F401
