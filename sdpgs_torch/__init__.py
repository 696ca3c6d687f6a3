"""SDP-GS in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The PyTorch counterpart of ``sdpgs_tpu``: module names mirror that package
so each function's reference is easy to find. It imports neither JAX nor
anything of ``sdpgs_tpu``.

So far the port covers two paths. Serving: load a trained cloud from a
PLY, render views (preprocess + SH, tile binning, compositing) and write
them out (``cli/render_cli.render_set``). Training: the plain train step
(``train/step.make_train_step``), one combined loss, one backward and one
Adam step. Five kernels in ``csrc/`` carry them on the card: three
forward (preprocess, binning, compositing) and two backward (preprocess,
compositing). Beside each wrapper sits a plain PyTorch version of the same
function, used for CPU tensors and as the kernel's check.

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
