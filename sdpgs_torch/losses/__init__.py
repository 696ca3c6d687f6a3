"""Training losses (counterpart of ``sdpgs_tpu/losses``)."""

from sdpgs_torch.losses.basic import (  # noqa: F401
    l1_loss,
    l1_loss_mask,
    pearson_corrcoef,
    psnr,
    ssim,
)
from sdpgs_torch.losses.depth import (  # noqa: F401
    depth_pearson_loss,
    loss_depth_metric,
    masked_pearson,
)
from sdpgs_torch.losses.feature import loss_feature_metric, penalty_loss  # noqa: F401
