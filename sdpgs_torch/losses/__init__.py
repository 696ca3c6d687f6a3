"""Training losses (counterpart of ``sdpgs_tpu/losses``)."""

from sdpgs_torch.losses.basic import (  # noqa: F401
    l1_loss,
    l1_loss_mask,
    l2_loss,
    margin_l2_loss,
    normalize_rows,
    patch_norm_mse_loss,
    patchify,
    pearson_corrcoef,
    psnr,
    ssim,
    ssim_skimage,
)
from sdpgs_torch.losses.depth import (  # noqa: F401
    depth_pearson_loss,
    loss_depth_metric,
    loss_depth_smoothness,
    loss_reproject_depth,
    loss_reproject_from_fused,
    masked_pearson,
    reproject_fused_depth,
    reproject_fused_depth_batch,
    seg_norm_mse_loss,
    segment_pearson_loss,
    warp_depth_to_view,
)
from sdpgs_torch.losses.feature import (  # noqa: F401
    loss_feature_metric,
    penalty_loss,
    segment_cluster_assign,
)
