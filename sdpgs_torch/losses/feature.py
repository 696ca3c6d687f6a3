"""Language-feature losses.

Counterpart of ``sdpgs_tpu/losses/feature.py:17-66`` (reference
utils/loss_utils.py:212-307): ``penalty_loss`` and ``loss_feature_metric``.
``segment_cluster_assign`` comes with the pseudo-view slice.
"""

from __future__ import annotations

import torch

from sdpgs_torch.losses.basic import l1_loss


def _smooth_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """L2-normalize with a smooth norm: the gradient is 0 (not NaN) at
    x == 0, as at every background pixel of a rendered feature image."""
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps * eps)


def _cosine_to_prototypes(feat: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """[N, C] x [S, C] -> [N, S] cosine similarity."""
    return _smooth_normalize(feat) @ _smooth_normalize(protos).T


def penalty_loss(pred: torch.Tensor, penalty: str = "l2") -> torch.Tensor:
    """Spatial smoothness of an [H, W, C] map: mean squared (or absolute)
    first differences along H and W, each divided by ndims = 2
    (reference loss_utils.py:212-248)."""
    dh = pred[1:, :, :] - pred[:-1, :, :]
    dw = pred[:, 1:, :] - pred[:, :-1, :]
    if penalty == "l1":
        return (torch.mean(torch.abs(dh)) + torch.mean(torch.abs(dw))) / 2.0
    return (torch.mean(dh ** 2) + torch.mean(dw ** 2)) / 2.0


def loss_feature_metric(language_feature: torch.Tensor, gt_language_feature: torch.Tensor,
                        prototypes: torch.Tensor, seg_map: torch.Tensor,
                        known_fce: float = 0.01, known_fl1: float = 1.0,
                        known_fsm: float = 1e-6, label_smoothing: float = 1e-3):
    """Label-smoothed cross-entropy of softmax(cosine similarity to the
    [S, 3] prototypes) + L1 + spatial smoothness (reference
    loss_utils.py:251-307) on [3, H, W] feature images and an [H, W] int
    segment map. Returns (loss_feature, loss_smooth)."""
    S = prototypes.shape[0]
    pred = language_feature.permute(1, 2, 0).reshape(-1, 3)
    gt = gt_language_feature.permute(1, 2, 0).reshape(-1, 3)
    p_k = torch.softmax(_cosine_to_prototypes(pred, prototypes), dim=-1)
    seg = torch.clamp(seg_map.reshape(-1).long(), 0, S - 1)
    one_hot = torch.nn.functional.one_hot(seg, S).to(pred.dtype)
    q_k = (1.0 - label_smoothing) * one_hot + label_smoothing / S
    ce = -torch.sum(q_k * torch.log(p_k + 1e-8), dim=1).mean()
    loss_feature = known_fce * ce + known_fl1 * l1_loss(pred, gt)
    loss_smooth = known_fsm * penalty_loss(language_feature.permute(1, 2, 0))
    return loss_feature, loss_smooth
