"""Loss functions and the per-model-type loss assembly.

Port of ``sleap_nn_tpu/training/losses.py``: channel-last tensors, the
same reductions. OHKM selects its top-k channels with a rank mask (a
stable descending sort), as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def mse_loss(
    y_pred: torch.Tensor, y_gt: torch.Tensor, batch_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean squared error; optional per-sample weights (padded loader rows)."""
    se = (y_pred - y_gt) ** 2
    if batch_mask is None:
        return se.mean()
    w = batch_mask.to(se.dtype).reshape((-1,) + (1,) * (se.ndim - 1))
    denom = torch.clamp(w.sum() * (se.numel() / se.shape[0]), min=1.0)
    return (se * w).sum() / denom


def compute_ohkm_loss(
    y_gt: torch.Tensor,
    y_pr: torch.Tensor,
    hard_to_easy_ratio: float = 2.0,
    min_hard_keypoints: int = 2,
    max_hard_keypoints: Optional[int] = None,
    loss_scale: float = 5.0,
) -> torch.Tensor:
    """Online hard keypoint mining on ``(B, H, W, C)`` maps."""
    b, h, w, c = y_gt.shape
    l = ((y_pr - y_gt) ** 2).sum(dim=(0, 1, 2))  # (C,)
    best_loss = l.min()
    is_hard = (l / best_loss) >= hard_to_easy_ratio
    n_hard = is_hard.sum()
    max_hard = c if max_hard_keypoints is None else min(max_hard_keypoints, c)
    k = torch.clamp(torch.clamp(n_hard, min=min_hard_keypoints), max=max_hard)
    order = torch.argsort(-l, stable=True)
    ranks = torch.argsort(order, stable=True)
    include = ranks < k
    k_loss = (l * include).sum() * loss_scale
    return k_loss / (b * h * w * k)


def compute_bce_dice_loss(
    y_pred_logits: torch.Tensor,
    y_gt: torch.Tensor,
    bce_weight: float = 0.5,
    dice_weight: float = 0.5,
    smooth: float = 1.0,
    pos_weight: Optional[float] = None,
) -> torch.Tensor:
    """BCE-with-logits + Dice on ``(B, H, W, 1)``."""
    z, y = y_pred_logits, y_gt
    pw = 1.0 if pos_weight is None else pos_weight
    bce = -(pw * y * F.logsigmoid(z) + (1 - y) * F.logsigmoid(-z))
    p = torch.sigmoid(z)
    intersection = (p * y).sum(dim=(1, 2))
    union = p.sum(dim=(1, 2)) + y.sum(dim=(1, 2))
    dice = (2.0 * intersection + smooth) / (union + smooth)
    return bce_weight * bce.mean() + dice_weight * (1.0 - dice.mean())


def compute_masked_smooth_l1(
    y_pred: torch.Tensor, y_gt: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Smooth-L1 over masked pixels only (0 when none is masked)."""
    mask_e = torch.broadcast_to(mask, y_pred.shape)
    diff = (y_pred - y_gt) * mask_e
    abs_d = diff.abs()
    sl1 = torch.where(abs_d < 1.0, 0.5 * diff**2, abs_d - 0.5)
    n_valid = mask_e.sum()
    return torch.where(n_valid > 0, sl1.sum() / torch.clamp(n_valid, min=1.0), 0.0)


def categorical_crossentropy(
    y_pred_probs: torch.Tensor, y_gt_onehot: torch.Tensor, eps: float = 1e-7
) -> torch.Tensor:
    """CE on softmax outputs; all-zero GT rows (untracked) contribute 0."""
    logp = torch.log(torch.clamp(y_pred_probs, eps, 1.0))
    per_sample = -(y_gt_onehot * logp).sum(dim=-1)
    valid = y_gt_onehot.sum(dim=-1) > 0
    n = torch.clamp(valid.sum(), min=1)
    return (per_sample * valid).sum() / n


_HEAD_TARGETS = {
    "SingleInstanceConfmapsHead": "confmaps",
    "CentroidConfmapsHead": "confmaps",
    "CenteredInstanceConfmapsHead": "confmaps",
    "MultiInstanceConfmapsHead": "confmaps",
    "PartAffinityFieldsHead": "pafs",
    "ClassMapsHead": "class_maps",
    "ClassVectorsHead": "class_vectors",
    "SegmentationHead": "segmentation",
    "InstanceCenterHead": "center_heatmap",
    "CenterOffsetHead": "center_offsets",
}


def bce_dice_on_probs(p: torch.Tensor, y: torch.Tensor, bce_weight=0.5, dice_weight=0.5,
                      smooth: float = 1.0, eps: float = 1e-7,
                      pos_weight: Optional[float] = None) -> torch.Tensor:
    """BCE + Dice on sigmoid outputs (probabilities)."""
    p = torch.clamp(p, eps, 1 - eps)
    pw = 1.0 if pos_weight is None else pos_weight
    bce = -(pw * y * torch.log(p) + (1 - y) * torch.log(1 - p)).mean()
    inter = (p * y).sum(dim=(1, 2))
    union = p.sum(dim=(1, 2)) + y.sum(dim=(1, 2))
    dice = (2 * inter + smooth) / (union + smooth)
    return bce_weight * bce + dice_weight * (1.0 - dice.mean())


def compute_loss(
    preds: Dict[str, torch.Tensor],
    targets: Dict[str, torch.Tensor],
    heads: Sequence,
    batch_mask: Optional[torch.Tensor] = None,
    ohkm: Optional[dict] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted sum of per-head losses and the per-head breakdown.

    MSE per confmap / PAF / class-map head scaled by ``loss_weight``; CE for
    class vectors; optional OHKM on the confmap head; the fg/bg confmap
    diagnostics ride along in the parts and are never optimized.
    """
    total = 0.0
    parts: Dict[str, torch.Tensor] = {}
    for head in heads:
        name = head.name
        target_key = _HEAD_TARGETS.get(name)
        if target_key is None or target_key not in targets:
            continue
        y = targets[target_key]
        y_hat = preds[name]
        if name == "ClassVectorsHead":
            part = categorical_crossentropy(y_hat, y)
            valid = y.sum(dim=-1) > 0
            hit = y_hat.argmax(dim=-1) == y.argmax(dim=-1)
            parts["class_accuracy"] = (hit & valid).sum() / torch.clamp(valid.sum(), min=1)
        elif name == "SegmentationHead":
            part = bce_dice_on_probs(
                y_hat, y,
                bce_weight=getattr(head, "bce_weight", 0.5),
                dice_weight=getattr(head, "dice_weight", 0.5),
                pos_weight=getattr(head, "bce_pos_weight", None),
            )
        elif name == "CenterOffsetHead":
            mask = targets.get("offsets_mask")
            part = compute_masked_smooth_l1(
                y_hat, y, mask if mask is not None else torch.ones_like(y[..., :1]))
        else:
            part = mse_loss(y_hat, y, batch_mask)
            if ohkm and ohkm.get("online_mining") and target_key == "confmaps":
                part = part + compute_ohkm_loss(
                    y,
                    y_hat,
                    hard_to_easy_ratio=ohkm.get("hard_to_easy_ratio", 2.0),
                    min_hard_keypoints=ohkm.get("min_hard_keypoints", 2),
                    max_hard_keypoints=ohkm.get("max_hard_keypoints"),
                    loss_scale=ohkm.get("loss_scale", 5.0),
                )
        weight = 1.0 if head.loss_weight is None else head.loss_weight
        total = total + weight * part
        parts[name] = part
    _add_confmap_fg_bg_diagnostics(preds, targets, heads, parts)
    return total, parts


@torch.no_grad()
def _add_confmap_fg_bg_diagnostics(preds, targets, heads, parts,
                                   threshold: float = 0.5) -> None:
    """Diagnostics only: confmap MSE split by ground-truth foreground
    (``> threshold``) and background (``< threshold``), and the foreground
    fraction: ``confmap_loss_fg``, ``confmap_loss_bg``, ``confmap_fg_frac``."""
    if "confmaps" not in targets:
        return
    cm_head = next(
        (h for h in heads
         if _HEAD_TARGETS.get(h.name) == "confmaps" and h.name in preds),
        None,
    )
    if cm_head is None:
        return
    y = targets["confmaps"]
    se = (preds[cm_head.name] - y) ** 2
    fg = (y > threshold).to(se.dtype)
    bg = (y < threshold).to(se.dtype)
    n_fg, n_bg = fg.sum(), bg.sum()
    parts["confmap_loss_fg"] = torch.where(
        n_fg > 0, (se * fg).sum() / torch.clamp(n_fg, min=1.0), 0.0)
    parts["confmap_loss_bg"] = torch.where(
        n_bg > 0, (se * bg).sum() / torch.clamp(n_bg, min=1.0), 0.0)
    parts["confmap_fg_frac"] = fg.mean()
