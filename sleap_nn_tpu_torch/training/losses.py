"""Loss functions and the per-model-type loss assembly.

Port of ``sleap_nn_tpu/training/losses.py``: channel-last tensors, the
same reductions. OHKM selects its top-k channels with a rank mask (a
stable descending sort), as the JAX package does.

Under data-parallel training each process holds its rows of the global
batch, and ``compute_loss`` with a ``group_sum`` (the sum of a tensor over
the processes) returns each one's share of the global batch's loss, with
one collective a call (see its doc). The shares sum to the loss the JAX
package computes on the global batch, and so do their gradients.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def _mse_sums(y_pred: torch.Tensor, y_gt: torch.Tensor,
              batch_mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The masked MSE's numerator and its denominator (before the clamp)."""
    se = (y_pred - y_gt) ** 2
    if batch_mask is None:
        batch_mask = torch.ones(se.shape[0], dtype=se.dtype, device=se.device)
    w = batch_mask.to(se.dtype).reshape((-1,) + (1,) * (se.ndim - 1))
    return (se * w).sum(), w.sum() * (se.numel() / se.shape[0])


def mse_loss(
    y_pred: torch.Tensor, y_gt: torch.Tensor, batch_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean squared error; optional per-sample weights (padded loader rows)."""
    if batch_mask is None:
        return ((y_pred - y_gt) ** 2).mean()
    num, den = _mse_sums(y_pred, y_gt, batch_mask)
    return num / torch.clamp(den, min=1.0)


def _ohkm_pick(l: torch.Tensor, hard_to_easy_ratio: float, min_hard_keypoints: int,
               max_hard_keypoints: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """OHKM's hard channels from the ``(C,)`` channel losses ``l``: their
    mask and their count ``k``."""
    c = l.shape[0]
    best_loss = l.min()
    is_hard = (l / best_loss) >= hard_to_easy_ratio
    n_hard = is_hard.sum()
    max_hard = c if max_hard_keypoints is None else min(max_hard_keypoints, c)
    k = torch.clamp(torch.clamp(n_hard, min=min_hard_keypoints), max=max_hard)
    order = torch.argsort(-l, stable=True)
    ranks = torch.argsort(order, stable=True)
    return ranks < k, k


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
    include, k = _ohkm_pick(l, hard_to_easy_ratio, min_hard_keypoints, max_hard_keypoints)
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


def _ce_sums(y_pred_probs: torch.Tensor, y_gt_onehot: torch.Tensor,
             eps: float = 1e-7) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CE's sum over the tracked rows and their count."""
    logp = torch.log(torch.clamp(y_pred_probs, eps, 1.0))
    per_sample = -(y_gt_onehot * logp).sum(dim=-1)
    valid = y_gt_onehot.sum(dim=-1) > 0
    return (per_sample * valid).sum(), valid.sum()


def categorical_crossentropy(
    y_pred_probs: torch.Tensor, y_gt_onehot: torch.Tensor, eps: float = 1e-7
) -> torch.Tensor:
    """CE on softmax outputs; all-zero GT rows (untracked) contribute 0."""
    num, n = _ce_sums(y_pred_probs, y_gt_onehot, eps)
    return num / torch.clamp(n, min=1)


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
    group_sum: Optional[Callable] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted sum of per-head losses and the per-head breakdown.

    MSE per confmap / PAF / class-map head scaled by ``loss_weight``; CE for
    class vectors; optional OHKM on the confmap head; the fg/bg confmap
    diagnostics ride along in the parts and are never optimized.

    Each part is a ratio of two sums (OHKM's term aside). With
    ``group_sum`` each process holds its rows of a global batch, and the
    sums it needs from the others (the denominators, the numerators of the
    parts it reports, OHKM's channel losses) go through one call of
    ``group_sum``: the loss returned is this process's share (the
    numerators over its rows, the denominators over the global batch; the
    shares and their gradients sum to the global batch's loss and its
    gradient), and the parts are the global batch's, detached.
    """
    scored = set()  # the heads whose parts make the loss
    # (part, numerator, denominator): a part is the sum of its numerators
    # each over its denominator, clamped to at least 1.
    ratios: List[Tuple[str, Any, Any]] = []
    mined = None  # (part, target, prediction) of the OHKM head
    for head in heads:
        name = head.name
        target_key = _HEAD_TARGETS.get(name)
        if target_key is None or target_key not in targets:
            continue
        y = targets[target_key]
        y_hat = preds[name]
        scored.add(name)
        if name == "ClassVectorsHead":
            num, n_valid = _ce_sums(y_hat, y)
            valid = y.sum(dim=-1) > 0
            hit = y_hat.argmax(dim=-1) == y.argmax(dim=-1)
            ratios += [(name, num, n_valid), ("class_accuracy", (hit & valid).sum(), n_valid)]
        elif name == "SegmentationHead":
            ratios.append((name, bce_dice_on_probs(
                y_hat, y,
                bce_weight=getattr(head, "bce_weight", 0.5),
                dice_weight=getattr(head, "dice_weight", 0.5),
                pos_weight=getattr(head, "bce_pos_weight", None),
            ), 1))
        elif name == "CenterOffsetHead":
            mask = targets.get("offsets_mask")
            ratios.append((name, compute_masked_smooth_l1(
                y_hat, y, mask if mask is not None else torch.ones_like(y[..., :1])), 1))
        else:
            ratios.append((name, *_mse_sums(y_hat, y, batch_mask)))
            if ohkm and ohkm.get("online_mining") and target_key == "confmaps":
                mined = (name, y, y_hat)
    ratios += _confmap_fg_bg_diagnostics(preds, targets, heads)

    l = None if mined is None else ((mined[2] - mined[1]) ** 2).sum(dim=(0, 1, 2))  # (C,)
    summed = None  # the denominators, then the numerators, over the processes
    if group_sum is not None:
        device = next(iter(preds.values())).device

        def f64(x):
            return torch.as_tensor(x, device=device).detach().double().reshape(-1)

        local = [f64(d) for _, _, d in ratios] + [f64(n) for _, n, _ in ratios]
        if mined is not None:  # then OHKM's channel losses and batch size
            local += [f64(l), f64(mined[1].shape[0])]
        summed = group_sum(torch.cat(local))

    n = len(ratios)
    parts: Dict[str, torch.Tensor] = {}
    shares: Dict[str, torch.Tensor] = {}
    for i, (part, num, den) in enumerate(ratios):
        if summed is None:
            parts[part] = num / torch.clamp(torch.as_tensor(den, device=num.device), min=1)
            continue
        den = torch.clamp(summed[i], min=1)
        dtype = num.dtype if num.is_floating_point() else torch.float32
        if part in scored:
            shares[part] = num / den.to(dtype)
        parts[part] = (summed[n + i] / den).to(dtype)
    if mined is not None:
        name, y, _ = mined
        b, h, w, _ = y.shape
        l_all = l if summed is None else summed[2 * n:-1]
        include, k = _ohkm_pick(l_all, ohkm.get("hard_to_easy_ratio", 2.0),
                                ohkm.get("min_hard_keypoints", 2),
                                ohkm.get("max_hard_keypoints"))
        scale = ohkm.get("loss_scale", 5.0)
        if summed is None:
            parts[name] = parts[name] + (l * include).sum() * scale / (b * h * w * k)
        else:
            den = summed[-1] * h * w * k
            shares[name] = shares[name] + ((l * include).sum() * scale / den).to(l.dtype)
            parts[name] = parts[name] + ((l_all * include).sum() * scale / den).to(l.dtype)
    return weighted_total(parts if summed is None else shares, heads), parts


def weighted_total(parts: Dict[str, torch.Tensor], heads: Sequence):
    """The loss from its parts: each head's part times its ``loss_weight``
    (1 where unset), over the heads that have one."""
    total = 0.0
    for head in heads:
        if head.name in parts:
            total = total + (1.0 if head.loss_weight is None else head.loss_weight) \
                * parts[head.name]
    return total


@torch.no_grad()
def _confmap_fg_bg_diagnostics(preds, targets, heads, threshold: float = 0.5) -> List:
    """Diagnostics only, as ``compute_loss`` ratios: confmap MSE split by
    ground-truth foreground (``> threshold``) and background (``<
    threshold``), and the foreground fraction: ``confmap_loss_fg``,
    ``confmap_loss_bg``, ``confmap_fg_frac``."""
    if "confmaps" not in targets:
        return []
    cm_head = next(
        (h for h in heads
         if _HEAD_TARGETS.get(h.name) == "confmaps" and h.name in preds),
        None,
    )
    if cm_head is None:
        return []
    y = targets["confmaps"]
    se = (preds[cm_head.name] - y) ** 2
    fg = (y > threshold).to(se.dtype)
    bg = (y < threshold).to(se.dtype)
    # A sum over no pixel is 0, and 0 over the clamped count is the JAX
    # package's 0 for an empty class.
    return [("confmap_loss_fg", (se * fg).sum(), fg.sum()),
            ("confmap_loss_bg", (se * bg).sum(), bg.sum()),
            ("confmap_fg_frac", fg.sum(), fg.numel())]
