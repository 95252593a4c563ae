"""Frame-level SAM mask producer: the PyTorch port's counterpart of
``sleap_nn_tpu/inference/sam/mask_layer.py``, a copy (reference
sleap_nn/inference/sam/mask_layer.py:59).

``SamSegmentationLayer`` takes a frame image + its pose/centroid instances,
builds one prompt per instance, runs the backend once per frame, and emits
``SegmentationMask`` objects ready to attach to ``LabeledFrame.masks``.
There is no trained pose net involved — this layer turns existing poses into
prompted masks for human review.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from sleap_nn_tpu_torch.inference.sam.backends import MaskBackend, disjointify
from sleap_nn_tpu_torch.inference.sam.prompts import (
    PROMPT_MODES,
    SamPrompt,
    prompt_for_instance,
    visible_keypoints,
)
from sleap_nn_tpu_torch.io.model import PredictedInstance, SegmentationMask


def _frame_gray(image: np.ndarray) -> np.ndarray:
    """Normalize a frame array to ``(H, W)`` uint8 grayscale."""
    img = np.asarray(image)
    if img.ndim == 4:
        img = img[0]
    if img.ndim == 3:
        if img.shape[0] in (1, 3) and img.shape[0] < img.shape[-1]:
            img = np.moveaxis(img, 0, -1)  # (C, H, W) -> (H, W, C)
        img = img.mean(axis=-1) if img.shape[-1] == 3 else img[..., 0]
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    return img


class SamSegmentationLayer:
    """Per-frame prompted mask production with pose/centroid/box prompts.

    Args:
        backend: A :class:`MaskBackend`.
        prompt_mode: One of ``"pose"`` / ``"centroid"`` / ``"box"``; ``"pose"``
            applies the pose-if-visible-else-centroid-point product rule.
        anchor_ind: Optional node index used as the centroid anchor.
        disjointify_masks: Make per-frame masks disjoint via keypoint-Voronoi
            when a frame has >= 2 instances.
    """

    def __init__(self, backend: MaskBackend, prompt_mode: str = "pose",
                 anchor_ind: Optional[int] = None, disjointify_masks: bool = False):
        if prompt_mode not in PROMPT_MODES:
            raise ValueError(
                f"prompt_mode must be one of {PROMPT_MODES}, got {prompt_mode!r}."
            )
        self.backend = backend
        self.prompt_mode = prompt_mode
        self.anchor_ind = anchor_ind
        self.disjointify_masks = bool(disjointify_masks)

    def _anchor(self, kpts: np.ndarray, kpts_vis: np.ndarray) -> Optional[np.ndarray]:
        if self.anchor_ind is not None and 0 <= self.anchor_ind < len(kpts):
            a = kpts[self.anchor_ind]
            if np.isfinite(a).all():
                return a.astype(np.float32)
        if len(kpts_vis) > 0:
            return kpts_vis.mean(axis=0).astype(np.float32)
        return None

    def masks_for_frame(
        self, image: np.ndarray, instances: Sequence
    ) -> List[Tuple[SegmentationMask, object]]:
        """One ``(SegmentationMask, source_instance)`` pair per maskable instance.

        Instances with no usable prompt source are skipped; empty backend
        masks are dropped. Masks inherit the source instance's track.
        """
        gray = _frame_gray(image)
        hw = gray.shape
        prompts: List[SamPrompt] = []
        kept = []  # (instance, visible keypoints)
        for inst in instances:
            kpts = np.asarray(inst.numpy()[:, :2], dtype=np.float32)
            kpts_vis = visible_keypoints(kpts)
            try:
                prompt = prompt_for_instance(
                    self.prompt_mode, hw,
                    keypoints=kpts_vis if len(kpts_vis) else None,
                    centroid=self._anchor(kpts, kpts_vis),
                )
            except ValueError:
                continue
            prompts.append(prompt)
            kept.append((inst, kpts_vis))

        if not prompts:
            return []

        masks, scores = self.backend.masks(gray, prompts)
        if self.disjointify_masks and len(masks) >= 2:
            masks = disjointify(masks, [kv[1] for kv in kept])

        out: List[Tuple[SegmentationMask, object]] = []
        for (inst, _), mask, score in zip(kept, masks, scores):
            if mask is None or not mask.any():
                continue
            sm = SegmentationMask(
                mask=np.ascontiguousarray(mask, dtype=bool),
                score=float(score),
                track=getattr(inst, "track", None),
            )
            out.append((sm, inst if isinstance(inst, PredictedInstance) else None))
        return out

    def predict_labels(self, labels) -> List[List[Tuple[SegmentationMask, object]]]:
        """Run :meth:`masks_for_frame` over every labeled frame of a Labels."""
        return [self.masks_for_frame(lf.image, lf.instances) for lf in labels.labeled_frames]
