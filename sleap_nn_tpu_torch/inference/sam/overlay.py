"""Review overlay PNGs for predicted segmentation masks: the PyTorch
port's counterpart of ``sleap_nn_tpu/inference/sam/overlay.py``, a copy
(cv2 inside the function; reference sleap_nn/inference/sam/overlay.py:37).
Renders one labeled frame with a colored half-transparent fill + contour
per mask so a human can eyeball predictions before import. Masks scoring below an optional
``low_score_threshold`` (the backend's ``pred_iou_min``) are flagged with a
thick warning-red outline and a ``!score`` label near the centroid.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

# Per-instance overlay colors (RGB), cycled by mask index.
_COLORS = [
    (255, 80, 80), (80, 255, 80), (80, 80, 255), (255, 255, 80),
    (255, 80, 255), (80, 255, 255), (255, 160, 80), (160, 80, 255),
]
_WARNING = (255, 0, 0)


def save_mask_overlay(
    labels,
    path,
    frame_index: int = 0,
    low_score_threshold: Optional[float] = None,
) -> Optional[Path]:
    """Write an overlay PNG for one labeled frame; None if nothing to render."""
    import cv2

    frames = list(labels.labeled_frames)
    if not frames or frame_index >= len(frames):
        return None
    lf = frames[frame_index]

    img = np.asarray(lf.image)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    rgb = (np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img).astype(np.float32)
    H, W = rgb.shape[:2]

    masks = list(getattr(lf, "masks", []) or [])
    if not masks:
        return None

    # Pass 1: half-transparent fills on the float canvas.
    rendered = []  # (mask, color, flagged, score)
    for i, m in enumerate(masks):
        raw = np.asarray(m.mask, bool)
        mm = np.zeros((H, W), bool)
        hh, ww = min(H, raw.shape[0]), min(W, raw.shape[1])
        mm[:hh, :ww] = raw[:hh, :ww]
        score = float(getattr(m, "score", 0.0))
        flagged = low_score_threshold is not None and score < low_score_threshold
        color = np.array(_COLORS[i % len(_COLORS)], np.float32)
        rgb[mm] = 0.5 * rgb[mm] + 0.5 * color
        rendered.append((mm, color, flagged, score))

    # Pass 2: contours + low-score labels on uint8 (cv2 drawing needs CV_8U).
    canvas = np.ascontiguousarray(np.clip(rgb, 0, 255).astype(np.uint8))
    for mm, color, flagged, score in rendered:
        contours, _ = cv2.findContours(
            mm.astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
        )
        if flagged:
            cv2.drawContours(canvas, contours, -1, _WARNING, 4)
            ys, xs = np.nonzero(mm)
            if xs.size:
                cv2.putText(canvas, f"!{score:.2f}", (int(xs.mean()), int(ys.mean())),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.5, _WARNING, 1, cv2.LINE_AA)
        else:
            cv2.drawContours(canvas, contours, -1, tuple(int(c) for c in color), 2)

    out_path = Path(path).expanduser()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(out_path.as_posix(), canvas[..., ::-1])
    return out_path
