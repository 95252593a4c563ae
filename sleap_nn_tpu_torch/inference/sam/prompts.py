"""Prompt builders for SAM-prompted instance segmentation: the PyTorch
port's counterpart of ``sleap_nn_tpu/inference/sam/prompts.py``, a copy
(numpy only; reference sleap_nn/inference/sam/prompts.py:125-250). A
prompt is the per-instance geometric hint handed to a mask backend: positive
point coordinates, an optional box, plus the keypoint box used only by the
candidate-rejection heuristic (never passed to the model). Three modes:

* ``pose`` — every visible keypoint as a positive point + the padded
  keypoint box (strongest).
* ``centroid`` — one positive point (anchor node / keypoint mean); the box
  is kept only for rejection.
* ``box`` — the padded pose box alone, no points.

``prompt_for_instance`` applies the product rule: ``pose`` falls back to a
centroid point when no keypoint is visible.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

# Padded keypoint-box recipe: margin = max(BOX_MARGIN_MIN, BOX_MARGIN_FRAC * side).
BOX_MARGIN_FRAC: float = 0.6
BOX_MARGIN_MIN: float = 15.0

PROMPT_MODES: Tuple[str, ...] = ("pose", "centroid", "box")


@dataclass
class SamPrompt:
    """One instance's prompt.

    ``point_coords``/``point_labels`` are ``(n, 2)``/``(n,)`` positive points
    (labels all 1; no negative prompting) or ``None`` for box-only prompts.
    ``box`` is the ``[x0, y0, x1, y1]`` prompt box or ``None`` for point-only
    modes. ``reject_box`` is always set and is consumed only by
    :func:`sleap_nn_tpu_torch.inference.sam.backends.pick_candidate`.
    """

    point_coords: Optional[np.ndarray]
    point_labels: Optional[np.ndarray]
    box: Optional[np.ndarray]
    reject_box: np.ndarray
    mode: str


def visible_keypoints(points: Optional[np.ndarray]) -> np.ndarray:
    """Finite ``(m, 2)`` rows of an ``(n, 2)`` keypoint array (m may be 0)."""
    if points is None:
        return np.empty((0, 2), np.float32)
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 2)
    return pts[np.isfinite(pts).all(axis=1)]


def keypoint_box(
    pts: np.ndarray,
    hw: Tuple[int, int],
    margin_frac: float = BOX_MARGIN_FRAC,
    margin_min: float = BOX_MARGIN_MIN,
) -> np.ndarray:
    """Padded bounding box ``[x0, y0, x1, y1]`` over keypoints, clamped to hw.

    The per-axis margin grows with the box side but never collapses below
    ``margin_min`` px, so a degenerate single-point instance still gets a
    usable box (reference prompts.py kpt_box semantics).
    """
    pts = np.asarray(pts, dtype=np.float32).reshape(-1, 2)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    margin = np.maximum(margin_min, margin_frac * (hi - lo))
    h, w = hw
    x0, y0 = np.maximum(0.0, lo - margin)
    x1, y1 = np.minimum([w - 1.0, h - 1.0], hi + margin)
    return np.array([x0, y0, x1, y1], np.float32)


def pose_prompt(
    keypoints: np.ndarray,
    hw: Tuple[int, int],
    margin_frac: float = BOX_MARGIN_FRAC,
    margin_min: float = BOX_MARGIN_MIN,
) -> SamPrompt:
    """All visible keypoints as positive points + the padded keypoint box."""
    pts = visible_keypoints(keypoints)
    if len(pts) == 0:
        raise ValueError("pose_prompt needs at least one visible keypoint.")
    box = keypoint_box(pts, hw, margin_frac, margin_min)
    return SamPrompt(pts, np.ones(len(pts), np.int32), box, box, "pose")


def centroid_prompt(
    point: np.ndarray,
    hw: Tuple[int, int],
    keypoints: Optional[np.ndarray] = None,
    margin_frac: float = BOX_MARGIN_FRAC,
    margin_min: float = BOX_MARGIN_MIN,
) -> SamPrompt:
    """One positive point; no box prompt (reject box only)."""
    pt = np.asarray(point, dtype=np.float32).reshape(1, 2)
    vis = visible_keypoints(keypoints)
    if len(vis) > 0:
        reject = keypoint_box(vis, hw, margin_frac, margin_min)
    else:
        reject = keypoint_box(pt, hw, margin_frac, margin_min)
    return SamPrompt(pt, np.ones(1, np.int32), None, reject, "centroid")


def box_prompt(
    keypoints: np.ndarray,
    hw: Tuple[int, int],
    margin_frac: float = BOX_MARGIN_FRAC,
    margin_min: float = BOX_MARGIN_MIN,
) -> SamPrompt:
    """The padded pose box as the only prompt (no points)."""
    pts = visible_keypoints(keypoints)
    if len(pts) == 0:
        raise ValueError("box_prompt needs at least one visible keypoint.")
    box = keypoint_box(pts, hw, margin_frac, margin_min)
    return SamPrompt(None, None, box, box, "box")


def prompt_for_instance(
    mode: str,
    hw: Tuple[int, int],
    keypoints: Optional[np.ndarray] = None,
    centroid: Optional[np.ndarray] = None,
    margin_frac: float = BOX_MARGIN_FRAC,
    margin_min: float = BOX_MARGIN_MIN,
) -> SamPrompt:
    """Dispatch to a prompt builder; ``pose`` falls back to a centroid point.

    Raises ValueError on an unknown mode or a missing prompt source.
    """
    if mode not in PROMPT_MODES:
        raise ValueError(f"Unknown prompt mode {mode!r}; expected one of {PROMPT_MODES}.")
    vis = visible_keypoints(keypoints)
    if mode == "centroid":
        if centroid is None:
            if len(vis) == 0:
                raise ValueError("centroid prompt needs a centroid or visible keypoints.")
            centroid = vis.mean(axis=0)
        return centroid_prompt(centroid, hw, keypoints, margin_frac, margin_min)
    if mode == "box":
        return box_prompt(keypoints, hw, margin_frac, margin_min)
    # pose: pose-if-visible-else-centroid-point.
    if len(vis) > 0:
        return pose_prompt(keypoints, hw, margin_frac, margin_min)
    if centroid is not None:
        return centroid_prompt(centroid, hw, None, margin_frac, margin_min)
    raise ValueError("pose prompt has no visible keypoints and no centroid fallback.")
