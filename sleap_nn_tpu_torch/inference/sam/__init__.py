"""SAM-powered prompted instance segmentation for inference + review: the
PyTorch port's counterpart of ``sleap_nn_tpu/inference/sam/``.

Parity target: reference sleap_nn/inference/sam/ (SURVEY.md section 2.10).
SAM here is a mask *predictor* for an existing pose/centroid ``.slp`` so a
human can review/correct masks in the GUI before training, never an
auto-GT generator.

Public surface:

* :func:`get_mask_backend` — explicit, no-default backend selection
  (``"sam_jax"`` runs the port's SAM graph on the card from a local HF
  snapshot; ``"sam"``, ``"sam_legacy"`` and ``"sam3"`` need packages the
  port does not load and raise the JAX package's ImportError).
* :func:`run_sam_segmentation` — load a pose ``.slp``, produce one mask per
  instance with the chosen prompt mode, attach ``SegmentationMask`` objects
  to each frame (poses retained for correction), optionally save + write a
  review overlay PNG. ``device`` defaults to the card (the JAX package's
  default, ``"cpu"``, was one its JAX backend ignored).
* :func:`retrack` + the reconciliation primitives — identity refinement:
  correct an existing tracker's IDs from identity-consistent per-frame
  masks (numpy + scipy only).

Model weights load lazily inside backends; importing this package is free.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Union

from sleap_nn_tpu_torch.inference.sam.backends import (
    HFSamBackend,
    JaxSamBackend,
    SamLegacyBackend,
    MaskBackend,
    Sam3Backend,
    cleanup_speckle,
    disjointify,
    own_containment,
    pick_candidate,
)
from sleap_nn_tpu_torch.inference.sam.mask_layer import SamSegmentationLayer
from sleap_nn_tpu_torch.inference.sam.prompts import PROMPT_MODES, SamPrompt
from sleap_nn_tpu_torch.inference.sam.reconciliation import (
    IDReconciler,
    MaskAssignment,
    MaskReconciler,
    MatchContext,
    MatchPredicate,
    SwapEvent,
    TrackAssignment,
    TrackNameResolver,
    default_match_predicate,
    majority_vote_names,
    require_centroid_proximity,
    require_min_fraction_inside,
    require_min_keypoints_inside,
    require_reasonable_mask_area,
)
from sleap_nn_tpu_torch.inference.sam.retrack import RetrackResult, retrack

__all__ = [
    "MASK_BACKENDS",
    "MaskBackend",
    "HFSamBackend",
    "JaxSamBackend",
    "SamLegacyBackend",
    "Sam3Backend",
    "SamSegmentationLayer",
    "SamPrompt",
    "PROMPT_MODES",
    "get_mask_backend",
    "run_sam_segmentation",
    "pick_candidate",
    "own_containment",
    "cleanup_speckle",
    "disjointify",
    "IDReconciler",
    "MaskAssignment",
    "MaskReconciler",
    "MatchContext",
    "MatchPredicate",
    "SwapEvent",
    "TrackAssignment",
    "TrackNameResolver",
    "default_match_predicate",
    "majority_vote_names",
    "require_centroid_proximity",
    "require_min_fraction_inside",
    "require_min_keypoints_inside",
    "require_reasonable_mask_area",
    "RetrackResult",
    "retrack",
]

#: Registered explicit backend names — selection has no default.
MASK_BACKENDS = ("sam", "sam_jax", "sam_legacy", "sam3")


def get_mask_backend(
    mask_backend: Optional[str],
    *,
    sam_model_id: str = "facebook/sam-vit-huge",
    device="cuda",
    **kwargs,
) -> MaskBackend:
    """Build a mask backend by explicit name (reference sam/__init__.py:89).

    ``"sam_jax"`` runs a local HF SAM snapshot in the port's graph on
    ``device`` (:class:`JaxSamBackend`); ``"sam"``, ``"sam_legacy"`` and
    ``"sam3"`` make the JAX package's checks and raise its actionable
    ImportError (the port loads no ``transformers`` and no
    ``segment_anything``). An omitted or unknown name raises ValueError.
    """
    if mask_backend is None:
        raise ValueError(
            f"mask_backend is required and has no default; pass one of {MASK_BACKENDS}."
        )
    name = str(mask_backend).lower()
    if name == "sam":
        return HFSamBackend.from_pretrained(model_id=sam_model_id, device=device, **kwargs)
    if name == "sam_jax":
        return JaxSamBackend.from_pretrained(model_id=sam_model_id, device=device, **kwargs)
    if name == "sam_legacy":
        # The original `segment-anything` package (reference SAM1 backend);
        # sam_model_id doubles as the local checkpoint path here.
        return SamLegacyBackend.from_checkpoint(
            checkpoint_path=sam_model_id, device=device, **kwargs)
    if name == "sam3":
        # Gated: raises an actionable ImportError until the installed
        # transformers ships SAM3 (`facebook/sam3`).
        sam3_id = sam_model_id if "sam3" in str(sam_model_id) else "facebook/sam3"
        return Sam3Backend.from_pretrained(
            model_id=sam3_id, device=device, **kwargs)
    raise ValueError(f"Unknown mask_backend {mask_backend!r}; expected one of {MASK_BACKENDS}.")


def run_sam_segmentation(
    source,
    mask_backend: str,
    *,
    prompt_mode: str = "pose",
    sam_model_id: str = "facebook/sam-vit-huge",
    device="cuda",
    anchor_ind: Optional[int] = None,
    disjointify_masks: bool = False,
    backend: Optional[MaskBackend] = None,
    output_path: Optional[Union[str, Path]] = None,
    overlay_path: Optional[Union[str, Path]] = None,
    frames: Optional[Sequence[int]] = None,
    clean_empty_frames: bool = False,
    embed: bool = False,
):
    """Predict per-instance masks for a pose ``.slp`` (reference :143).

    Loads (or accepts) a Labels whose frames carry pose/centroid instances,
    runs the chosen backend + prompt mode, attaches one ``SegmentationMask``
    per instance, and returns a new Labels. Poses are retained alongside the
    masks (correction needs them); frames where the backend yields no mask
    are kept with empty ``masks`` so nothing silently disappears from review.

    Args:
        source: Path to a pose ``.slp``/``.pkg.slp`` or an in-memory Labels.
        mask_backend: Explicit backend name (``"sam_jax"``; ``"sam"`` /
            ``"sam_legacy"`` / ``"sam3"`` with a prebuilt ``backend``).
        prompt_mode: ``"pose"`` / ``"centroid"`` / ``"box"``.
        sam_model_id: Local HF SAM snapshot dir, or an id in the local HF
            cache.
        device: Torch device for the backend model (the card unless
            ``"cpu"``).
        anchor_ind: Centroid anchor node index for ``prompt_mode="centroid"``.
        disjointify_masks: Make per-frame masks disjoint when >= 2 instances.
        backend: Pre-built backend (skips loading; name still validated).
        output_path: Optional ``.slp`` to save to (images not re-embedded by
            default — pass ``embed=True`` for a self-contained package).
        overlay_path: Optional review overlay PNG of the first frame; masks
            below the backend's ``pred_iou_min`` are flagged.
        frames: Optional frame indices (matched against ``lf.frame_idx``) to
            restrict masking to; encoding is the slow step, so subsetting
            avoids unrequested compute.
        clean_empty_frames: Drop fully-empty output frames (no instances and
            no masks) before saving/returning; posed-but-maskless frames stay.
        embed: Embed images into the saved ``.slp``.

    Returns:
        A new Labels with per-frame ``SegmentationMask`` objects.
    """
    from sleap_nn_tpu_torch.inference.sam.overlay import save_mask_overlay
    from sleap_nn_tpu_torch.io.model import LabeledFrame, Labels
    from sleap_nn_tpu_torch.io.slp import load_slp

    if isinstance(source, Labels):
        labels = source
    else:
        labels = load_slp(str(Path(source).expanduser()))

    if backend is None:
        backend = get_mask_backend(
            mask_backend, sam_model_id=sam_model_id, device=device
        )
    elif str(mask_backend).lower() not in MASK_BACKENDS:
        raise ValueError(
            f"Unknown mask_backend {mask_backend!r}; expected one of {MASK_BACKENDS}."
        )

    layer = SamSegmentationLayer(
        backend,
        prompt_mode=prompt_mode,
        anchor_ind=anchor_ind,
        disjointify_masks=disjointify_masks,
    )

    if frames is not None:
        wanted = {int(f) for f in frames}
        source_lfs = [lf for lf in labels.labeled_frames if int(lf.frame_idx) in wanted]
    else:
        source_lfs = list(labels.labeled_frames)

    new_lfs = []
    for lf in source_lfs:
        pairs = layer.masks_for_frame(lf.image, lf.instances)
        new_lfs.append(
            LabeledFrame(
                video=lf.video,
                frame_idx=lf.frame_idx,
                instances=list(lf.instances),  # poses retained for correction
                masks=[sm for sm, _inst in pairs],
            )
        )

    if clean_empty_frames:
        new_lfs = [lf for lf in new_lfs if lf.instances or lf.masks]

    out = Labels(
        labeled_frames=new_lfs,
        videos=list(labels.videos),
        skeletons=list(labels.skeletons),
    )

    if output_path is not None:
        out_path = Path(output_path).expanduser()
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out.save(str(out_path), embed=bool(embed))
    if overlay_path is not None:
        save_mask_overlay(out, overlay_path, low_score_threshold=backend.pred_iou_min)

    return out
