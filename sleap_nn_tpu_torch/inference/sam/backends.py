"""Mask backends + mask post-processing for SAM-prompted segmentation: the
PyTorch port's counterpart of ``sleap_nn_tpu/inference/sam/backends.py``.

Parity target: reference sleap_nn/inference/sam/backends.py (:314 MaskBackend,
:347 SamBackend, :495 Sam3Backend, plus _pick/_cleanup_speckle/disjointify
helpers). The mask post-processing here is the JAX module's numpy/scipy,
copied.

``JaxSamBackend`` (the backend name ``"sam_jax"``, kept for the command
line) runs the port's SAM graph (``models/sam_jax.py``) on the card unless
the caller asks for the CPU: each frame is encoded once and every prompt of
the frame decodes in one batched call. Its weights come from a local
Hugging Face SAM snapshot; nothing is fetched.

``HFSamBackend``, ``SamLegacyBackend`` and ``Sam3Backend`` keep their
injectable constructors and ``masks()`` (torch only, with the model and
processor given). Their loaders make the JAX package's checks and then
raise its ImportError without importing ``transformers`` or
``segment_anything``: the port loads neither package.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sleap_nn_tpu_torch.inference.sam.prompts import SamPrompt


def to_3ch(img: np.ndarray, clahe: bool = True,
           clahe_clip_limit: float = 3.0,
           clahe_tile_grid: Tuple[int, int] = (8, 8)) -> np.ndarray:
    """Grayscale ``(H, W)`` -> optional CLAHE -> ``(H, W, 3)`` uint8 RGB."""
    import cv2

    src = img[..., 0] if img.ndim == 3 else img
    src = np.ascontiguousarray(src).astype(np.uint8)
    if clahe:
        src = cv2.createCLAHE(clahe_clip_limit, clahe_tile_grid).apply(src)
    return np.repeat(src[..., None], 3, axis=-1)


def pick_candidate(
    masks: np.ndarray,
    scores: np.ndarray,
    reject_box: np.ndarray,
    max_box_area_factor: float = 1.5,
) -> int:
    """Choose the best multimask candidate index (reference backends.py:72).

    Candidates whose area exceeds ``max_box_area_factor`` x reject-box area
    (SAM's over-confident whole-arena candidate) are rejected; the highest
    predicted-IoU survivor wins. If everything is rejected, the smallest
    candidate is returned.
    """
    box_area = max(1.0, float((reject_box[2] - reject_box[0]) * (reject_box[3] - reject_box[1])))
    areas = masks.reshape(len(masks), -1).sum(axis=1).astype(float)
    ok = areas <= max_box_area_factor * box_area
    if ok.any():
        scores = np.where(ok, np.asarray(scores, float), -np.inf)
        return int(np.argmax(scores))
    return int(np.argmin(areas))


def own_containment(mask: np.ndarray, kpts: np.ndarray) -> float:
    """Fraction of visible keypoints inside ``mask`` (a quality score, not a gate).

    Reference backends.py:102; vectorized here.
    """
    kpts = np.asarray(kpts, dtype=np.float32).reshape(-1, 2)
    if len(kpts) == 0:
        return 0.0
    h, w = mask.shape
    xi = np.rint(kpts[:, 0]).astype(int)
    yi = np.rint(kpts[:, 1]).astype(int)
    ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    inside = mask[yi[ok], xi[ok]].sum() if ok.any() else 0
    return float(inside) / len(kpts)


def cleanup_speckle(mask: np.ndarray, kpts: np.ndarray, radius: int = 3) -> np.ndarray:
    """De-speckle a fragmented mask, keeping keypoint-connected components.

    Morphological open (drop specks) + close (fill pinholes), then keep only
    the connected components containing a visible keypoint; fall back to the
    largest component if the cleanup detached every keypoint, or to the raw
    mask if opening erased it entirely (reference backends.py:128 semantics).
    """
    from scipy import ndimage

    mask = np.asarray(mask, dtype=bool)
    if not mask.any():
        return mask
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disk = (yy * yy + xx * xx) <= radius * radius
    mm = ndimage.binary_opening(mask, structure=disk)
    mm = ndimage.binary_closing(mm, structure=disk)
    comp, n = ndimage.label(mm)
    if n == 0:
        return mask
    h, w = mask.shape
    keep = set()
    for x, y in np.asarray(kpts, dtype=np.float32).reshape(-1, 2):
        xi, yi = int(round(float(x))), int(round(float(y)))
        if 0 <= yi < h and 0 <= xi < w and comp[yi, xi] > 0:
            keep.add(int(comp[yi, xi]))
    if not keep:
        sizes = np.bincount(comp.ravel())[1:]
        keep = {int(np.argmax(sizes)) + 1}
    return np.isin(comp, list(keep))


def disjointify(masks: Sequence[np.ndarray], kpts: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Make per-instance masks disjoint via keypoint-Voronoi ownership.

    Contested pixels (claimed by >=2 masks) go to the instance whose nearest
    visible keypoint is closest (reference backends.py:180 semantics).
    """
    from scipy.ndimage import distance_transform_edt

    n = len(masks)
    if n == 0:
        return []
    stack = np.stack([np.asarray(m, bool) for m in masks])
    contested = stack.sum(axis=0) >= 2
    if not contested.any():
        return [m.copy() for m in stack]
    h, w = stack.shape[1:]
    dists = np.full((n, h, w), np.inf, np.float32)
    for i, ks in enumerate(kpts):
        ks = np.asarray(ks, np.float32).reshape(-1, 2)
        seed = np.ones((h, w), bool)
        xi = np.rint(ks[:, 0]).astype(int)
        yi = np.rint(ks[:, 1]).astype(int)
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        seed[yi[ok], xi[ok]] = False
        if not seed.all():
            dists[i] = distance_transform_edt(seed)
    owner = np.argmin(dists, axis=0)
    return [np.where(contested & (owner != i), False, stack[i]) for i in range(n)]


class MaskBackend(ABC):
    """Interface a prompted-mask producer implements (reference :314).

    ``pred_iou_min`` is the per-model nominal predicted-IoU floor surfaced to
    review overlays (a flagging threshold, never a drop-gate).
    """

    pred_iou_min: float = 0.88

    @abstractmethod
    def masks(
        self, image: np.ndarray, prompts: Sequence[SamPrompt]
    ) -> Tuple[List[np.ndarray], List[float]]:
        """Encode ``image`` once and produce one ``(H, W)`` bool mask + score per prompt."""


class HFSamBackend(MaskBackend):
    """SAM through an injected Hugging Face ``SamModel`` + ``SamProcessor``
    pair (the reference's SAM1 ``SamBackend`` role, backends.py:347).
    ``multimask_output`` is always on and :func:`pick_candidate` chooses
    among the 3 candidates. The port loads no ``transformers``:
    :meth:`from_pretrained` raises, and ``"sam_jax"`` runs the same
    snapshots' weights in the port's own graph.
    """

    def __init__(self, model, processor, clahe: bool = True,
                 max_box_area_factor: float = 1.5, pred_iou_min: float = 0.88,
                 device: str = "cuda"):
        self.model = model
        self.processor = processor
        self.clahe = bool(clahe)
        self.max_box_area_factor = float(max_box_area_factor)
        self.pred_iou_min = float(pred_iou_min)
        self.device = device

    @classmethod
    def from_pretrained(cls, model_id: str = "facebook/sam-vit-huge",
                        device: str = "cuda", **kwargs) -> "HFSamBackend":
        raise ImportError(
            "mask_backend='sam' needs `transformers` with SAM support and "
            "torch; install them or pass a prebuilt backend. The PyTorch port "
            "loads no `transformers`: use mask_backend='sam_jax' with a local "
            f"snapshot of {model_id!r}.")

    def masks(self, image, prompts):
        import torch

        rgb = to_3ch(image, clahe=self.clahe)
        out_masks: List[np.ndarray] = []
        out_scores: List[float] = []
        with torch.no_grad():
            for p in prompts:
                kw = {}
                if p.point_coords is not None:
                    kw["input_points"] = [[p.point_coords.tolist()]]
                    kw["input_labels"] = [[p.point_labels.tolist()]]
                if p.box is not None:
                    kw["input_boxes"] = [[p.box.tolist()]]
                inputs = self.processor(rgb, return_tensors="pt", **kw).to(self.device)
                outputs = self.model(**inputs, multimask_output=True)
                cands = self.processor.image_processor.post_process_masks(
                    outputs.pred_masks.cpu(),
                    inputs["original_sizes"].cpu(),
                    inputs["reshaped_input_sizes"].cpu(),
                )[0][0].numpy().astype(bool)  # (3, H, W)
                scores = outputs.iou_scores.cpu().numpy().reshape(-1)
                b = pick_candidate(cands, scores, p.reject_box, self.max_box_area_factor)
                out_masks.append(cands[b])
                out_scores.append(float(scores[b]))
        return out_masks, out_scores


class JaxSamBackend(MaskBackend):
    """SAM in the port's own graph (``models/sam_jax.py``) on one device:
    the card unless ``device="cpu"``, with no fallback. The name is the JAX
    package's, which users type as ``--mask-backend sam_jax``.

    The image is encoded ONCE per frame; the prompts of the frame decode in
    a single batched call, padded to power-of-two buckets of prompts and of
    points as in the JAX backend. Padded points carry label -10 and enter
    the decoder's attention as zero tokens, so the padding is part of the
    numbers, not only of the shapes. ``use_bf16`` casts the weights and the
    image to bfloat16 (the attention softmax stays float32).

    ``params``: a ``SamModel`` state dict (upstream keys, PyTorch layouts;
    tensors or arrays), as ``from_pretrained`` reads it from a snapshot.
    """

    def __init__(self, params, arch, clahe: bool = True,
                 max_box_area_factor: float = 1.5, pred_iou_min: float = 0.88,
                 use_bf16: bool = False, device="cuda"):
        import torch

        from sleap_nn_tpu_torch.inference.backends import resolve_device
        from sleap_nn_tpu_torch.models.sam_jax import SamModel

        self.arch = arch
        self.clahe = bool(clahe)
        self.max_box_area_factor = float(max_box_area_factor)
        self.pred_iou_min = float(pred_iou_min)
        self.device = resolve_device(device)
        self._dtype = torch.bfloat16 if use_bf16 else torch.float32
        self.model = SamModel.from_state_dict(arch, params).to(self.device, self._dtype)

    @classmethod
    def from_pretrained(cls, model_id: str = "facebook/sam-vit-base",
                        device="cuda", **kwargs) -> "JaxSamBackend":
        """Load a local HF SAM snapshot (a dir, or an id found in the local
        HF cache) into the port's graph on ``device``."""
        from sleap_nn_tpu_torch.models.sam_jax import SamArch

        state_dict, config = cls._load_checkpoint(model_id)
        arch = SamArch.from_hf_config(config)
        missing = [k for k in ("shared_image_embedding.positional_embedding",
                               "mask_decoder.iou_token.weight")
                   if k not in state_dict]
        if missing:
            raise ValueError(
                f"checkpoint {model_id!r} is missing SAM keys {missing}; is "
                "this a SamModel checkpoint?"
            )
        kwargs.pop("device", None)
        return cls(state_dict, arch, device=device, **kwargs)

    @staticmethod
    def _load_checkpoint(model_id: str):
        """(state dict of numpy arrays, config dict) of a local snapshot's
        ``model.safetensors`` and ``config.json``. A snapshot that is not
        on disk raises: the port fetches nothing."""
        import json

        from sleap_nn_tpu_torch.models.pretrained import find_local_snapshot, read_safetensors

        snap = find_local_snapshot(str(model_id))
        if snap is None or not (snap / "model.safetensors").exists():
            raise FileNotFoundError(
                f"mask_backend='sam_jax' needs a local SAM snapshot: no "
                f"config.json + model.safetensors for {model_id!r} (a directory, "
                "or an id in the local Hugging Face cache). The port downloads "
                "nothing: pass --sam-model-id /path/to/snapshot.")
        state = read_safetensors(snap / "model.safetensors")
        config = json.loads((snap / "config.json").read_text())
        return state, config

    # -- preprocessing (mirrors SamProcessor: longest-edge resize, ImageNet
    # normalize, zero-pad to square) --
    _MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
    _STD = np.array([0.229, 0.224, 0.225], np.float32) * 255.0

    def _preprocess(self, rgb: np.ndarray):
        import cv2

        h, w = rgb.shape[:2]
        size = self.arch.image_size
        scale = size / max(h, w)
        nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
        resized = cv2.resize(rgb, (nw, nh), interpolation=cv2.INTER_LINEAR)
        norm = (resized.astype(np.float32) - self._MEAN) / self._STD
        padded = np.zeros((size, size, 3), np.float32)
        padded[:nh, :nw] = norm
        return padded[None], (nh, nw), scale

    def _encode(self, pixel: np.ndarray):
        """(1, size, size, 3) preprocessed frame -> its embeddings on the device."""
        import torch

        from sleap_nn_tpu_torch.models.sam_jax import sam_image_encoder

        x = torch.from_numpy(pixel).to(self.device, self._dtype)
        with torch.inference_mode():
            return sam_image_encoder(self.model, self.arch, x)

    def _decode(self, emb, pts: np.ndarray, labs: np.ndarray, boxes: np.ndarray,
                n_points: int, with_box: bool):
        """One batched decode -> (low-res masks (P, 3, m, m), IoU (P, 3)) on the host."""
        import torch

        from sleap_nn_tpu_torch.models.sam_jax import sam_decode

        dev, dt = self.device, self._dtype
        with torch.inference_mode():
            low, iou = sam_decode(
                self.model, self.arch, emb,
                input_points=torch.from_numpy(pts).to(dev, dt) if n_points else None,
                input_labels=torch.from_numpy(labs).to(dev) if n_points else None,
                input_boxes=torch.from_numpy(boxes).to(dev, dt) if with_box else None,
                multimask_output=True,
            )
            return low[0].float().cpu().numpy(), iou[0].float().cpu().numpy()

    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def masks(self, image, prompts):
        import cv2

        n = len(prompts)
        if n == 0:
            return [], []
        rgb = to_3ch(image, clahe=self.clahe)
        orig_h, orig_w = rgb.shape[:2]
        pixel, (nh, nw), scale = self._preprocess(rgb)
        emb = self._encode(pixel)

        with_box = any(p.box is not None for p in prompts)
        n_pts = max((0 if p.point_coords is None else len(p.point_coords))
                    for p in prompts)
        bp = self._bucket(n)
        bn = self._bucket(max(n_pts, 1)) if n_pts else 0

        pts = np.zeros((1, bp, max(bn, 1), 2), np.float32)
        labs = np.full((1, bp, max(bn, 1)), -10, np.int32)
        boxes = np.zeros((1, bp, 4), np.float32)
        for i, p in enumerate(prompts):
            if p.point_coords is not None and n_pts:
                k = len(p.point_coords)
                pts[0, i, :k] = np.asarray(p.point_coords, np.float32) * scale
                labs[0, i, :k] = np.asarray(p.point_labels, np.int32)
            if with_box:
                # prompts lacking a box fall back to their reject box so the
                # batched call stays uniform (HF requires per-prompt boxes).
                src = p.box if p.box is not None else p.reject_box
                boxes[0, i] = np.asarray(src, np.float32) * scale

        low_masks, iou = self._decode(emb, pts, labs, boxes, bn, with_box)  # (bp, 3, m, m)

        out_masks: List[np.ndarray] = []
        out_scores: List[float] = []
        size = self.arch.image_size
        for i, p in enumerate(prompts):
            cands = []
            for c in range(low_masks.shape[1]):
                up = cv2.resize(low_masks[i, c], (size, size),
                                interpolation=cv2.INTER_LINEAR)
                up = up[:nh, :nw]
                full = cv2.resize(up, (orig_w, orig_h),
                                  interpolation=cv2.INTER_LINEAR)
                cands.append(full > 0.0)
            cands = np.stack(cands)
            b = pick_candidate(cands, iou[i], p.reject_box,
                               self.max_box_area_factor)
            out_masks.append(cands[b])
            out_scores.append(float(iou[i, b]))
        return out_masks, out_scores


class SamLegacyBackend(MaskBackend):
    """SAM1 through an injected ``segment_anything.SamPredictor`` (reference
    backends.py:347 lazily wraps the same predictor).

    The image is encoded ONCE per frame (``SamPredictor.set_image``) and each
    prompt decodes against the cached embedding — the package's intended
    batch-of-prompts usage. ``multimask_output`` stays on and
    :func:`pick_candidate` chooses among the candidates, identical to the HF
    path. The port loads no ``segment_anything``: :meth:`from_checkpoint`
    raises after the JAX package's path check.
    """

    def __init__(self, predictor, clahe: bool = True,
                 max_box_area_factor: float = 1.5, pred_iou_min: float = 0.88):
        self.predictor = predictor
        self.clahe = bool(clahe)
        self.max_box_area_factor = float(max_box_area_factor)
        self.pred_iou_min = float(pred_iou_min)

    @staticmethod
    def _infer_model_type(checkpoint_path) -> str:
        """vit_b / vit_l / vit_h from the official checkpoint filename."""
        name = Path(str(checkpoint_path)).name.lower()
        for mt in ("vit_b", "vit_l", "vit_h"):
            if mt in name:
                return mt
        return "vit_h"

    @classmethod
    def from_checkpoint(cls, checkpoint_path, model_type: Optional[str] = None,
                        device: str = "cuda", **kwargs) -> "SamLegacyBackend":
        if not Path(str(checkpoint_path)).is_file():
            # A transformers model id (the `sam` backend's default) is not a
            # checkpoint this package can load — fail with usage guidance
            # instead of a torch file-not-found deep in sam_model_registry.
            raise ValueError(
                f"mask_backend='sam_legacy' needs a LOCAL `segment-anything` "
                f"checkpoint path (e.g. sam_vit_h_4b8939.pth), got "
                f"{checkpoint_path!r}. Pass --sam-model-id /path/to/sam_*.pth, "
                "or use mask_backend='sam' for hub model ids."
            )
        raise ImportError(
            "mask_backend='sam_legacy' needs the `segment-anything` "
            "package (pip install segment-anything) plus a downloaded "
            "SAM checkpoint; or use mask_backend='sam' (the transformers "
            "port of the same weights). The PyTorch port loads no "
            "`segment-anything`: use mask_backend='sam_jax' with a local "
            "Hugging Face snapshot of the same model.")

    def masks(self, image, prompts):
        rgb = to_3ch(image, clahe=self.clahe)
        self.predictor.set_image(rgb)
        out_masks: List[np.ndarray] = []
        out_scores: List[float] = []
        for p in prompts:
            kw = {"multimask_output": True}
            if p.point_coords is not None:
                kw["point_coords"] = np.asarray(p.point_coords, np.float32)
                kw["point_labels"] = np.asarray(p.point_labels, np.int32)
            if p.box is not None:
                kw["box"] = np.asarray(p.box, np.float32)[None]
            cands, scores, _ = self.predictor.predict(**kw)
            cands = np.asarray(cands, bool)
            scores = np.asarray(scores, np.float32).reshape(-1)
            b = pick_candidate(cands, scores, p.reject_box,
                               self.max_box_area_factor)
            out_masks.append(cands[b])
            out_scores.append(float(scores[b]))
        return out_masks, out_scores


def cleanup_seed(prompt: SamPrompt) -> np.ndarray:
    """Seed keypoints for :func:`cleanup_speckle` on one SAM3 prompt.

    Positive points (pose keypoints / centroid / crop center) are the natural
    component seeds; a box-only prompt has none, so its box center is used so
    the cleanup still keeps the central blob (reference backends.py:473
    ``_cleanup_seed``).
    """
    if prompt.point_coords is not None and len(prompt.point_coords):
        return np.asarray(prompt.point_coords, dtype=np.float32).reshape(-1, 2)
    box = np.asarray(prompt.reject_box, dtype=np.float32).reshape(4)
    return np.array(
        [[(box[0] + box[2]) / 2.0, (box[1] + box[3]) / 2.0]], dtype=np.float32
    )


class Sam3Backend(MaskBackend):
    """SAM3 (Meta SAM 3) prompted-mask backend (reference backends.py:495).

    Wraps an injected transformers ``Sam3TrackerModel`` +
    ``Sam3TrackerProcessor`` pair; :meth:`from_pretrained` raises the JAX
    package's actionable ImportError (the port loads no ``transformers``).
    Two SAM3 specifics are mandatory and never shared with SAM1:

    * **Recalibrated floor** — SAM3's predicted-IoU is on a lower scale than
      SAM1 (median ~0.68 vs ~0.95), so ``pred_iou_min`` defaults to ``0.5``,
      never SAM1's ``0.88``. As with SAM1 the raw chosen-candidate score is
      reported, not gated on.
    * **Speckle cleanup** — raw SAM3 masks are fragmented (median ~14
      components); every chosen mask passes :func:`cleanup_speckle` seeded by
      :func:`cleanup_seed` before it is returned.

    Unlike SAM1's per-prompt decode loop, SAM3 runs all prompts for the frame
    in a single batched forward pass (each prompt one object). Candidate
    selection (:func:`pick_candidate`) and the raw-score contract match SAM1.
    """

    pred_iou_min: float = 0.5

    def __init__(self, model, processor, device: str = "cuda",
                 clahe: bool = True, max_box_area_factor: float = 1.5,
                 clahe_clip_limit: float = 3.0,
                 clahe_tile_grid: Tuple[int, int] = (8, 8),
                 cleanup_radius: int = 3, pred_iou_min: float = 0.5):
        self.model = model
        self.processor = processor
        self.device = str(device)
        self.clahe = bool(clahe)
        self.max_box_area_factor = float(max_box_area_factor)
        self.clahe_clip_limit = float(clahe_clip_limit)
        self.clahe_tile_grid = tuple(clahe_tile_grid)
        self.cleanup_radius = int(cleanup_radius)
        self.pred_iou_min = float(pred_iou_min)

    @classmethod
    def from_pretrained(cls, model_id: str = "facebook/sam3",
                        device: str = "cuda", **kwargs) -> "Sam3Backend":
        raise ImportError(
            "mask_backend='sam3' requires a transformers release with "
            "SAM3 (`facebook/sam3`) support, which is not available in "
            "this environment. Use mask_backend='sam' or pass a prebuilt "
            "backend. The PyTorch port loads no `transformers`.")

    def masks(self, image, prompts):
        """Encode once, run all prompts batched, return cleaned masks + scores.

        Mirrors reference ``Sam3Backend.masks`` (backends.py:600-700): one
        batched forward (each prompt an object), only REAL boxes forwarded
        (never ``reject_box`` — a whole-frame box would make SAM3 diverge
        from SAM1 on identical input), :func:`pick_candidate` per prompt,
        then the mandatory :func:`cleanup_speckle`, reporting the raw chosen
        predicted-IoU on SAM3's scale.
        """
        import torch

        prompts = list(prompts)
        img = np.asarray(image)
        if img.ndim == 3:
            img = img[..., 0]
        img = np.ascontiguousarray(img).astype(np.uint8)
        h, w = img.shape[:2]
        out_masks: List[np.ndarray] = [np.zeros((h, w), bool) for _ in prompts]
        out_scores: List[float] = [0.0 for _ in prompts]
        if not prompts:
            return out_masks, out_scores

        rgb = to_3ch(img, clahe=self.clahe,
                     clahe_clip_limit=self.clahe_clip_limit,
                     clahe_tile_grid=self.clahe_tile_grid)

        obj_points: List[List[List[float]]] = []
        obj_labels: List[List[int]] = []
        obj_boxes: List[List[float]] = []
        any_box = False
        for prompt in prompts:
            pc, pl = prompt.point_coords, prompt.point_labels
            if pc is not None and len(pc):
                obj_points.append([[float(x), float(y)] for x, y in pc])
                obj_labels.append(
                    [int(v) for v in pl] if pl is not None else [1] * len(pc)
                )
            else:
                obj_points.append([])
                obj_labels.append([])
            if prompt.box is not None:
                obj_boxes.append(
                    [float(v) for v in np.asarray(prompt.box).reshape(4)]
                )
                any_box = True
            else:
                obj_boxes.append([])

        processor_kwargs = dict(
            images=rgb,
            input_points=[obj_points],
            input_labels=[obj_labels],
            return_tensors="pt",
        )
        if any_box:  # a frame of point-only prompts forwards no boxes at all
            processor_kwargs["input_boxes"] = [obj_boxes]
        inputs = self.processor(**processor_kwargs).to(self.device)
        with torch.no_grad():
            out = self.model(**inputs, multimask_output=True)
        post = self.processor.post_process_masks(
            out.pred_masks, original_sizes=inputs["original_sizes"],
            binarize=True,
        )[0]  # (n_obj, n_cand, H, W) bool
        post = np.asarray(post.cpu().numpy()).astype(bool)
        scores = np.asarray(out.iou_scores.float().cpu().numpy()[0])

        for j, prompt in enumerate(prompts):
            cand_masks, cand_scores = post[j], scores[j]
            b = pick_candidate(cand_masks, cand_scores, prompt.reject_box,
                               self.max_box_area_factor)
            mask = cleanup_speckle(cand_masks[b], cleanup_seed(prompt),
                                   self.cleanup_radius)
            out_masks[j] = mask.astype(bool)
            out_scores[j] = float(cand_scores[b])
        for m in out_masks:
            if m.shape[:2] != (h, w):
                raise ValueError(
                    f"SAM3 returned a {m.shape} mask for a {(h, w)} image."
                )
        return out_masks, out_scores
