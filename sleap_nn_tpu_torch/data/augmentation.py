"""Device-side augmentation of image batches and their keypoints.

Port of ``sleap_nn_tpu/data/augmentation.py``: flip (with the symmetric
node swap), affine (rotation / scale / translation, with independent or
bundled probabilities), random erase, mixup and intensity (uniform and
gaussian noise, contrast, brightness).

Each operation comes in two halves:

- *sample* (``sample_*``): draws the random values for a batch with an
  explicit ``torch.Generator`` (on the batch's device);
- *apply* (``apply_*``): transforms the batch given those values
  (matrices, flags, boxes, factors, noise).

The JAX package draws from ``jax.random`` keys, so the two packages draw
different numbers by design; the apply halves compute the JAX package's
functions of the drawn values. Conventions: image ``(B, H, W, C)`` f32 in
[0, 1]; instances ``(B, ..., 2)`` ``(x, y)`` pixels; NaN stays NaN.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def _uniform(generator: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


# ---------------------------------------------------------------------------
# Affine
# ---------------------------------------------------------------------------


def sample_affine(
    generator: torch.Generator,
    batch: int,
    height: int,
    width: int,
    rotation_min: float = -15.0,
    rotation_max: float = 15.0,
    rotation_p: Optional[float] = None,
    scale_min: float = 0.9,
    scale_max: float = 1.1,
    scale_p: Optional[float] = None,
    translate_width: float = 0.0,
    translate_height: float = 0.0,
    translate_p: Optional[float] = None,
    affine_p: float = 0.0,
) -> Dict[str, torch.Tensor]:
    """Per-sample affine parameters, ``(B,)`` each, already gated.

    ``angle`` (radians) uniform in the rotation range, ``scale`` uniform in
    the scale range, ``tx`` / ``ty`` uniform in +-translate fraction of the
    image width / height. Each is on with its own probability, or with one
    bundled ``affine_p`` draw when its own is None; off means angle 0,
    scale 1, shift 0.
    """
    angle = _uniform(generator, (batch,), rotation_min, rotation_max) * (math.pi / 180.0)
    scale = _uniform(generator, (batch,), scale_min, scale_max)
    tx = _uniform(generator, (batch,), -translate_width, translate_width) * width
    ty = _uniform(generator, (batch,), -translate_height, translate_height) * height
    bundled = _uniform(generator, (batch,)) < affine_p

    def on(p):
        return _uniform(generator, (batch,)) < p if p is not None else bundled

    rot_on, scale_on, trans_on = on(rotation_p), on(scale_p), on(translate_p)
    return {
        "angle": torch.where(rot_on, angle, 0.0),
        "scale": torch.where(scale_on, scale, 1.0),
        "tx": torch.where(trans_on, tx, 0.0),
        "ty": torch.where(trans_on, ty, 0.0),
    }


def affine_matrices(angle: torch.Tensor, scale: torch.Tensor, tx: torch.Tensor,
                    ty: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``(B, 3, 3)`` forward (keypoint) matrices:
    ``Translate(c + t) @ Scale @ Rot @ Translate(-c)``, c the image centre."""
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    cos, sin = torch.cos(angle), torch.sin(angle)
    a = scale * cos
    b = -scale * sin
    c = scale * sin
    d = scale * cos
    e = cx + tx - (a * cx + b * cy)
    f = cy + ty - (c * cx + d * cy)
    zeros, ones = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([
        torch.stack([a, b, e], dim=-1),
        torch.stack([c, d, f], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=-2)


def transform_points(points: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """Apply per-sample forward affines to ``(B, ..., 2)`` points (NaN stays NaN)."""
    b = points.shape[0]
    flat = points.reshape(b, -1, 2)
    x, y = flat[..., 0], flat[..., 1]
    m = mats[:, :2, :, None]  # (B, 2, 3, 1)
    out = torch.stack([m[:, i, 0] * x + m[:, i, 1] * y + m[:, i, 2] for i in range(2)], dim=-1)
    return out.reshape(points.shape)


def warp_image(image: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """Warp ``(B, H, W, C)`` images by the inverse of the forward affines.

    Bilinear, zeros outside: each of the four taps that falls outside the
    image contributes 0 (``map_coordinates(order=1, cval=0)``), which is
    ``grid_sample`` with ``padding_mode="zeros"`` and ``align_corners=True``
    on coordinates normalised by ``W - 1`` and ``H - 1``.
    """
    b, h, w, _ = image.shape
    inv = torch.linalg.inv(mats.float())[:, :, :, None, None]  # (B, 3, 3, 1, 1)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=image.device),
                            torch.arange(w, dtype=torch.float32, device=image.device),
                            indexing="ij")
    sx = inv[:, 0, 0] * xx + inv[:, 0, 1] * yy + inv[:, 0, 2]  # (B, H, W)
    sy = inv[:, 1, 0] * xx + inv[:, 1, 1] * yy + inv[:, 1, 2]
    grid = torch.stack([sx * (2.0 / max(w - 1, 1)) - 1.0, sy * (2.0 / max(h - 1, 1)) - 1.0],
                       dim=-1)
    out = F.grid_sample(image.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Flip, erase, mixup
# ---------------------------------------------------------------------------


def sample_flip(generator: torch.Generator, batch: int, flip_p: float) -> torch.Tensor:
    """``(B,)`` bool: which samples are mirrored."""
    return _uniform(generator, (batch,)) < flip_p


def apply_flip(image: torch.Tensor, instances: torch.Tensor, do: torch.Tensor,
               symmetric_inds: Optional[Sequence[Tuple[int, int]]] = None):
    """Left/right mirror of the samples where ``do``; symmetric nodes swap."""
    b, _, w, _ = image.shape
    image = torch.where(do[:, None, None, None], image.flip(2), image)
    flipped = torch.stack([(w - 1) - instances[..., 0], instances[..., 1]], dim=-1)
    if symmetric_inds:
        perm = list(range(instances.shape[-2]))
        for i, j in symmetric_inds:
            perm[i], perm[j] = perm[j], perm[i]
        flipped = flipped[..., perm, :]
    do_b = do.reshape((b,) + (1,) * (instances.ndim - 1))
    return image, torch.where(do_b, flipped, instances)


def sample_random_erase(generator: torch.Generator, batch: int, height: int, width: int,
                        scale_min: float, scale_max: float, ratio_min: float,
                        ratio_max: float, erase_p: float) -> Dict[str, torch.Tensor]:
    """``(B,)`` boxes: area a uniform fraction of the image, aspect ``ratio``,
    top-left uniform over the image minus the box; ``on`` with ``erase_p``."""
    area = _uniform(generator, (batch,), scale_min, scale_max) * height * width
    ratio = _uniform(generator, (batch,), ratio_min, ratio_max)
    eh = torch.sqrt(area * ratio)
    ew = torch.sqrt(area / ratio)
    y0 = _uniform(generator, (batch,)) * (height - eh)
    x0 = _uniform(generator, (batch,)) * (width - ew)
    return {"y0": y0, "x0": x0, "eh": eh, "ew": ew,
            "on": _uniform(generator, (batch,)) < erase_p}


def apply_random_erase(image: torch.Tensor, boxes: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Zero the pixels inside each sample's box where ``on``."""
    _, h, w, _ = image.shape
    yy = torch.arange(h, dtype=torch.float32, device=image.device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=image.device)[None, None, :]

    def col(k):
        return boxes[k][:, None, None]

    inside = ((yy >= col("y0")) & (yy < col("y0") + col("eh"))
              & (xx >= col("x0")) & (xx < col("x0") + col("ew")))
    return torch.where((inside & col("on"))[..., None], 0.0, image)


def sample_mixup(generator: torch.Generator, batch: int, lambda_min: float,
                 lambda_max: float, mixup_p: float) -> torch.Tensor:
    """``(B, 1, 1, 1)`` mixing weights, 0 where mixup is off."""
    lam = _uniform(generator, (batch, 1, 1, 1), lambda_min, lambda_max)
    on = (_uniform(generator, (batch, 1, 1, 1)) < mixup_p).float()
    return lam * on


def apply_mixup(image: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Blend each sample with the previous one in the batch (cyclically)."""
    return (1 - lam) * image + lam * torch.roll(image, 1, dims=0)


def apply_geometric_augmentation(
    generator: torch.Generator,
    image: torch.Tensor,
    instances: torch.Tensor,
    rotation_min: float = -15.0,
    rotation_max: float = 15.0,
    rotation_p: Optional[float] = None,
    scale_min: float = 0.9,
    scale_max: float = 1.1,
    scale_p: Optional[float] = None,
    translate_width: float = 0.0,
    translate_height: float = 0.0,
    translate_p: Optional[float] = None,
    affine_p: float = 0.0,
    erase_scale_min: float = 0.0001,
    erase_scale_max: float = 0.01,
    erase_ratio_min: float = 1.0,
    erase_ratio_max: float = 1.0,
    erase_p: float = 0.0,
    mixup_lambda_min: float = 0.01,
    mixup_lambda_max: float = 0.05,
    mixup_p: float = 0.0,
    flip_p: float = 0.0,
    symmetric_inds: Optional[Sequence[Tuple[int, int]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The geometric chain: flip, affine, erase, mixup (each when enabled)."""
    b, h, w, _ = image.shape
    if flip_p > 0:
        image, instances = apply_flip(image, instances, sample_flip(generator, b, flip_p),
                                      symmetric_inds)
    if affine_p > 0 or (rotation_p or 0) > 0 or (scale_p or 0) > 0 or (translate_p or 0) > 0:
        mats = affine_matrices(**sample_affine(
            generator, b, h, w, rotation_min, rotation_max, rotation_p, scale_min, scale_max,
            scale_p, translate_width, translate_height, translate_p, affine_p), height=h, width=w)
        image = warp_image(image, mats)
        instances = transform_points(instances, mats)
    if erase_p > 0:
        image = apply_random_erase(image, sample_random_erase(
            generator, b, h, w, erase_scale_min, erase_scale_max, erase_ratio_min,
            erase_ratio_max, erase_p))
    if mixup_p > 0:
        image = apply_mixup(image, sample_mixup(generator, b, mixup_lambda_min,
                                                mixup_lambda_max, mixup_p))
    return image, instances


# ---------------------------------------------------------------------------
# Intensity
# ---------------------------------------------------------------------------


def sample_intensity(
    generator: torch.Generator,
    shape: Tuple[int, int, int, int],
    uniform_noise_min: float = 0.0,
    uniform_noise_max: float = 0.04,
    uniform_noise_p: float = 0.0,
    gaussian_noise_mean: float = 0.0,
    gaussian_noise_std: float = 0.02,
    gaussian_noise_p: float = 0.0,
    contrast_min: float = 0.9,
    contrast_max: float = 1.1,
    contrast_p: float = 0.0,
    brightness_min: float = 0.9,
    brightness_max: float = 1.1,
    brightness_p: float = 0.0,
) -> Dict[str, torch.Tensor]:
    """The intensity chain's values, only for the operations with p > 0:
    noise of the image's shape and ``(B, 1, 1, 1)`` on-flags and factors."""
    b = shape[0]
    per_sample = (b, 1, 1, 1)
    out: Dict[str, torch.Tensor] = {}
    if uniform_noise_p > 0:
        out["uniform_noise"] = _uniform(generator, shape, uniform_noise_min, uniform_noise_max)
        out["uniform_on"] = (_uniform(generator, per_sample) < uniform_noise_p).float()
    if gaussian_noise_p > 0:
        normal = torch.randn(shape, generator=generator, device=generator.device)
        out["gaussian_noise"] = gaussian_noise_mean + gaussian_noise_std * normal
        out["gaussian_on"] = (_uniform(generator, per_sample) < gaussian_noise_p).float()
    if contrast_p > 0:
        out["contrast_factor"] = _uniform(generator, per_sample, contrast_min, contrast_max)
        out["contrast_on"] = _uniform(generator, per_sample) < contrast_p
    if brightness_p > 0:
        out["brightness_factor"] = _uniform(generator, per_sample, brightness_min, brightness_max)
        out["brightness_on"] = _uniform(generator, per_sample) < brightness_p
    return out


def apply_intensity(image: torch.Tensor, values: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Noise, contrast (about each sample's mean), brightness, then clip to [0, 1]."""
    if "uniform_noise" in values:
        image = image + values["uniform_noise"] * values["uniform_on"]
    if "gaussian_noise" in values:
        image = image + values["gaussian_noise"] * values["gaussian_on"]
    if "contrast_factor" in values:
        mean = image.mean(dim=(1, 2, 3), keepdim=True)
        contrasted = (image - mean) * values["contrast_factor"] + mean
        image = torch.where(values["contrast_on"], contrasted, image)
    if "brightness_factor" in values:
        image = torch.where(values["brightness_on"], image * values["brightness_factor"], image)
    return torch.clamp(image, 0.0, 1.0)


def apply_intensity_augmentation(generator: torch.Generator, image: torch.Tensor,
                                 **cfg) -> torch.Tensor:
    """The intensity chain on a [0, 1] batch (keypoints untouched)."""
    return apply_intensity(image, sample_intensity(generator, tuple(image.shape), **cfg))
