"""A training step of a bottom-up pose model in plain PyTorch, float32, and the judge
of a program's first steps against it.

One step on a batch of uint8 frames (B, H, W, 1) and their instances
(B, I, N, 2) (NaN where a node or an instance is missing):

1. ``x = frames / 255``;
2. geometric augmentation: per frame an angle, a scale and a shift drawn
   from the run's generator in the order the package draws them (angle,
   scale, x shift, y shift, the bundled switch, then one switch for each
   transform with a probability of its own), the forward matrix
   ``T(c + t) S R T(-c)`` about the centre ``c = ((W - 1) / 2, (H - 1) /
   2)``; the frame is resampled bilinearly at the inverse map (a tap
   outside the frame counts 0; the source coordinates taken to [-1, 1] and
   back in float32, as the package hands them to its sampler) and the
   points are mapped forward;
3. targets: the confidence maps (per node the max over instances of
   ``exp(-d^2 / (2 (sigma s)^2))`` on the grid ``0, s, 2s, ..`` of input
   pixels) and the part affinity fields (per edge the unit vector times
   ``exp(-q^2 / (2 (sigma s)^2))``, ``q`` the squared distance to the
   segment, summed over the instances that have a node strictly inside the
   last grid cell);
4. the UNet forward (``reference/unet.py``), the loss (per head the mean
   of the squared error over the rows the batch mask keeps, summed over
   the heads), its gradient by autograd;
5. Adam (betas 0.9 and 0.999, eps 1e-8): ``p -= lr * m_hat / (sqrt(v_hat) + eps)``.

The judge compares, for the first steps the program took: each step's
loss (``loss_gap``, relative; ``loss_gap_first``, the first step's
alone), the norm of each leaf's first gradient (the program's worked out
from its Adam state after one step, ``grad_gap``; ``grad_gap_median``,
the median leaf's), and the norm of each leaf's change over the steps
(``change_gap``; ``change_gap_median``, the median leaf's), as the gap
between the program's norm and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf; the worst leaf's
unless named the median's. Leaves whose
reference gradient is below a thousandth of the median leaf's move by
round-off alone and are left out of the change.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import unet

CM_HEAD = "MultiInstanceConfmapsHead"
PAF_HEAD = "PartAffinityFieldsHead"


def draw_affine(gen: torch.Generator, b: int, h: int, w: int, geo: Dict) -> torch.Tensor:
    """(B, 3, 3) forward matrices drawn from ``gen`` (see the module doc)."""
    if any(geo.get(k, 0.0) for k in ("flip_p", "erase_p", "mixup_p")):
        raise NotImplementedError("the reference draws the affine transform alone")

    def u(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand((b,), generator=gen, device=gen.device)

    angle = u(geo["rotation_min"], geo["rotation_max"]) * (math.pi / 180.0)
    scale = u(geo["scale_min"], geo["scale_max"])
    tx = u(-geo["translate_width"], geo["translate_width"]) * w
    ty = u(-geo["translate_height"], geo["translate_height"]) * h
    bundled = u() < geo["affine_p"]

    def on(p):
        return u() < p if p is not None else bundled

    rot_on, scale_on, trans_on = on(geo["rotation_p"]), on(geo["scale_p"]), on(geo["translate_p"])
    angle = torch.where(rot_on, angle, 0.0)
    scale = torch.where(scale_on, scale, 1.0)
    tx, ty = torch.where(trans_on, tx, 0.0), torch.where(trans_on, ty, 0.0)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    cos, sin = torch.cos(angle), torch.sin(angle)
    m = torch.zeros((b, 3, 3), device=gen.device)
    m[:, 0, 0], m[:, 0, 1] = scale * cos, -scale * sin
    m[:, 1, 0], m[:, 1, 1] = scale * sin, scale * cos
    m[:, 0, 2] = cx + tx - (m[:, 0, 0] * cx + m[:, 0, 1] * cy)
    m[:, 1, 2] = cy + ty - (m[:, 1, 0] * cx + m[:, 1, 1] * cy)
    m[:, 2, 2] = 1.0
    return m


def warp(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Bilinear resampling of (B, H, W, C) at the inverse of ``m``; taps
    outside the frame count 0."""
    b, h, w, c = x.shape
    inv = torch.linalg.inv(m.float())
    yy, xx = torch.meshgrid(torch.arange(h, device=x.device, dtype=torch.float32),
                            torch.arange(w, device=x.device, dtype=torch.float32), indexing="ij")
    sx = inv[:, 0, 0, None, None] * xx + inv[:, 0, 1, None, None] * yy + inv[:, 0, 2, None, None]
    sy = inv[:, 1, 0, None, None] * xx + inv[:, 1, 1, None, None] * yy + inv[:, 1, 2, None, None]
    # To [-1, 1] and back, in float32, as the package's warp hands the
    # coordinates to its sampler.
    sx = ((sx * (2.0 / max(w - 1, 1)) - 1.0) + 1) / 2 * (w - 1)
    sy = ((sy * (2.0 / max(h - 1, 1)) - 1.0) + 1) / 2 * (h - 1)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    rows = torch.arange(b, device=x.device)[:, None, None]
    out = torch.zeros_like(x)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi, yi = (x0 + dx).long(), (y0 + dy).long()
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            v = x[rows, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
            out = out + torch.where(inside[..., None], v, 0.0) * (wx * wy)[..., None]
    return out


def map_points(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    shape = p.shape
    q = p.reshape(shape[0], -1, 2)
    out = torch.stack([m[:, i, 0, None] * q[..., 0] + m[:, i, 1, None] * q[..., 1]
                       + m[:, i, 2, None] for i in range(2)], dim=-1)
    return out.reshape(shape)


def grid(n: int, stride: int, device) -> torch.Tensor:
    return torch.arange(0, n, stride, dtype=torch.float32, device=device)


def confmaps(points: torch.Tensor, hw, sigma: float, stride: int) -> torch.Tensor:
    """(B, I, N, 2) -> (B, H/s, W/s, N): per node the max over instances."""
    xv, yv = grid(hw[1], stride, points.device), grid(hw[0], stride, points.device)
    s = sigma * stride
    px = points[..., 0][:, :, None, None, :]  # (B, I, 1, 1, N)
    py = points[..., 1][:, :, None, None, :]
    d2 = (xv[None, None, None, :, None] - px) ** 2 + (yv[None, None, :, None, None] - py) ** 2
    g = torch.exp(-d2 / torch.tensor(2 * s * s, dtype=torch.float32, device=points.device))
    return torch.nan_to_num(g).amax(dim=1)


def pafs(points: torch.Tensor, hw, edges: Sequence, sigma: float, stride: int) -> torch.Tensor:
    """(B, I, N, 2) -> (B, H/s, W/s, 2E), channels ``[e0x, e0y, e1x, ...]``."""
    dev = points.device
    xv, yv = grid(hw[1], stride, dev), grid(hw[0], stride, dev)
    limit = torch.stack([xv[-1], yv[-1]])
    keep = ((points > 0) & (points < limit)).all(dim=-1).any(dim=-1)  # (B, I)
    pts = torch.where(keep[..., None, None], points, float("nan"))
    e = torch.as_tensor(edges, device=dev).long()
    src, dst = pts[:, :, e[:, 0]], pts[:, :, e[:, 1]]  # (B, I, E, 2)
    d = dst - src
    length2 = (d ** 2).sum(-1).clamp(min=1.0)
    unit = d / torch.sqrt((d ** 2).sum(-1, keepdim=True))
    gx = torch.stack(torch.meshgrid(yv, xv, indexing="ij")[::-1], dim=-1)  # (h, w, 2) as (x, y)
    rel = gx[None, None, :, :, None, :] - src[:, :, None, None]  # (B, I, h, w, E, 2)
    t = ((rel * d[:, :, None, None]).sum(-1) / length2[:, :, None, None]).clamp(0.0, 1.0)
    q = ((t[..., None] * d[:, :, None, None] - rel) ** 2).sum(-1)
    s = sigma * stride
    tube = torch.exp(-(q ** 2) / torch.tensor(2 * s * s, dtype=torch.float32, device=dev))
    f = torch.nan_to_num(tube[..., None] * unit[:, :, None, None]).sum(dim=1)  # (B, h, w, E, 2)
    return f.flatten(-2)


def targets(cfg: Dict, x: torch.Tensor, points: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{head: target} of an augmented batch."""
    h, w = x.shape[1:3]
    cm, pf = cfg["bottomup"]["confmaps"], cfg["bottomup"]["pafs"]
    return {CM_HEAD: confmaps(points, (h, w), cm["sigma"], cm["output_stride"]),
            PAF_HEAD: pafs(points, (h, w), cfg["edges"], pf["sigma"], pf["output_stride"])}


def head_strides(cfg: Dict) -> Dict[str, int]:
    return {CM_HEAD: cfg["bottomup"]["confmaps"]["output_stride"],
            PAF_HEAD: cfg["bottomup"]["pafs"]["output_stride"]}


def loss_of(preds: Dict, tgts: Dict, mask: torch.Tensor) -> torch.Tensor:
    total = 0.0
    for head, y in tgts.items():
        se = (preds[head] - y) ** 2
        wgt = mask.reshape((-1,) + (1,) * (se.ndim - 1))
        total = total + (se * wgt).sum() / (wgt.sum() * (se.numel() / se.shape[0])).clamp(min=1.0)
    return total


def steps(cfg: Dict, weights: Dict[str, torch.Tensor], batches: List[Dict], seed: int,
          geo: Dict, lr: float, conv: unet.Conv = unet.plain_conv):
    """Follow ``batches`` (each ``{"frames", "points", "mask"}``
    on the device) from ``weights``: ``(losses, first gradient, weights after)``."""
    dev = batches[0]["frames"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    st = unet.structure(p)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    strides = head_strides(cfg)
    for t, batch in enumerate(batches, start=1):
        x = batch["frames"].float() / 255.0
        b, h, w, _ = x.shape
        mat = draw_affine(gen, b, h, w, geo)
        with torch.no_grad():
            xa, pts = warp(x, mat), map_points(batch["points"].float(), mat)
            tgts = targets(cfg, xa, pts)
        loss = loss_of(unet.forward(p, xa, strides, conv, st), tgts, batch["mask"].float())
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        g = dict(zip(p.keys(), grads))
        if first is None:
            first = {k: gi.detach().clone() for k, gi in g.items()}
        with torch.no_grad():
            for k in p:
                m[k].mul_(0.9).add_(g[k], alpha=0.1)
                v2[k].mul_(0.999).addcmul_(g[k], g[k], value=0.001)
                m_hat, v_hat = m[k] / (1 - 0.9 ** t), v2[k] / (1 - 0.999 ** t)
                p[k] -= lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
    return losses, first, {k: v.detach() for k, v in p.items()}


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep=None) -> Dict[str, float]:
    """Per leaf ``| |got_k| - |want_k| | / max(|want_k|, median_k |want_k|)``."""
    names = [k for k in want if keep is None or k in keep]
    ref = torch.stack([want[k].double().norm() for k in names])
    med = ref.median()
    return {k: float((got[k].double().norm() - r).abs() / torch.maximum(r, med))
            for k, r in zip(names, ref)}


def judge(prog: Dict, ref_losses, ref_first, ref_after, weights):
    """The numbers of the module doc from the program's ``losses``, ``first``
    gradient and weights ``after`` its steps, against the reference's; and
    notes on them: the leaf whose change reads worst, with its first
    gradient's norm over the median leaf's."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref_losses))
    norms = {k: g.double().norm() for k, g in ref_first.items()}
    med = torch.stack(list(norms.values())).median()
    moving = {k for k, n in norms.items() if n >= 1e-3 * med}
    d_prog = {k: prog["after"][k] - weights[k] for k in weights}
    d_ref = {k: ref_after[k] - weights[k] for k in weights}
    grads = leaf_gaps(prog["first"], ref_first)
    changes = leaf_gaps(d_prog, d_ref, moving)
    worst, worst_g = max(changes, key=changes.get), max(grads, key=grads.get)
    first = abs(prog["losses"][0] - ref_losses[0]) / abs(ref_losses[0])
    numbers = {"loss_gap": loss_gap, "loss_gap_first": first, "grad_gap": grads[worst_g],
               "grad_gap_median": float(np.median(list(grads.values()))),
               "change_gap": changes[worst],
               "change_gap_median": float(np.median(list(changes.values()))),
               "steps_followed": len(ref_losses), "leaves_moving": len(moving)}
    return numbers, {"change_worst_leaf": worst, "its_grad_over_median": float(norms[worst] / med),
                     "grad_worst_leaf": worst_g,
                     "its_norm_over_median": float(norms[worst_g] / med)}
