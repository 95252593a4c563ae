"""Training visualization: confmap, peak, PAF and class-map overlays as PNGs.

Port of ``sleap_nn_tpu/training/viz.py``: each epoch (or every N), the
first validation sample's image, predicted confidence maps and peaks go
into ``<model_dir>/viz/epoch_NNNN.png`` (plus a PAF panel for bottom-up
models and a class-map panel for multi-class bottom-up). The sample's
render, forward and peak finding run on the trainer's device (the local
peaks through kernel 2 on a card); matplotlib (the ``Agg`` backend) is
imported where a PNG is drawn.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from sleap_nn_tpu_torch.ops.peaks import find_global_peaks, find_local_peaks
from sleap_nn_tpu_torch.training.callbacks import Callback


def render_prediction_png(
    image: np.ndarray,
    confmaps: Optional[np.ndarray] = None,
    peaks: Optional[np.ndarray] = None,
    gt_points: Optional[np.ndarray] = None,
    output_path=None,
    confmap_stride: int = 1,
    title: str = "",
):
    """Render image + confmap overlay + GT/pred points to a PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = np.asarray(image)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    fig, ax = plt.subplots(figsize=(6, 6), dpi=100)
    ax.imshow(img, cmap="gray")
    if confmaps is not None:
        cm = np.asarray(confmaps)
        overlay = cm.max(axis=-1)
        ax.imshow(
            overlay,
            cmap="jet",
            alpha=0.5 * np.clip(overlay, 0, 1),
            extent=(0, overlay.shape[1] * confmap_stride, overlay.shape[0] * confmap_stride, 0),
        )
    if gt_points is not None:
        pts = np.asarray(gt_points).reshape(-1, 2)
        ax.plot(pts[:, 0], pts[:, 1], "g+", markersize=10, label="GT")
    if peaks is not None:
        pts = np.asarray(peaks).reshape(-1, 2)
        ax.plot(pts[:, 0], pts[:, 1], "rx", markersize=8, label="pred")
    if title:
        ax.set_title(title)
    ax.set_xlim(0, img.shape[1])
    ax.set_ylim(img.shape[0], 0)
    ax.axis("off")
    if output_path is not None:
        fig.savefig(output_path, bbox_inches="tight")
        plt.close(fig)
        return output_path
    return fig


def render_paf_png(
    image: np.ndarray,
    pafs: np.ndarray,
    output_path=None,
    paf_stride: int = 1,
    quiver_step: int = 8,
    title: str = "",
):
    """Render image + PAF magnitude heatmap + direction quiver to a PNG.

    ``pafs`` is ``(H, W, 2*E)`` channels-last with per-edge (x, y) pairs; a 4D
    ``(H, W, E, 2)`` layout is accepted too.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = np.asarray(image)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    p = np.asarray(pafs)
    if p.ndim == 3:
        h, w, c = p.shape
        if c % 2:
            raise ValueError(f"PAF channel count must be even, got {c}.")
        p = p.reshape(h, w, c // 2, 2)
    elif p.ndim != 4:
        raise ValueError(f"pafs must be 3D or 4D, got shape {p.shape}.")
    # Magnitude: max over edges of the per-edge vector norm.
    mag = np.sqrt((p**2).sum(axis=-1)).max(axis=-1)
    fig, ax = plt.subplots(figsize=(6, 6), dpi=100)
    ax.imshow(img, cmap="gray")
    ax.imshow(
        mag,
        cmap="jet",
        alpha=0.5 * np.clip(mag, 0, 1),
        extent=(0, mag.shape[1] * paf_stride, mag.shape[0] * paf_stride, 0),
    )
    # Direction quiver on a sparse grid, strongest edge per cell.
    gy, gx = np.mgrid[0:p.shape[0]:quiver_step, 0:p.shape[1]:quiver_step]
    sub = p[::quiver_step, ::quiver_step]  # (gy, gx, E, 2)
    norms = np.sqrt((sub**2).sum(axis=-1))
    best = norms.argmax(axis=-1)
    take = np.take_along_axis(sub, best[..., None, None], axis=2)[:, :, 0, :]
    keep = norms.max(axis=-1) > 0.1
    ax.quiver(
        gx[keep] * paf_stride, gy[keep] * paf_stride,
        take[..., 0][keep], -take[..., 1][keep],
        color="white", scale=30, width=0.003,
    )
    if title:
        ax.set_title(title)
    ax.set_xlim(0, img.shape[1])
    ax.set_ylim(img.shape[0], 0)
    ax.axis("off")
    if output_path is not None:
        fig.savefig(output_path, bbox_inches="tight")
        plt.close(fig)
        return output_path
    return fig


def render_class_maps_png(
    image: np.ndarray,
    class_maps: np.ndarray,
    output_path=None,
    stride: int = 1,
    title: str = "",
):
    """Render image + per-class occupancy overlay (multiclass bottom-up viz).

    ``class_maps`` is ``(H, W, n_classes)``; each pixel is tinted by its
    argmax class where any class activation exceeds 0.5.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = np.asarray(image)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    cm = np.asarray(class_maps)
    if cm.ndim != 3:
        raise ValueError(f"class_maps must be (H, W, C), got {cm.shape}.")
    strength = cm.max(axis=-1)
    labels_map = cm.argmax(axis=-1).astype(float)
    labels_map[strength < 0.5] = np.nan
    fig, ax = plt.subplots(figsize=(6, 6), dpi=100)
    ax.imshow(img, cmap="gray")
    ax.imshow(
        labels_map,
        cmap="tab10",
        alpha=0.6,
        interpolation="nearest",
        vmin=0,
        vmax=max(cm.shape[-1] - 1, 1),
        extent=(0, cm.shape[1] * stride, cm.shape[0] * stride, 0),
    )
    if title:
        ax.set_title(title)
    ax.set_xlim(0, img.shape[1])
    ax.set_ylim(img.shape[0], 0)
    ax.axis("off")
    if output_path is not None:
        fig.savefig(output_path, bbox_inches="tight")
        plt.close(fig)
        return output_path
    return fig


class VizCallback(Callback):
    """Render a validation sample's predictions every ``every_n_epochs``
    epochs. A failure is printed, never raised: viz must not stop training."""

    def __init__(
        self,
        trainer,
        viz_dir,
        every_n_epochs: int = 1,
        img_format: str = "png",
    ):
        self.trainer = trainer
        self.viz_dir = Path(viz_dir)
        self.viz_dir.mkdir(parents=True, exist_ok=True)
        self.every_n_epochs = max(every_n_epochs, 1)
        self.img_format = img_format

    def on_epoch_end(self, trainer, epoch: int, logs: Dict):
        if epoch % self.every_n_epochs:
            return
        try:
            self._render(trainer, epoch)
        except Exception as e:  # viz must never break training
            print(f"viz render failed at epoch {epoch}: {e}")

    @staticmethod
    def sample(trainer, epoch: int):
        """The first val sample rendered and run through the model, in eval
        mode without gradients: ``(processed, preds)``, cached on the
        trainer for the epoch so that the wandb overlays reuse it."""
        cache = getattr(trainer, "_viz_cache", None)
        if cache is not None and cache[0] == epoch:
            return cache[1], cache[2]
        was_training = trainer.model.training
        trainer.model.eval()
        try:
            with torch.no_grad():
                processed = trainer.render(trainer.val_ds.make_batch([0]), train=False)
                preds = trainer.model(processed["image"])
        finally:
            trainer.model.train(was_training)
        trainer._viz_cache = (epoch, processed, preds)
        return processed, preds

    @classmethod
    def peaks(cls, trainer, epoch: int):
        """The device half of a render: the epoch's sample, its confmaps
        and their peaks (global peaks with integral refinement for the
        single-instance and centered-instance models, else at most 20 local
        peaks), as ``(processed, preds, confmaps, peaks, stride)``, the
        confmaps and peaks as numpy (None without a confmap head)."""
        processed, preds = cls.sample(trainer, epoch)
        cm_head = next((h for h in trainer.model.heads if "Confmaps" in h.name), None)
        if cm_head is None:
            return processed, preds, None, None, 1
        cms = preds[cm_head.name]
        stride = cm_head.output_stride
        with torch.no_grad():
            if trainer.model_type in ("single_instance", "centered_instance"):
                pts, _ = find_global_peaks(cms, threshold=0.1, refinement="integral")
                peaks = pts[0].cpu().numpy() * stride
            else:
                pts, _, _, valid = find_local_peaks(cms, threshold=0.1, max_peaks=20)
                peaks = pts[0].cpu().numpy()[valid[0].cpu().numpy()] * stride
        return processed, preds, cms[0].float().cpu().numpy(), peaks, stride

    def _render(self, trainer, epoch: int):
        processed, preds, confmaps, peaks, stride = self.peaks(trainer, epoch)
        heads = trainer.model.heads
        image = processed["image"][0].float().cpu().numpy()
        gt = processed["instances"][0].cpu().numpy()
        render_prediction_png(
            image,
            confmaps=confmaps,
            peaks=peaks,
            gt_points=gt,
            output_path=self.viz_dir / f"epoch_{epoch:04d}.{self.img_format}",
            confmap_stride=stride,
            title=f"epoch {epoch}",
        )
        paf_head = next((h for h in heads if "PartAffinity" in h.name), None)
        if paf_head is not None:
            render_paf_png(
                image,
                preds[paf_head.name][0].float().cpu().numpy(),
                output_path=self.viz_dir / f"epoch_{epoch:04d}_pafs.{self.img_format}",
                paf_stride=paf_head.output_stride,
                title=f"epoch {epoch} pafs",
            )
        cmap_head = next((h for h in heads if "ClassMaps" in h.name), None)
        if cmap_head is not None:
            render_class_maps_png(
                image,
                preds[cmap_head.name][0].float().cpu().numpy(),
                output_path=self.viz_dir / f"epoch_{epoch:04d}_classmaps.{self.img_format}",
                stride=cmap_head.output_stride,
                title=f"epoch {epoch} class maps",
            )
