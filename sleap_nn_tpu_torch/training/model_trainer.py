"""Training orchestration.

Port of ``sleap_nn_tpu/training/model_trainer.py`` for single-instance,
centroid, centered-instance, bottom-up and identity (multi-class
bottom-up and top-down) models on one device. A train step renders the
batch's targets on the device under ``torch.no_grad()`` (kernel 4 on
CUDA for the centroid and bottom-up confidence maps), runs
the forward and the loss under autograd, then ``backward`` and one Adam /
AdamW step. PyTorch runs eagerly, so where the JAX trainer jits one
program per step, the port launches the same stages one by one. The
model trains with plain convolutions (``use_fused=False``), as the JAX
trainer does: the fused double-conv kernel has no backward.

The model directory: ``initial_config.yaml`` (the config as the caller
gave it), ``training_config.yaml`` (the config the trainer filled in: max
dims, strides, part names, PAF edges, classes, crop size, skeleton, run
name, parameter count), ``best.ckpt`` (and ``last.ckpt`` with
``model_ckpt.save_last``) and ``training_log.csv`` (one row per epoch).
A checkpoint is ``torch.save({"state_dict", "epoch", "best_val_loss"})``
with the model's ``state_dict`` keys under the ``model.`` prefix of the
reference's Lightning checkpoints. ``inference.loaders.load_model`` reads
the directory back; so does the JAX package's ``load_model``.

What the port does not train yet raises ``NotImplementedError`` (listed in
ROADMAP.md): the segmentation model types, backbones other than UNet,
tiling, the disk cache, pretrained or transfer init, resume, ZMQ, wandb,
visualization, negative frames (a crop model leaves them out with a
warning, as the JAX trainer does), user centroids,
amsgrad, ``save_top_k`` above 1, device-trace profilers, more than one
device, loading labels from paths, and the ``labels_{train,val}_gt_*.slp``
files of the model directory (writing them needs h5py, which the card
machine lacks; ROADMAP.md section 1, item 1).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
import time
import warnings
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from sleap_nn_tpu_torch.config import (
    TrainingJobConfig,
    check_output_strides,
    get_backbone_config,
    get_backbone_type_from_cfg,
    get_head_config,
    get_model_type_from_cfg,
    verify_training_cfg,
)
from sleap_nn_tpu_torch.data.pipeline import (
    CROP_TYPES,
    Loader,
    build_pipeline_context,
    make_dataset,
    make_render_fn,
)
from sleap_nn_tpu_torch.data.providers import get_max_height_width
from sleap_nn_tpu_torch.inference.backends import resolve_device
from sleap_nn_tpu_torch.io.model import Labels
from sleap_nn_tpu_torch.models.model import MODEL_TYPES, Model
from sleap_nn_tpu_torch.training.callbacks import (
    Callback,
    CSVLoggerCallback,
    EarlyStopping,
    EpochEndEvaluationCallback,
    ProgressCallback,
)
from sleap_nn_tpu_torch.training.losses import compute_loss
from sleap_nn_tpu_torch.training.schedulers import make_scheduler

_BATCH_TENSORS = ("image", "instances", "center_idx", "track_ids", "batch_mask",
                  "sample_weight")


def xavier_init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Xavier-uniform conv, transposed-conv and dense weights, zero biases,
    in place.

    The JAX package's rule on its HWIO and (in, out) kernels: ``fan_in = kh
    * kw * in`` (``in`` for a dense layer), ``fan_out = out``, limit
    ``sqrt(6 / (fan_in + fan_out))``. (PyTorch's ``xavier_uniform_`` on
    OIHW weights would count ``out * kh * kw`` as ``fan_out``.)
    ``generator`` lives on the weights' device.
    """
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.ConvTranspose2d):  # (in, out, kh, kw)
                c_in, c_out, kh, kw = m.weight.shape
            elif isinstance(m, nn.Conv2d):  # (out, in, kh, kw)
                c_out, c_in, kh, kw = m.weight.shape
            elif isinstance(m, nn.Linear):  # (out, in)
                (c_out, c_in), kh, kw = m.weight.shape, 1, 1
            else:
                continue
            limit = math.sqrt(6.0 / (kh * kw * c_in + c_out))
            u = torch.rand(m.weight.shape, generator=generator, device=m.weight.device)
            m.weight.copy_(u * (2 * limit) - limit)
            if m.bias is not None:
                m.bias.zero_()
    return model


def make_optimizer(params, name: str, lr: float) -> torch.optim.Optimizer:
    """``optax.adam`` / ``optax.adamw`` at their defaults, in PyTorch: betas
    (0.9, 0.999), eps 1e-8 and, for AdamW, decoupled weight decay 1e-4
    (optax's default; torch's is 1e-2)."""
    if name.lower() == "adam":
        return torch.optim.Adam(params, lr=lr)
    if name.lower() == "adamw":
        return torch.optim.AdamW(params, lr=lr, weight_decay=1e-4)
    raise ValueError(f"Unsupported optimizer: {name}")


def sample_weights(batch: Dict[str, torch.Tensor], train: bool = True) -> Optional[torch.Tensor]:
    """Per-sample loss weights: ``batch_mask`` (padded loader rows), times
    ``sample_weight`` in training only, so that validation losses stay
    comparable across weightings."""
    w = batch.get("batch_mask")
    w = None if w is None else w.float()
    sw = batch.get("sample_weight")
    if train and sw is not None:
        w = sw if w is None else w * sw
    return w


def _unsupported(cfg: TrainingJobConfig, model_type: str, backbone_type: str) -> List[str]:
    """What this configuration asks for that the port does not train yet."""
    tc, dc, mc = cfg.trainer_config, cfg.data_config, cfg.model_config
    cm = getattr(get_head_config(cfg), "confmaps", None)
    devices = tc.trainer_devices
    checks = [
        (model_type not in MODEL_TYPES,
         f"model type {model_type!r} (ported: {', '.join(MODEL_TYPES)})"),
        (backbone_type != "unet", f"backbone {backbone_type!r} (unet is ported)"),
        (dc.preprocessing.tiling is not None and dc.preprocessing.tiling.enabled, "tiling"),
        (str(dc.data_pipeline_fw).endswith("cache_img_disk"), "the disk cache"),
        (bool(mc.pretrained_backbone_weights or mc.pretrained_head_weights),
         "pretrained or transfer init"),
        (mc.init_weights not in ("default", "xavier"), f"init_weights={mc.init_weights!r}"),
        (bool(tc.resume_ckpt_path), "resume_ckpt_path"),
        (tc.zmq is not None and bool(tc.zmq.controller_port or tc.zmq.publish_port), "ZMQ"),
        (bool(tc.use_wandb), "wandb"),
        (bool(tc.visualize_preds_during_training), "visualization during training"),
        (bool(dc.use_negative_frames) and model_type not in CROP_TYPES, "negative frames"),
        (getattr(cm, "centroid_source", None) == "user", "user centroids"),
        (bool(getattr(tc.optimizer, "amsgrad", False)), "amsgrad"),
        (int(tc.model_ckpt.save_top_k or 1) > 1, "save_top_k > 1"),
        (tc.profiler not in (None, "simple", "advanced", "passthrough"),
         f"profiler={tc.profiler!r}"),
        ((isinstance(devices, int) and devices > 1)
         or len(tc.trainer_device_indices or []) > 1, "more than one device"),
    ]
    return [what for bad, what in checks if bad]


class ModelTrainer:
    """Config-driven training of one model on one device.

    ``device``: ``"cuda"`` (the default; raises without a card) or
    ``"cpu"``. ``trainer_config.trainer_accelerator`` is not read.
    """

    def __init__(
        self,
        config: TrainingJobConfig,
        train_labels: Optional[List[Labels]] = None,
        val_labels: Optional[List[Labels]] = None,
        device="cuda",
    ):
        self.config = config
        self.train_labels = train_labels or []
        self.val_labels = val_labels or []
        self.model_type = get_model_type_from_cfg(config)
        self.backbone_type = get_backbone_type_from_cfg(config)
        missing = _unsupported(config, self.model_type, self.backbone_type)
        if missing:
            raise NotImplementedError(
                "not ported to the PyTorch trainer yet (ROADMAP.md section 1, items 7, 10 and "
                "11): " + "; ".join(missing))
        self.device = resolve_device(device)
        self.should_stop = False
        self.current_epoch = 0
        self.ckpt_dir: Optional[Path] = None
        self.callbacks: List[Callback] = []
        self.history: List[Dict] = []
        self.best_val_loss = math.inf
        self.initial_config: Optional[TrainingJobConfig] = None  # set by from_config
        self._setup_done = False

    # -- construction -------------------------------------------------------
    @classmethod
    def get_model_trainer_from_config(
        cls,
        config: TrainingJobConfig,
        train_labels: Optional[List[Labels]] = None,
        val_labels: Optional[List[Labels]] = None,
        device="cuda",
    ) -> "ModelTrainer":
        """Validate the config, split the labels, infer the derived config.

        Labels come in memory: reading ``data_config.train_labels_path`` /
        ``val_labels_path`` waits for the ``.slp`` I/O slice. Without
        ``val_labels`` the training labels are split with
        ``Labels.make_training_splits`` at ``validation_fraction`` and the
        trainer seed, as the JAX trainer splits them.
        """
        verify_training_cfg(config)
        initial = copy.deepcopy(config)
        if train_labels is None:
            raise NotImplementedError(
                "loading labels from data_config.train_labels_path waits for the .slp I/O "
                "slice (ROADMAP.md section 1, item 1): pass in-memory Labels")
        if val_labels is None:
            if config.data_config.use_same_data_for_val:
                val_labels = list(train_labels)
            elif config.data_config.val_labels_path:
                raise NotImplementedError(
                    "loading data_config.val_labels_path waits for the .slp I/O slice: "
                    "pass in-memory val_labels")
            else:
                frac = config.data_config.validation_fraction
                keep_cent = get_model_type_from_cfg(config) == "centroid"
                split = [
                    labels.make_training_splits(
                        1.0 - frac, frac, seed=config.trainer_config.seed,
                        include_centroid_only_frames=keep_cent,
                    )
                    for labels in train_labels
                ]
                train_labels = [s[0] for s in split]
                val_labels = [s[1] for s in split]
        if get_model_type_from_cfg(config) == "single_instance":
            # A single-instance target would blend the instances of a
            # multi-animal frame, so such labels are refused.
            for split_name, split in (("train", train_labels), ("val", val_labels)):
                for labels in split:
                    for lf in labels.labeled_frames:
                        if len(lf.user_instances) > 1:
                            raise ValueError(
                                "single_instance training requires at most one instance per "
                                f"frame; found {len(lf.user_instances)} user instances on "
                                f"{split_name} frame {lf.frame_idx}. Use a topdown or bottomup "
                                "pipeline for multi-animal data.")
        trainer = cls(config, train_labels, val_labels, device=device)
        trainer.initial_config = initial
        trainer._infer_config()
        return trainer

    def _infer_config(self):
        """Fill the derived config: preprocessing max dims, strides, head
        part names, PAF edges and classes (the track names), the pipeline
        context, the crop size and the skeleton record."""
        labels = self.train_labels[0]
        skel = labels.skeleton
        head = get_head_config(self.config)
        pre = self.config.data_config.preprocessing
        if pre.max_height is None or pre.max_width is None:
            h, w = get_max_height_width(labels)
            pre.max_height = pre.max_height or h
            pre.max_width = pre.max_width or w
        check_output_strides(self.config)
        cm = getattr(head, "confmaps", None)
        if cm is not None and hasattr(cm, "part_names") and cm.part_names is None:
            cm.part_names = list(skel.node_names)
        pafs = getattr(head, "pafs", None)
        if pafs is not None and pafs.edges is None:
            pafs.edges = [list(e) for e in skel.edge_names]
        for leaf_name in ("class_maps", "class_vectors"):
            leaf = getattr(head, leaf_name, None)
            if leaf is not None and leaf.classes is None:
                leaf.classes = [t.name for t in labels.tracks]
        merged = Labels(
            labeled_frames=[lf for L in self.train_labels for lf in L.labeled_frames],
            videos=[v for L in self.train_labels for v in L.videos],
            skeletons=[s for L in self.train_labels for s in L.skeletons],
        )
        self.ctx = build_pipeline_context(self.config, merged, self.model_type)
        if self.ctx.crop_size is not None:
            pre.crop_size = self.ctx.crop_size
        self.config.data_config.skeletons = [
            {
                "nodes": [{"name": n} for n in skel.node_names],
                "edges": [
                    {"source": {"name": s}, "destination": {"name": d}}
                    for s, d in skel.edge_names
                ],
                "symmetries": [list(pair) for pair in skel.symmetry_inds],
                "name": skel.name,
            }
        ]

    # -- setup ---------------------------------------------------------------
    def setup(self):
        """Datasets, loaders, model (Xavier init), the probe render, the
        optimizer and scheduler, the checkpoint dir and the callbacks."""
        if self._setup_done:
            return
        cfg = self.config
        tc = cfg.trainer_config
        seed = tc.seed if tc.seed is not None else 0
        # One generator for the device-side augmentation draws.
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        if cfg.data_config.use_negative_frames and self.model_type in CROP_TYPES:
            # A crop has no frame-level sample to attach a negative to.
            warnings.warn(
                f"use_negative_frames is enabled but model_type="
                f"'{self.model_type}' operates at instance-crop level and "
                f"does not support frame-level negatives. Negative frames "
                f"will be disabled.",
                stacklevel=2,
            )
        user_only = cfg.data_config.user_instances_only
        self.train_ds = make_dataset(self.model_type, self.train_labels, self.ctx, user_only)
        val_ctx = dataclasses.replace(self.ctx, use_augmentations=False)
        self.val_ds = make_dataset(self.model_type, self.val_labels, val_ctx, user_only)
        if len(self.train_ds) == 0:
            raise ValueError("Train dataset is empty (no usable labeled frames).")
        if len(self.val_ds) == 0:
            raise ValueError("Val dataset is empty (no usable labeled frames).")
        self.train_loader = Loader(
            self.train_ds, tc.train_data_loader.batch_size,
            shuffle=tc.train_data_loader.shuffle, seed=seed,
            prefetch=max(2, int(tc.train_data_loader.num_workers or 0)),
        )
        self.val_loader = Loader(
            self.val_ds, tc.val_data_loader.batch_size,
            prefetch=max(2, int(tc.val_data_loader.num_workers or 0)),
        )

        self._renders = {True: make_render_fn(self.ctx, train=True),
                         False: make_render_fn(self.ctx, train=False)}
        # The probe: one val sample through the render gives the network's
        # input shape (and checks the render before the first step).
        probe = self.render(self.val_ds.make_batch([0]), train=False)
        self._input_shape = tuple(probe["image"].shape)

        self.model = Model.from_config(
            self.backbone_type, get_backbone_config(cfg), get_head_config(cfg), self.model_type,
            input_hw=self._input_shape[1:3])
        xavier_init_params(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        cfg.model_config.total_params = int(sum(p.numel() for p in self.model.parameters()))

        self.optimizer = make_optimizer(self.model.parameters(), tc.optimizer_name,
                                        tc.optimizer.lr)
        self.scheduler = make_scheduler(tc.lr_scheduler, tc.optimizer.lr, tc.max_epochs)
        ohkm = tc.online_hard_keypoint_mining
        self._ohkm = dataclasses.asdict(ohkm) if ohkm else None

        if tc.save_ckpt:
            self._setup_ckpt_dir()
        self.callbacks = [ProgressCallback(tc.enable_progress_bar)]
        if self.ckpt_dir is not None:
            self.callbacks.append(CSVLoggerCallback(self.ckpt_dir / "training_log.csv"))
        es = tc.early_stopping
        if es is not None and es.stop_training_on_plateau:
            self.callbacks.append(EarlyStopping(min_delta=es.min_delta, patience=es.patience))
        if tc.eval is not None and tc.eval.enabled:
            # Ahead of the CSV logger, so that the eval keys land in the row.
            self.callbacks.insert(0, EpochEndEvaluationCallback(
                self, frequency=tc.eval.frequency, oks_stddev=tc.eval.oks_stddev,
                match_threshold=tc.eval.match_threshold))
        self._setup_done = True

    def _setup_ckpt_dir(self):
        """``<ckpt_dir>/<run_name>``, suffixed -1, -2, ... when it exists and
        is not empty, with ``initial_config.yaml`` and
        ``training_config.yaml``. The ``.slp`` splits the JAX trainer also
        writes there are not ported (ROADMAP.md section 1, item 1)."""
        tc = self.config.trainer_config
        run_name = tc.run_name
        if not run_name:
            run_name = time.strftime(f"%y%m%d_%H%M%S.{self.model_type}")
            tc.run_name = run_name
        base = Path(tc.ckpt_dir or ".") / run_name
        ckpt_dir, n = base, 0
        while ckpt_dir.exists() and any(ckpt_dir.iterdir()):
            n += 1
            ckpt_dir = base.with_name(f"{base.name}-{n}")
        if n:
            tc.run_name = ckpt_dir.name
        self.ckpt_dir = ckpt_dir
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        if self.initial_config is not None:
            self.initial_config.save_yaml(self.ckpt_dir / "initial_config.yaml")
        self.config.save_yaml(self.ckpt_dir / "training_config.yaml")

    # -- checkpointing -------------------------------------------------------
    def save_checkpoint(self, name: str = "best.ckpt"):
        if self.ckpt_dir is None:
            return
        state = {
            "state_dict": {f"model.{k}": v.detach().cpu()
                           for k, v in self.model.state_dict().items()},
            "epoch": self.current_epoch,
            "best_val_loss": float(self.best_val_loss),
        }
        path = self.ckpt_dir / name
        tmp = path.with_name(path.name + ".tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)

    @staticmethod
    def load_checkpoint_params(path) -> Dict[str, torch.Tensor]:
        """A checkpoint's model ``state_dict`` (keys without the ``model.``
        prefix), ready for ``Model.load_state_dict(..., strict=True)``."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        return {k[len("model."):] if k.startswith("model.") else k: v
                for k, v in state["state_dict"].items()}

    # -- steps ----------------------------------------------------------------
    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.asarray(batch[k])).to(self.device)
                for k in _BATCH_TENSORS if k in batch}

    def render(self, batch: Dict[str, np.ndarray], train: bool) -> Dict[str, torch.Tensor]:
        """Move a host batch to the device and render its inputs and targets
        (no autograd). The train render augments with the trainer's generator."""
        dbatch = self._to_device(batch)
        processed = self._renders[train](dbatch, self.generator if train else None)
        processed["batch_mask"] = dbatch.get("batch_mask")
        processed["sample_weight"] = dbatch.get("sample_weight")
        return processed

    def compute_loss(self, processed: Dict[str, torch.Tensor], train: bool):
        """Forward and loss of a rendered batch: ``(loss, parts)``."""
        preds = self.model(processed["image"])
        return compute_loss(preds, processed, self.model.heads,
                            sample_weights(processed, train), self._ohkm if train else None)

    def train_step(self, batch: Dict[str, np.ndarray]):
        """Render, forward, loss, backward and one optimizer step.

        Returns the loss and the loss parts, detached, on the device. The
        gradients stay in ``.grad`` until the next step.
        """
        self.model.train()
        processed = self.render(batch, train=True)
        self.optimizer.zero_grad(set_to_none=True)
        loss, parts = self.compute_loss(processed, train=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in parts.items()}

    @torch.no_grad()
    def val_step(self, batch: Dict[str, np.ndarray]):
        self.model.eval()
        return self.compute_loss(self.render(batch, train=False), train=False)

    # -- loops ----------------------------------------------------------------
    def _log_all(self, hook: str, *args):
        for cb in self.callbacks:
            getattr(cb, hook)(self, *args)

    def train(self):
        """Run the training loop; returns the per-epoch history."""
        self.setup()
        tc = self.config.trainer_config
        self._log_all("on_train_start")
        # An explicit train_steps_per_epoch wins; otherwise small datasets
        # re-draw batches up to min_train_steps_per_epoch.
        steps_cap = tc.train_steps_per_epoch
        if steps_cap is None:
            steps_cap = max(len(self.train_loader), tc.min_train_steps_per_epoch)

        try:
            for epoch in range(self.current_epoch, tc.max_epochs):
                self.current_epoch = epoch
                self._log_all("on_epoch_start", epoch)
                self.train_loader.set_epoch(epoch)

                t0 = time.perf_counter()
                train_losses, part_sums, n_steps, n_samples = [], {}, 0, 0
                data_iter = iter(self.train_loader)
                while True:
                    try:
                        batch = next(data_iter)
                    except StopIteration:
                        if steps_cap and n_steps < steps_cap:
                            self.train_loader.set_epoch(epoch * 1000 + n_steps)
                            data_iter = iter(self.train_loader)
                            continue
                        break
                    self._log_all("on_batch_start", n_steps)
                    loss, parts = self.train_step(batch)
                    train_losses.append(loss)
                    for k, v in parts.items():
                        part_sums.setdefault(k, []).append(v)
                    n_steps += 1
                    n_samples += int(np.sum(batch["batch_mask"]))
                    self._log_all("on_batch_end", n_steps - 1, {})
                    if self.should_stop or (steps_cap and n_steps >= steps_cap):
                        break
                if hasattr(data_iter, "close"):
                    data_iter.close()
                # Wait for the last step before the clock stops.
                train_loss = _mean(train_losses)
                train_time = time.perf_counter() - t0

                val_losses: List[torch.Tensor] = []
                val_part_sums: Dict[str, list] = {}
                for batch in self.val_loader:
                    loss, vparts = self.val_step(batch)
                    val_losses.append(loss)
                    for k, v in vparts.items():
                        if k.startswith("confmap_") or k == "class_accuracy":
                            val_part_sums.setdefault(k, []).append(v)
                val_loss = _mean(val_losses)

                lr = self.scheduler.step(epoch + 1, val_metric=val_loss)
                for group in self.optimizer.param_groups:
                    group["lr"] = lr

                logs = {
                    "train/loss": train_loss,
                    "val/loss": val_loss,
                    "learning_rate": float(lr),
                    "train/steps_per_sec": n_steps / max(train_time, 1e-9),
                    "train/samples_per_sec": n_samples / max(train_time, 1e-9),
                    "epoch_time_s": train_time,
                }
                for k, vals in part_sums.items():
                    key = (f"train/{k}" if k.startswith("confmap_") or k == "class_accuracy"
                           else f"train/{k}_loss")
                    logs[key] = _mean(vals)
                for k, vals in val_part_sums.items():
                    logs[f"val/{k}"] = _mean(vals)
                self.history.append(logs)

                if val_loss < self.best_val_loss:
                    self.best_val_loss = val_loss
                    self.save_checkpoint("best.ckpt")
                if tc.model_ckpt.save_last:
                    self.save_checkpoint("last.ckpt")

                self._log_all("on_epoch_end", epoch, logs)
                if self.should_stop:
                    break
        except KeyboardInterrupt:
            # A cancelled run leaves no model dir behind.
            self._interrupted = True
            print("Stopping training (KeyboardInterrupt)...")
        finally:
            self._log_all("on_train_end")
            if tc.profiler in ("simple", "advanced") and self.history:
                times = [h["epoch_time_s"] for h in self.history]
                sps = [h["train/steps_per_sec"] for h in self.history]
                print(
                    f"[profiler:{tc.profiler}] {len(times)} epochs | "
                    f"epoch_time avg {np.mean(times):.2f}s "
                    f"min {np.min(times):.2f}s max {np.max(times):.2f}s | "
                    f"steps/sec avg {np.mean(sps):.2f}"
                )
            if getattr(self, "_interrupted", False) and self.ckpt_dir is not None \
                    and self.ckpt_dir.exists():
                import shutil

                print(f"Training canceled - cleaning up {self.ckpt_dir}...")
                shutil.rmtree(self.ckpt_dir, ignore_errors=True)
        return self.history


def _mean(values: List[torch.Tensor]) -> float:
    """Mean of device scalars in f32, as ``np.mean`` of the JAX trainer's values."""
    return float(np.mean(torch.stack(values).float().cpu().numpy()))
