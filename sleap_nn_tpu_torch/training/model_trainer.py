"""Training orchestration.

Port of ``sleap_nn_tpu/training/model_trainer.py`` for single-instance,
centroid, centered-instance, bottom-up, identity (multi-class
bottom-up and top-down) and segmentation (bottom-up, semantic and
centered-instance) models with the UNet, ConvNeXt, SwinT and
pretrained backbones, on one device or several. A train step renders the
batch's targets on the device under ``torch.no_grad()`` (kernel 4 on
CUDA for the centroid and bottom-up confidence maps), runs
the forward and the loss under autograd, then ``backward`` and one Adam,
AdamW or AMSGrad step. PyTorch runs eagerly, so where the JAX trainer jits
one program per step, the port launches the same stages one by one. The
model trains with plain convolutions (``use_fused=False``), as the JAX
trainer does: the fused double-conv kernel has no backward.

Initialisation follows the JAX trainer: flax's initialisers (drawn from
the trainer's seeded generator), then Xavier-uniform conv and dense
kernels; a pretrained backbone then loads its HF encoder from a local
snapshot where ``weights`` is set, and ``freeze`` keeps the encoder's
weights as they are (``FrozenBatchNorm`` statistics never change).

More than one device (``trainer_devices``, JAX's rule: the largest count
that divides both batch sizes) trains data-parallel: one process per
device in a ``torch.distributed`` group, ``DistributedDataParallel``
all-reducing the gradients. Without a group the calling process becomes
rank 0 and spawns the others; under a group the caller made, the JAX
package's launch variables or torchrun's, each process joins it
(``sleap_nn_tpu_torch.parallel``). Each rank takes its rows of every
global batch, scales its loss to its share of the global batch's, so
that a step equals the JAX trainer's step on its mesh, and rank 0 alone
writes the model dir, logs and evaluates.

Labels come in memory or from ``data_config.train_labels_path`` /
``val_labels_path`` (``.slp`` files, with the JAX trainer's video path
remapping). The trainer takes the JAX trainer's options: transfer init
from another model's checkpoint, resume, ``init_weights``, ``save_top_k``,
negative frames, user centroids, AMSGrad, tiled training
(``preprocessing.tiling``: frame-level types train on tiles drawn anew each
epoch, ``TiledDataset``) and the disk cache of decoded frames
(``data_pipeline_fw`` ending in ``cache_img_disk``).

The model directory: ``initial_config.yaml`` (the config as the caller
gave it), ``training_config.yaml`` (the config the trainer filled in: max
dims, strides, part names, PAF edges, classes, crop size, skeleton, run
name, parameter count), ``labels_{train,val}_gt_{i}.slp`` (the splits,
frames embedded), ``best.ckpt`` (and ``last.ckpt`` with
``model_ckpt.save_last``, ``epoch=NNN-val_loss=X.ckpt`` with
``save_top_k`` above 1) and ``training_log.csv`` (one row per epoch).
A checkpoint is
``torch.save({"state_dict", "epoch", "best_val_loss"})`` with the model's
``state_dict`` keys under the ``model.`` prefix of the reference's
Lightning checkpoints. ``inference.loaders.load_model`` reads the
directory back; so does the JAX package's ``load_model``.

The monitors, as in the JAX trainer: ``trainer_config.zmq``'s
``publish_port`` publishes the SLEAP GUI's events and ``controller_port``
takes its ``stop`` and ``set_lr`` commands (``training/callbacks.py``);
``visualize_preds_during_training`` draws ``viz/epoch_NNNN*.png``
(deleted after training unless ``keep_viz``); ``use_wandb`` logs to wandb
or, without the package, to a local run directory
(``training/wandb_logging.py``). Under data parallelism rank 0 alone
publishes, draws and logs, and broadcasts the controller's commands after
each batch, so every rank stops, and takes the new learning rate, at the
same step. ``trainer_config.profiler``: ``simple`` and ``advanced`` print
an epoch-time summary; any other value but ``passthrough`` writes a
``torch.profiler`` trace of the run into ``<model_dir>/profile``
(``profiling.trace``: TensorBoard / Perfetto, with the card's kernels).
"""

from __future__ import annotations

import contextlib
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
    TiledDataset,
    build_pipeline_context,
    make_dataset,
    make_render_fn,
)
from sleap_nn_tpu_torch.data.providers import get_max_height_width
from sleap_nn_tpu_torch.inference.backends import resolve_device
from sleap_nn_tpu_torch.io.model import Labels
from sleap_nn_tpu_torch.models.model import MODEL_TYPES, Model, swap_subtrees
from sleap_nn_tpu_torch.parallel import (
    all_reduce_sum,
    available_devices,
    barrier,
    broadcast_object,
    initialize_distributed,
    num_devices,
    process_count,
    process_index,
    sync_cache_fill_status,
)
from sleap_nn_tpu_torch.parallel import distributed
from sleap_nn_tpu_torch import profiling
from sleap_nn_tpu_torch.training.callbacks import (
    Callback,
    CSVLoggerCallback,
    EarlyStopping,
    EpochEndEvaluationCallback,
    ProgressCallback,
    ProgressReporterZMQ,
    TrainingControllerZMQ,
)
from sleap_nn_tpu_torch.training.losses import compute_loss, weighted_total
from sleap_nn_tpu_torch.training.schedulers import make_scheduler

_BATCH_TENSORS = ("image", "instances", "center_idx", "track_ids", "batch_mask",
                  "sample_weight")


def _remap_video_paths(labels: Labels, data_config):
    """Point a labels file's videos at new paths, for labels moved between
    machines: in order (``video_paths``), by exact match
    (``video_path_map``) or by shared prefix (``video_prefix_map``)."""
    vp = getattr(data_config, "video_paths", None)
    if vp:
        for vid, new in zip(labels.videos, vp):
            vid.filename = new
            vid.backend = None
    vmap = getattr(data_config, "video_path_map", None) or {}
    pmap = getattr(data_config, "video_prefix_map", None) or {}
    for vid in labels.videos:
        fn = str(vid.filename)
        if fn in vmap:
            vid.filename = vmap[fn]
            vid.backend = None
            continue
        for old, new in pmap.items():
            if fn.startswith(old):
                vid.filename = new + fn[len(old):]
                vid.backend = None
                break


def _fans(m: nn.Module):
    """``(fan_in, fan_out)`` of a conv, transposed-conv or dense weight as
    the JAX package counts them on its HWIO and (in, out) kernels: ``fan_in
    = kh * kw * in`` (``in`` for a dense layer), ``fan_out = out``. (PyTorch's
    own initialisers on OIHW weights would count ``out * kh * kw`` as
    ``fan_out``.) None for any other module."""
    if isinstance(m, nn.ConvTranspose2d):  # (in, out, kh, kw)
        c_in, c_out, kh, kw = m.weight.shape
    elif isinstance(m, nn.Conv2d):  # (out, in, kh, kw)
        c_out, c_in, kh, kw = m.weight.shape
    elif isinstance(m, nn.Linear):  # (out, in)
        (c_out, c_in), kh, kw = m.weight.shape, 1, 1
    else:
        return None
    return kh * kw * c_in, c_out


def xavier_init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Xavier-uniform conv, transposed-conv and dense weights (limit
    ``sqrt(6 / (fan_in + fan_out))``, the JAX fans of :func:`_fans`), zero
    biases, in place. ``generator`` lives on the weights' device."""
    with torch.no_grad():
        for m in model.modules():
            fans = _fans(m)
            if fans is None:
                continue
            limit = math.sqrt(6.0 / sum(fans))
            u = torch.rand(m.weight.shape, generator=generator, device=m.weight.device)
            m.weight.copy_(u * (2 * limit) - limit)
            if m.bias is not None:
                m.bias.zero_()
    return model


def flax_default_init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The initialisers of the JAX package's flax layers, in place: every
    conv, transposed-conv and dense weight from LeCun's truncated normal
    (``lecun_normal``: variance ``1 / fan_in``, cut at two standard
    deviations), zero biases. The weights the JAX trainer keeps for an
    ``init_weights`` other than ``default`` or ``xavier``; the same
    distribution, not the same values. ``generator`` is a CPU one."""
    with torch.no_grad():
        for m in model.modules():
            fans = _fans(m)
            if fans is None:
                continue
            # flax's variance_scaling divides by the standard deviation of
            # a standard normal cut at +-2.
            std = math.sqrt(1.0 / fans[0]) / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
    return model


# The leaves that flax draws at random other than conv and dense kernels:
# leaf name -> (distribution, standard deviation). SwinT's relative
# position table is ``truncated_normal(0.02)`` (a standard normal cut at
# +-2, times 0.02); the ViT / DINOv2 tokens and position embeddings are
# ``normal(1.0)``. Every other such leaf (LayerNorm and BatchNorm scales
# and offsets, ConvNeXt's layer scale, the GRN's zeros, Swinv2's
# ``logit_scale``, DINOv2's ``ls1`` / ``ls2``) is a constant the modules
# already hold.
_FLAX_RANDOM_LEAVES = {"rel_pos_bias": ("truncated_normal", 0.02),
                       "cls_token": ("normal", 1.0),
                       "position_embeddings": ("normal", 1.0),
                       "register_tokens": ("normal", 1.0)}


def flax_random_leaves_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw the leaves of :data:`_FLAX_RANDOM_LEAVES` as flax's initialisers
    draw them, from ``generator`` (a CPU one), in place."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            rule = _FLAX_RANDOM_LEAVES.get(name.rsplit(".", 1)[-1])
            if rule is None:
                continue
            kind, std = rule
            w = torch.empty(p.shape)
            if kind == "normal":
                w.normal_(0.0, std, generator=generator)
            else:
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
            p.copy_(w)
    return model


def frozen_encoder_parameters(model: nn.Module) -> List[str]:
    """The parameters the JAX trainer's ``freeze`` mask holds still: those
    whose flax path passes through a module named ``enc`` or ``encoder``."""
    from sleap_nn_tpu_torch.weights import torch_key_paths

    paths = torch_key_paths(model)
    return [name for name, _ in model.named_parameters()
            if any(part in ("enc", "encoder") for part in paths[name][0])]


class AMSGrad(torch.optim.Optimizer):
    """``optax.amsgrad`` at its defaults (betas 0.9 / 0.999, eps 1e-8,
    ``eps_root`` 0), written from tensor ops.

    Per step ``t``: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2)
    g^2``, ``nu_max = max(nu_max, nu / (1 - b2^t))`` and ``p -= lr * (mu /
    (1 - b1^t)) / (sqrt(nu_max) + eps)``. optax keeps the maximum of the
    bias-corrected second moment; ``torch.optim.Adam(amsgrad=True)``
    keeps that of the raw one, which steps differently.
    """

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    for k in ("mu", "nu", "nu_max"):
                        state[k] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                mu, nu, nu_max = state["mu"], state["nu"], state["nu_max"]
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).add_(g * g, alpha=1 - b2)
                # optax's bias correction, 1 - decay^t, in f32 (the scalar
                # keeps its f32 value in the f32 ops below).
                c1 = float(1 - np.float32(b1) ** t)
                c2 = float(1 - np.float32(b2) ** t)
                torch.maximum(nu_max, nu / c2, out=nu_max)
                upd = (mu / c1) / (torch.sqrt(nu_max) + group["eps"])
                p.add_(upd * -group["lr"])
        return None


def make_optimizer(params, name: str, lr: float, amsgrad: bool = False) -> torch.optim.Optimizer:
    """``optax.adam`` / ``optax.adamw`` / ``optax.amsgrad`` at their
    defaults, in PyTorch: betas (0.9, 0.999), eps 1e-8 and, for AdamW,
    decoupled weight decay 1e-4 (optax's default; torch's is 1e-2).
    optax has no AMSGrad form of AdamW, so that pair raises, as in JAX."""
    if amsgrad and name.lower() == "adam":
        return AMSGrad(params, lr=lr)
    if amsgrad:
        raise ValueError(
            f"optimizer.amsgrad is only supported with optimizer_name 'adam' (got {name!r}).")
    if name.lower() == "adam":
        return torch.optim.Adam(params, lr=lr)
    if name.lower() == "adamw":
        return torch.optim.AdamW(params, lr=lr, weight_decay=1e-4)
    raise ValueError(f"Unsupported optimizer: {name}")


def _checkpoint_state_of(path) -> Dict[str, torch.Tensor]:
    """The model ``state_dict`` of a model dir's ``best.ckpt`` or of a
    ``.ckpt`` file; a JAX trainer's orbax checkpoint raises, naming the
    tool that converts it."""
    from sleap_nn_tpu_torch.config import resolve_model_dir

    p = Path(path)
    if p.is_dir() and p.suffix.lower() != ".ckpt":
        p = resolve_model_dir(p) / "best.ckpt"
    return ModelTrainer.load_checkpoint_params(p)


def _init_subtrees_from_ckpts(model: nn.Module, backbone_ckpt, head_ckpt) -> None:
    """Replace the backbone and / or every other top-level subtree (the
    heads) of ``model`` with another trained model's, in place. A subtree
    the source lacks, or one whose keys or shapes differ, raises
    ``ValueError`` instead of mixing weights. As in the JAX trainer, which
    swaps the ``params`` collection only, the buffers (``FrozenBatchNorm``'s
    running statistics, JAX's ``batch_stats``) keep ``model``'s values."""
    own = model.state_dict()
    buffers = {k: own[k] for k, _ in model.named_buffers() if k in own}
    for src_path, which in ((backbone_ckpt, "backbone"), (head_ckpt, "head")):
        if src_path:
            swap_subtrees(
                own, _checkpoint_state_of(src_path), which,
                missing="pretrained_{which}_weights: checkpoint has no '{name}' subtree "
                        "(has {trees}).",
                mismatch="pretrained_{which}_weights: '{name}' parameter shapes do not match "
                         "the configured architecture.")
    own.update(buffers)
    model.load_state_dict(own, strict=True)


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


def _unsupported(cfg: TrainingJobConfig, model_type: str) -> List[str]:
    """What this configuration asks for that the port does not train."""
    if model_type not in MODEL_TYPES:
        return [f"model type {model_type!r} (ported: {', '.join(MODEL_TYPES)})"]
    return []


class ModelTrainer:
    """Config-driven training of one model, on one device or data-parallel
    over several (one process each; see the module doc).

    ``device``: ``"cuda"`` (the default; raises without a card) or
    ``"cpu"``; a rank this trainer spawns takes ``cuda:<rank>`` (or the
    CPU). ``trainer_config.trainer_accelerator`` is not read.
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
        missing = _unsupported(config, self.model_type)
        if missing:
            raise NotImplementedError(
                "not ported to the PyTorch trainer yet (ROADMAP.md section 1, item 7c): "
                + "; ".join(missing))
        self.device = resolve_device(device)
        self.should_stop = False
        self.steps_taken = 0  # train_step calls, the key of their spans
        # Set by the ZMQ controller's set_lr: the learning rate from the
        # next epoch on, in place of the scheduler's.
        self.lr_override: Optional[float] = None
        self.current_epoch = 0
        self.ckpt_dir: Optional[Path] = None
        self.callbacks: List[Callback] = []
        self.history: List[Dict] = []
        self.best_val_loss = math.inf
        self.initial_config: Optional[TrainingJobConfig] = None  # set by from_config
        self._top_k_ckpts: List = []
        self._setup_done = False
        # Data parallelism (set by setup): this process's rank, the ranks,
        # the DDP wrapper of the model, the ranks this process spawned and
        # whether it leaves the group when training ends.
        self.rank, self.n_ranks, self.distributed = 0, 1, False
        self._train_rows: Optional[torch.Tensor] = None  # set by setup
        self._lead_row = False
        self._ddp: Optional[nn.Module] = None
        self._spawned = None
        self._owns_group = False

    # -- construction -------------------------------------------------------
    @classmethod
    def get_model_trainer_from_config(
        cls,
        config: TrainingJobConfig,
        train_labels: Optional[List[Labels]] = None,
        val_labels: Optional[List[Labels]] = None,
        device="cuda",
    ) -> "ModelTrainer":
        """Validate the config, load and split the labels, infer the derived
        config.

        Labels come in memory, else from ``data_config.train_labels_path``
        (and ``val_labels_path``) through ``io.slp.load_slp`` with the JAX
        trainer's video path remapping; an empty training file raises
        ``ValueError``. Without validation labels the training labels are
        split with ``Labels.make_training_splits`` at
        ``validation_fraction`` and the trainer seed, as the JAX trainer
        splits them.
        """
        verify_training_cfg(config)
        initial = copy.deepcopy(config)
        dc = config.data_config
        if train_labels is None:
            from sleap_nn_tpu_torch.io.slp import load_slp

            paths = dc.train_labels_path or []
            if not paths:
                raise ValueError("data_config.train_labels_path must be set.")
            train_labels = [load_slp(p) for p in paths]
            for p, labels in zip(paths, train_labels):
                if not labels.labeled_frames:
                    raise ValueError(
                        f"Training labels file is empty (no labeled frames): {p}")
                _remap_video_paths(labels, dc)
        if val_labels is None:
            if dc.use_same_data_for_val:
                val_labels = list(train_labels)
            elif dc.val_labels_path:
                from sleap_nn_tpu_torch.io.slp import load_slp

                val_labels = [load_slp(p) for p in dc.val_labels_path]
                for labels in val_labels:
                    _remap_video_paths(labels, dc)
            else:
                frac = dc.validation_fraction
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
        if getattr(cm, "centroid_source", None) == "user":
            # Only centroid models train on user-annotated centroids.
            if self.model_type != "centroid":
                raise ValueError(
                    "centroid_source='user' only applies to centroid "
                    f"models, not {self.model_type!r}.")
            if not any(lf.user_centroids for L in self.train_labels for lf in L.labeled_frames):
                raise ValueError(
                    "centroid_source='user' but the training labels carry "
                    "no user-annotated centroid records; annotate centroids "
                    "or use centroid_source='computed'.")
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
        """The ranks, datasets, loaders, model (flax's initialisers, Xavier
        kernels, a pretrained encoder), the probe render, the optimizer and
        scheduler, the checkpoint dir and the callbacks."""
        if self._setup_done:
            return
        cfg = self.config
        tc = cfg.trainer_config
        self._join_or_launch_ranks()
        seed = tc.seed if tc.seed is not None else 0
        # One generator for the device-side augmentation draws.
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        use_negatives = cfg.data_config.use_negative_frames
        if use_negatives and self.model_type in CROP_TYPES:
            # A crop has no frame-level sample to attach a negative to.
            warnings.warn(
                f"use_negative_frames is enabled but model_type="
                f"'{self.model_type}' operates at instance-crop level and "
                f"does not support frame-level negatives. Negative frames "
                f"will be disabled.",
                stacklevel=2,
            )
            use_negatives = False
        dc = cfg.data_config
        ds_kwargs = dict(
            user_instances_only=dc.user_instances_only,
            use_negative_frames=use_negatives,
            negative_loss_weight=dc.negative_loss_weight,
            centroid_from_user=(
                self.model_type == "centroid"
                and getattr(getattr(get_head_config(cfg), "confmaps", None),
                            "centroid_source", None) == "user"),
            use_existing_imgs=dc.use_existing_imgs,
            cache_workers=dc.cache_workers or (4 if dc.parallel_caching else 0),
        )
        # The disk cache: each split's frames in a directory of its own
        # under cache_img_path (a temporary directory each where unset).
        disk = str(dc.data_pipeline_fw).endswith("cache_img_disk")
        cache_dirs = {split: (Path(dc.cache_img_path) / f"{split}_imgs"
                              if disk and dc.cache_img_path else None)
                      for split in ("train", "val")}
        cache_mode = "disk" if disk else "memory"
        # Every rank fills its cache; a rank that failed makes them all raise.
        cache_error: Optional[Exception] = None
        try:
            self.train_ds = make_dataset(self.model_type, self.train_labels, self.ctx,
                                         cache_mode=cache_mode, cache_dir=cache_dirs["train"],
                                         **ds_kwargs)
            val_ctx = dataclasses.replace(self.ctx, use_augmentations=False)
            self.val_ds = make_dataset(self.model_type, self.val_labels, val_ctx,
                                       cache_mode=cache_mode, cache_dir=cache_dirs["val"],
                                       **{**ds_kwargs, "use_negative_frames": False})
        except Exception as e:  # noqa: BLE001 (raised on every rank below)
            cache_error = e
        sync_cache_fill_status(cache_error)
        tiling = dc.preprocessing.tiling
        if tiling is not None and tiling.enabled:
            self._setup_tiling(tiling, seed)
        if len(self.train_ds) == 0:
            raise ValueError("Train dataset is empty (no usable labeled frames).")
        if len(self.val_ds) == 0:
            raise ValueError("Val dataset is empty (no usable labeled frames).")
        # Data-parallel: each rank loads and renders its rows of every
        # global batch; the train render draws the augmentation of the
        # whole global batch (every rank's generator in step) and applies
        # it to those rows, with the row before them where mixup blends it.
        mixup = (self.n_ranks > 1 and self.ctx.use_augmentations
                 and (self.ctx.geometric or {}).get("mixup_p", 0) > 0)
        self.train_loader = Loader(
            self.train_ds, tc.train_data_loader.batch_size,
            shuffle=tc.train_data_loader.shuffle, seed=seed,
            prefetch=max(2, int(tc.train_data_loader.num_workers or 0)),
            rank=self.rank, num_ranks=self.n_ranks, lead_row=mixup,
        )
        self._train_rows = None if self.n_ranks == 1 else torch.as_tensor(
            self.train_loader.rows, device=self.device)
        self._lead_row = mixup
        val_prefetch = max(2, int(tc.val_data_loader.num_workers or 0))
        self.val_loader = Loader(self.val_ds, tc.val_data_loader.batch_size,
                                 prefetch=val_prefetch, rank=self.rank, num_ranks=self.n_ranks)
        # The epoch-end evaluation (rank 0) scores the whole val set.
        self.eval_loader = self.val_loader if self.n_ranks == 1 else Loader(
            self.val_ds, tc.val_data_loader.batch_size, prefetch=val_prefetch)

        self._renders = {True: make_render_fn(self.ctx, train=True),
                         False: make_render_fn(self.ctx, train=False)}
        # The probe: one val sample through the render gives the network's
        # input shape (and checks the render before the first step).
        probe = self.render(self.val_ds.make_batch([0]), train=False)
        self._input_shape = tuple(probe["image"].shape)

        self.model = Model.from_config(
            self.backbone_type, get_backbone_config(cfg), get_head_config(cfg), self.model_type,
            input_hw=self._input_shape[1:3])
        init_gen = torch.Generator().manual_seed(seed)
        flax_random_leaves_init(self.model, init_gen)
        if cfg.model_config.init_weights in ("default", "xavier"):
            xavier_init_params(self.model, init_gen)
        else:
            flax_default_init_params(self.model, init_gen)
        frozen: List[str] = []
        if self.backbone_type == "pretrained":
            bb = get_backbone_config(cfg)
            if getattr(bb, "weights", True):
                from sleap_nn_tpu_torch.models.pretrained import load_hf_encoder_params

                state, _ = load_hf_encoder_params(bb.model_name, self.model.state_dict(),
                                                  revision=getattr(bb, "revision", None))
                self.model.load_state_dict(state, strict=True)
            if getattr(bb, "freeze", False):
                frozen = frozen_encoder_parameters(self.model)
        mc = cfg.model_config
        if mc.pretrained_backbone_weights or mc.pretrained_head_weights:
            # Transfer init from another trained model's checkpoint.
            _init_subtrees_from_ckpts(self.model, mc.pretrained_backbone_weights,
                                      mc.pretrained_head_weights)
        if tc.resume_ckpt_path:
            # Parameters, epoch and best val loss from a saved checkpoint; the
            # optimizer restarts fresh, as in the JAX trainer.
            self._warn_on_resume_seed_mismatch(cfg)
            state = self.load_checkpoint(tc.resume_ckpt_path)
            restored = state["state_dict"]
            want = {k: tuple(v.shape) for k, v in self.model.state_dict().items()}
            if want != {k: tuple(v.shape) for k, v in restored.items()}:
                raise ValueError(
                    f"resume_ckpt_path params do not match the configured "
                    f"model architecture ({tc.resume_ckpt_path}).")
            self.model.load_state_dict(restored, strict=True)
            self.current_epoch = int(state.get("epoch", -1)) + 1
            self.best_val_loss = float(state.get("best_val_loss", math.inf))
        self.model.to(self.device)
        # The JAX trainer counts every leaf of its variables, batch_stats
        # (FrozenBatchNorm's statistics) included: the state_dict's leaves.
        cfg.model_config.total_params = int(sum(v.numel()
                                                for v in self.model.state_dict().values()))
        # freeze: the encoder's weights never move (the JAX trainer zeros
        # their updates; here they take no gradient and no optimizer step).
        params = dict(self.model.named_parameters())
        for name in frozen:
            params[name].requires_grad_(False)
        self.frozen_parameters = frozen
        if self.distributed:
            from torch.nn.parallel import DistributedDataParallel

            # static_graph: a pretrained encoder under out_indices computes
            # stages whose parameters no output uses, the same ones each step.
            self._ddp = DistributedDataParallel(
                self.model, device_ids=[self.device.index] if self.device.type == "cuda" else None,
                broadcast_buffers=False, static_graph=True)

        self._trained = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = make_optimizer(self._trained, tc.optimizer_name, tc.optimizer.lr,
                                        bool(tc.optimizer.amsgrad))
        self.scheduler = make_scheduler(tc.lr_scheduler, tc.optimizer.lr, tc.max_epochs)
        ohkm = tc.online_hard_keypoint_mining
        self._ohkm = dataclasses.asdict(ohkm) if ohkm else None

        if tc.save_ckpt:
            self._setup_ckpt_dir()
        # Rank 0 alone prints, logs and evaluates; every rank stops early alike.
        lead = self.rank == 0
        self.callbacks = [ProgressCallback(tc.enable_progress_bar)] if lead else []
        if self.ckpt_dir is not None and lead:
            self.callbacks.append(CSVLoggerCallback(self.ckpt_dir / "training_log.csv"))
        es = tc.early_stopping
        if es is not None and es.stop_training_on_plateau:
            self.callbacks.append(EarlyStopping(min_delta=es.min_delta, patience=es.patience))
        if tc.eval is not None and tc.eval.enabled and lead:
            # Ahead of the CSV logger, so that the eval keys land in the row.
            self.callbacks.insert(0, EpochEndEvaluationCallback(
                self, frequency=tc.eval.frequency, oks_stddev=tc.eval.oks_stddev,
                match_threshold=tc.eval.match_threshold))
        if tc.visualize_preds_during_training and self.ckpt_dir is not None and lead:
            from sleap_nn_tpu_torch.training.viz import VizCallback

            self.callbacks.append(VizCallback(self, self.ckpt_dir / "viz"))
        if tc.use_wandb and lead:
            from sleap_nn_tpu_torch.training.wandb_logging import WandbLoggerCallback

            self.callbacks.append(WandbLoggerCallback(self))
        zmq_cfg = tc.zmq
        if zmq_cfg is not None and zmq_cfg.controller_port and lead:
            self.callbacks.append(TrainingControllerZMQ(
                address=f"tcp://127.0.0.1:{zmq_cfg.controller_port}",
                poll_timeout=zmq_cfg.controller_polling_timeout))
        if zmq_cfg is not None and zmq_cfg.publish_port and lead:
            self.callbacks.append(
                ProgressReporterZMQ(address=f"tcp://127.0.0.1:{zmq_cfg.publish_port}"))
        # Every rank takes rank 0's controller commands after each batch.
        self._sync_control = self.distributed and zmq_cfg is not None \
            and bool(zmq_cfg.controller_port)
        self._setup_done = True

    def _join_or_launch_ranks(self):
        """Data parallelism. Join the process group the caller made or the
        launch variables describe (``parallel.initialize_distributed``):
        its size must divide both batch sizes. Without one, JAX's device
        count (``parallel.num_devices``); above 1, this process spawns
        ranks ``1..n-1`` (one device each, running this trainer's config
        and labels) and becomes rank 0 of their group."""
        tc = self.config.trainer_config
        bs, vbs = tc.train_data_loader.batch_size, tc.val_data_loader.batch_size
        # Through the launch variables a CUDA process takes its local rank's card.
        if not distributed.is_initialized() and initialize_distributed(device=self.device.type):
            self._owns_group = True
            if self.device.type == "cuda":
                self.device = torch.device("cuda", torch.cuda.current_device())
        if distributed.is_initialized():
            n = process_count()
            if bs % n or vbs % n:
                raise ValueError(f"batch sizes {bs} (train) and {vbs} (val) must divide evenly "
                                 f"across the {n} processes of the group.")
        else:
            n = num_devices(bs, vbs, tc.trainer_devices, available_devices(self.device))
            if n > 1:
                self._spawn_ranks(n)
        self.distributed = distributed.is_initialized()
        self.rank, self.n_ranks = process_index(), process_count()

    def _spawn_ranks(self, n: int):
        """Start ranks ``1..n-1`` (``torch.multiprocessing``, spawn) on
        ``cuda:<rank>`` (or the CPU) and join their group as rank 0."""
        import socket

        import torch.multiprocessing as mp

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            addr = f"localhost:{sock.getsockname()[1]}"
        # The ranks compute as this process does: its TF32 switches go along.
        job = {"config": copy.deepcopy(self.config), "initial_config": self.initial_config,
               "train_labels": self.train_labels, "val_labels": self.val_labels,
               "tf32": (torch.backends.cudnn.allow_tf32,
                        torch.backends.cuda.matmul.allow_tf32)}
        self._spawned = mp.start_processes(_train_rank, args=(addr, n, self.device.type, job),
                                           nprocs=n - 1, join=False, start_method="spawn")
        self._owns_group = True
        try:
            initialize_distributed(addr, n, 0, device=self.device)
        except BaseException:
            self._stop_ranks(failed=True)
            raise

    def _stop_ranks(self, failed: bool) -> None:
        """Wait for the ranks this process spawned (after a failure here,
        end them first), then leave the group this trainer joined. A rank
        that failed raises here."""
        spawned, self._spawned = self._spawned, None
        try:
            if spawned is not None and failed:
                for proc in spawned.processes:
                    proc.terminate()
                    proc.join()
            elif spawned is not None:
                while not spawned.join():
                    pass
        finally:
            if self._owns_group:
                self._owns_group = False
                distributed.destroy()

    def _setup_tiling(self, tiling, seed: int):
        """Tiled training: the tile geometry checked and rounded as the JAX
        trainer rounds it, the datasets wrapped in ``TiledDataset`` (the
        train tiles with a halo when geometric augmentation is on; the val
        tiles drawn with ``seed + 1`` and never re-drawn) and the pipeline
        context set for tiles."""
        cfg = self.config
        if self.model_type in CROP_TYPES:
            raise ValueError(
                f"Tiled training is not supported for crop-based model type "
                f"{self.model_type!r}.")
        if not tiling.tile_size:
            raise ValueError("tiling.enabled requires tiling.tile_size.")
        unit = int(get_backbone_config(cfg).max_stride)
        rounded = int(math.ceil(tiling.tile_size / unit) * unit)
        if rounded != tiling.tile_size:
            print(f"WARNING: tiling.tile_size {tiling.tile_size} is not a multiple of "
                  f"max_stride {unit}; rounded up to {rounded}.")
            tiling.tile_size = rounded
        out_stride = int(self.ctx.output_stride or 1)
        ov = int(tiling.overlap or 0)
        if ov % out_stride:
            ov2 = int(math.ceil(ov / out_stride) * out_stride)
            print(f"WARNING: tiling.overlap {ov} is not a multiple of the output stride "
                  f"{out_stride}; rounded up to {ov2}.")
            ov = ov2
        floor = int(math.ceil((tiling.min_overlap_fraction or 0) * tiling.tile_size))
        if ov < floor:
            floor = int(math.ceil(floor / out_stride) * out_stride)
            print(f"WARNING: tiling.overlap {ov} is below the min_overlap_fraction floor "
                  f"({floor}); raised.")
            ov = floor
        if ov >= tiling.tile_size:
            raise ValueError(f"tiling.overlap ({ov}) must be smaller than tiling.tile_size "
                             f"({tiling.tile_size}).")
        tiling.overlap = ov
        dc = cfg.data_config
        use_halo = bool(dc.use_augmentations_train and dc.augmentation_config is not None
                        and dc.augmentation_config.geometric is not None)
        self.train_ds = TiledDataset(self.train_ds, tiling, base_seed=seed, use_halo=use_halo)
        self.val_ds = TiledDataset(self.val_ds, tiling, base_seed=seed + 1)
        # Tiles are fixed-size already: the labels' max dims would scale
        # each tile back up to the frame's size.
        self.ctx = dataclasses.replace(self.ctx, max_height=None, max_width=None,
                                       halo_crop_to=tiling.tile_size if use_halo else None)

    def delete_cache(self) -> None:
        """Remove the disk cache's directories (``delete_cache_imgs_after_training``)."""
        import shutil

        for ds in (getattr(self, "train_ds", None), getattr(self, "val_ds", None)):
            cache = getattr(getattr(ds, "inner", ds), "cache_dir", None)
            if cache:
                shutil.rmtree(cache, ignore_errors=True)

    @staticmethod
    def _warn_on_resume_seed_mismatch(cfg):
        """Warn when resuming with another train/val split seed than the
        run that wrote the checkpoint: a new split can move that run's
        validation frames into training."""
        orig_path = Path(cfg.trainer_config.resume_ckpt_path).parent / "training_config.yaml"
        if not orig_path.exists():
            warnings.warn(
                f"Resuming from checkpoint but {orig_path} was not found to "
                f"verify the train/val split seed. Ensure trainer_config.seed "
                f"matches the original run to avoid train/val leakage.",
                stacklevel=3,
            )
            return
        try:
            import yaml

            with open(orig_path) as fp:
                orig = yaml.safe_load(fp) or {}
            orig_seed = (orig.get("trainer_config") or {}).get("seed")
        except Exception:
            return
        seed = cfg.trainer_config.seed
        if orig_seed != seed:
            warnings.warn(
                f"Current seed ({seed}) differs from the original training "
                f"seed ({orig_seed}) in {orig_path}. This produces a "
                f"different train/val split and can leak former validation "
                f"frames into training. Set trainer_config.seed: {orig_seed} "
                f"to preserve the original split.",
                stacklevel=3,
            )

    def _setup_ckpt_dir(self):
        """``<ckpt_dir>/<run_name>``, suffixed -1, -2, ... when it exists and
        is not empty, with ``initial_config.yaml``, ``training_config.yaml``
        and the splits as ``labels_{train,val}_gt_{i}.slp`` (frames
        embedded)."""
        tc = self.config.trainer_config
        run_name = tc.run_name
        if not run_name:
            run_name = time.strftime(f"%y%m%d_%H%M%S.{self.model_type}")
            tc.run_name = run_name
        # Rank 0 picks the suffix (and the time-stamped name) for every rank.
        run_name, n = broadcast_object((run_name, self._free_suffix(tc, run_name)))
        tc.run_name = run_name
        base = Path(tc.ckpt_dir or ".") / run_name
        ckpt_dir = base if n == 0 else base.with_name(f"{base.name}-{n}")
        if n:
            tc.run_name = ckpt_dir.name
        self.ckpt_dir = ckpt_dir
        if self.rank == 0:
            self.ckpt_dir.mkdir(parents=True, exist_ok=True)
            if self.initial_config is not None:
                self.initial_config.save_yaml(self.ckpt_dir / "initial_config.yaml")
            self.config.save_yaml(self.ckpt_dir / "training_config.yaml")
            for split, labels_list in (("train", self.train_labels), ("val", self.val_labels)):
                for i, labels in enumerate(labels_list):
                    labels.save(self.ckpt_dir / f"labels_{split}_gt_{i}.slp", embed=True)
        barrier("ckpt_dir")

    def _free_suffix(self, tc, run_name: str) -> int:
        """0, or the first ``n`` whose ``<run_name>-<n>`` is free (rank 0's
        probe; the other ranks' value is not used)."""
        base = Path(tc.ckpt_dir or ".") / run_name
        probe, n = base, 0
        while self.rank == 0 and probe.exists() and any(probe.iterdir()):
            n += 1
            probe = base.with_name(f"{base.name}-{n}")
        return n

    # -- checkpointing -------------------------------------------------------
    def save_checkpoint(self, name: str = "best.ckpt"):
        """Rank 0 writes ``name``; every rank waits for the file."""
        if self.ckpt_dir is None:
            return
        if self.rank == 0:
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
        barrier(f"ckpt:{name}")

    def _update_top_k(self, epoch: int, val_loss: float, top_k: int):
        """Keep the ``top_k`` best epoch-stamped checkpoints: each epoch that
        qualifies writes ``epoch=NNN-val_loss=X.ckpt``, and past ``top_k``
        the worst one is deleted."""
        if len(self._top_k_ckpts) >= top_k and val_loss >= max(
                v for v, _ in self._top_k_ckpts):
            return
        name = f"epoch={epoch:03d}-val_loss={val_loss:.5f}.ckpt"
        self.save_checkpoint(name)
        self._top_k_ckpts.append((val_loss, self.ckpt_dir / name))
        self._top_k_ckpts.sort(key=lambda t: t[0])
        while len(self._top_k_ckpts) > top_k:
            _, worst = self._top_k_ckpts.pop()
            if self.rank == 0:
                worst.unlink(missing_ok=True)

    @staticmethod
    def load_checkpoint(path) -> Dict:
        """What ``save_checkpoint`` wrote: ``state_dict`` (keys without the
        ``model.`` prefix), ``epoch`` and ``best_val_loss``. A JAX trainer's
        orbax checkpoint (a directory) raises, naming the tool that
        converts it."""
        path = Path(path)
        if path.is_dir():
            from sleap_nn_tpu_torch.inference.loaders import orbax_refusal

            raise orbax_refusal(path)
        state = torch.load(path, map_location="cpu", weights_only=True)
        state["state_dict"] = {k.removeprefix("model."): v
                               for k, v in state["state_dict"].items()}
        return state

    @staticmethod
    def load_checkpoint_params(path) -> Dict[str, torch.Tensor]:
        """A checkpoint's model ``state_dict`` (keys without the ``model.``
        prefix), ready for ``Model.load_state_dict(..., strict=True)``."""
        return ModelTrainer.load_checkpoint(path)["state_dict"]

    # -- steps ----------------------------------------------------------------
    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The batch's arrays as tensors on the device (a tensor already
        there as it is)."""
        return {k: (batch[k] if torch.is_tensor(batch[k])
                    else torch.from_numpy(np.asarray(batch[k]))).to(self.device)
                for k in _BATCH_TENSORS if k in batch}

    def render(self, batch: Dict[str, np.ndarray], train: bool) -> Dict[str, torch.Tensor]:
        """Move a host batch to the device and render its inputs and targets
        (no autograd). The train render augments with the trainer's
        generator; under data parallelism it draws the augmentation of the
        global batch and applies this rank's rows of it (the train loader's
        ``rows``), then drops the lead row that only fed mixup."""
        dbatch = self._to_device(batch)
        if train:
            processed = self._renders[True](dbatch, self.generator, self._train_rows,
                                            self.train_loader.batch_size)
        else:
            processed = self._renders[False](dbatch)
        processed["batch_mask"] = dbatch.get("batch_mask")
        processed["sample_weight"] = dbatch.get("sample_weight")
        if train and self._lead_row:
            n = len(batch["batch_mask"])
            processed = {k: v[1:] if torch.is_tensor(v) and v.ndim and v.shape[0] == n else v
                         for k, v in processed.items()}
        return processed

    def compute_loss(self, processed: Dict[str, torch.Tensor], train: bool):
        """Forward and loss of a rendered batch: ``(loss, parts)``; under
        data parallelism this rank's shares of the global batch's (the
        train forward through the DDP wrapper)."""
        net = self._ddp if train and self._ddp is not None else self.model
        preds = net(processed["image"])
        return compute_loss(preds, processed, self.model.heads,
                            sample_weights(processed, train), self._ohkm if train else None,
                            group_sum=all_reduce_sum if self.distributed else None)

    def _logged(self, loss: torch.Tensor, parts: Dict[str, torch.Tensor]):
        """The global batch's loss and parts, detached: under data
        parallelism ``loss`` is this rank's share and ``parts`` are the
        global batch's already (:func:`compute_loss`), so the loss is
        their weighted sum."""
        parts = {k: v.detach() for k, v in parts.items()}
        if self.distributed:
            return weighted_total(parts, self.model.heads), parts
        return loss.detach(), parts

    def train_step(self, batch: Dict[str, np.ndarray]):
        """Render, forward, loss, backward and one optimizer step.

        Returns the loss and the loss parts of the global batch, detached,
        on the device. The gradients stay in ``.grad`` until the next step.
        Under data parallelism each rank's share is scaled by the number of
        ranks, so that DDP's average of the gradients is the gradient of
        the global batch's loss. While a profiler runs its parts are
        spans keyed by the step's index (:attr:`steps_taken` before it),
        timed on the host and the card: ``train.to_device``,
        ``train.render``, ``train.forward_loss``, ``train.backward`` and
        ``train.optimizer``.
        """
        key, device = self.steps_taken, self.device
        self.steps_taken += 1
        self.model.train()
        with profiling.span("train.to_device", key, device):
            batch = {**batch, **self._to_device(batch)}
        with profiling.span("train.render", key, device):
            processed = self.render(batch, train=True)
        with profiling.span("train.forward_loss", key, device):
            self.optimizer.zero_grad(set_to_none=True)
            loss, parts = self.compute_loss(processed, train=True)
        with profiling.span("train.backward", key, device):
            (loss * self.n_ranks if self._ddp is not None else loss).backward()
        with profiling.span("train.optimizer", key, device):
            for p in self._trained:
                if p.grad is None:  # unused by every output: optax's zero gradient
                    p.grad = torch.zeros_like(p)
            self.optimizer.step()
        return self._logged(loss, parts)

    @torch.no_grad()
    def val_step(self, batch: Dict[str, np.ndarray]):
        self.model.eval()
        return self._logged(*self.compute_loss(self.render(batch, train=False), train=False))

    # -- loops ----------------------------------------------------------------
    def _log_all(self, hook: str, *args):
        for cb in self.callbacks:
            getattr(cb, hook)(self, *args)

    def _sync_controller(self) -> None:
        """Rank 0's ``should_stop`` and ``lr_override`` on every rank."""
        self.should_stop, self.lr_override = broadcast_object(
            (self.should_stop, self.lr_override))

    def train(self):
        """Run the training loop; returns the per-epoch history."""
        self.setup()
        tc = self.config.trainer_config
        self._log_all("on_train_start")
        # A device trace of the whole run for any profiler but the
        # epoch-time summaries.
        traced = tc.profiler not in (None, "simple", "advanced", "passthrough")
        stack = contextlib.ExitStack()
        # An explicit train_steps_per_epoch wins, then tiling.steps_per_epoch;
        # otherwise small datasets re-draw batches up to
        # min_train_steps_per_epoch.
        steps_cap = tc.train_steps_per_epoch
        tiling = self.config.data_config.preprocessing.tiling
        if steps_cap is None and tiling is not None and tiling.enabled \
                and tiling.steps_per_epoch:
            steps_cap = int(tiling.steps_per_epoch)
        if steps_cap is None:
            steps_cap = max(len(self.train_loader), tc.min_train_steps_per_epoch)

        failed = False
        try:
            if traced:
                stack.enter_context(profiling.trace((self.ckpt_dir or Path(".")) / "profile", self.device))
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
                    n_samples += int(batch.get("n_real", np.sum(batch["batch_mask"])))
                    self._log_all("on_batch_end", n_steps - 1, {})
                    if self._sync_control:
                        self._sync_controller()
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
                if self.lr_override is not None:
                    lr = self.lr_override
                # Only the rate changes: Adam's moments stay.
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
                top_k = int(tc.model_ckpt.save_top_k or 1)
                if top_k > 1 and self.ckpt_dir is not None:
                    self._update_top_k(epoch, val_loss, top_k)
                if tc.model_ckpt.save_last:
                    self.save_checkpoint("last.ckpt")

                self._log_all("on_epoch_end", epoch, logs)
                if self.should_stop:
                    break
        except KeyboardInterrupt:
            # A cancelled run leaves no model dir behind.
            self._interrupted = True
            print("Stopping training (KeyboardInterrupt)...")
        except BaseException:
            failed = True
            raise
        finally:
            self._log_all("on_train_end")
            for cb in self.callbacks:
                if hasattr(cb, "close"):
                    cb.close()
            if self.ckpt_dir is not None and not tc.keep_viz and self.rank == 0 \
                    and (self.ckpt_dir / "viz").exists():
                import shutil

                shutil.rmtree(self.ckpt_dir / "viz", ignore_errors=True)
            stack.close()
            if tc.profiler in ("simple", "advanced") and self.history:
                times = [h["epoch_time_s"] for h in self.history]
                sps = [h["train/steps_per_sec"] for h in self.history]
                print(
                    f"[profiler:{tc.profiler}] {len(times)} epochs | "
                    f"epoch_time avg {np.mean(times):.2f}s "
                    f"min {np.min(times):.2f}s max {np.max(times):.2f}s | "
                    f"steps/sec avg {np.mean(sps):.2f}"
                )
            dc = self.config.data_config
            if str(dc.data_pipeline_fw).endswith("cache_img_disk") \
                    and dc.delete_cache_imgs_after_training and self.rank == 0:
                self.delete_cache()
            if getattr(self, "_interrupted", False) and self.ckpt_dir is not None \
                    and self.ckpt_dir.exists() and self.rank == 0:
                import shutil

                print(f"Training canceled - cleaning up {self.ckpt_dir}...")
                shutil.rmtree(self.ckpt_dir, ignore_errors=True)
            self._stop_ranks(failed)
        return self.history


def _train_rank(index: int, addr: str, n: int, device_type: str, job: Dict) -> None:
    """A spawned rank (``index + 1``): join the group at ``addr``, then
    train ``job``'s config on its labels, on ``cuda:<rank>`` or the CPU."""
    rank = index + 1
    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = job["tf32"]
    initialize_distributed(addr, n, rank, device=device)
    try:
        trainer = ModelTrainer(job["config"], job["train_labels"], job["val_labels"],
                               device=device)
        trainer.initial_config = job["initial_config"]
        trainer._infer_config()
        trainer.train()
    finally:
        distributed.destroy()


def _mean(values: List[torch.Tensor]) -> float:
    """Mean of device scalars in f32, as ``np.mean`` of the JAX trainer's values."""
    return float(np.mean(torch.stack(values).float().cpu().numpy()))
