"""Port parity: the pretrained backbone (ConvNeXtV2, ResNet basic and
bottleneck, Swinv2, ViT, DINOv2 with and without registers) against the JAX
package, on the CPU at tiny widths.

Each encoder family gets a synthetic HF snapshot that the test writes: a
``config.json`` and a ``model.safetensors`` (written with ``safetensors``)
whose keys are HF's names, made by inverting the JAX package's key maps
over a random flax tree, plus the buffers HF checkpoints carry and the
importer skips. Both packages import it (``load_hf_encoder_params``); the
port's ``state_dict`` must equal the JAX importer's tree leaf for leaf after
``weights.flax_to_torch_state``, and the encoders' features must agree
(``max |port - jax| <= 1e-4 * max |jax|``), also at an input size that makes
Swinv2 pad and ViT resize its position grid. The backbone and model built
from the snapshot's config (mode, ``out_indices``, probed pyramid, heads)
match too, and the probe of each built-in architecture the card runs.
Without a snapshot both packages warn and keep the random init.
"""

import json
import warnings
from types import SimpleNamespace as ns

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from sleap_nn_tpu.models import pretrained as jp
from sleap_nn_tpu.models import transformer_encoders as jte
from sleap_nn_tpu.models.model import Model as FlaxModel
from sleap_nn_tpu_torch.config.model_config import PretrainedConfig
from sleap_nn_tpu_torch.models import pretrained as tp
from sleap_nn_tpu_torch.models import transformer_encoders as tte
from sleap_nn_tpu_torch.models.model import Model
from sleap_nn_tpu_torch.weights import flax_to_torch_state
from tests.test_torch_backbones import assert_close, random_params

CONFIGS = {
    "convnextv2": {"model_type": "convnextv2", "depths": [1, 1, 2, 1],
                   "hidden_sizes": [8, 16, 24, 32]},
    "resnet_bottleneck": {"model_type": "resnet", "depths": [1, 2, 1, 1],
                          "hidden_sizes": [8, 16, 24, 32], "embedding_size": 8,
                          "layer_type": "bottleneck", "downsample_in_bottleneck": True},
    "resnet_basic": {"model_type": "resnet", "depths": [2, 1, 1, 1],
                     "hidden_sizes": [8, 16, 24, 32], "embedding_size": 8,
                     "layer_type": "basic", "downsample_in_first_stage": True},
    "swinv2": {"model_type": "swinv2", "embed_dim": 16, "depths": [1, 2, 1, 1],
               "num_heads": [2, 2, 2, 2], "window_size": 4, "image_size": 64,
               "patch_size": 4},
    "vit": {"model_type": "vit", "hidden_size": 32, "num_hidden_layers": 2,
            "num_attention_heads": 2, "intermediate_size": 64, "patch_size": 8,
            "image_size": 32},
    "dinov2": {"model_type": "dinov2", "hidden_size": 32, "num_hidden_layers": 2,
               "num_attention_heads": 2, "patch_size": 8, "image_size": 32},
    "dinov2_registers": {"model_type": "dinov2_with_registers", "hidden_size": 32,
                         "num_hidden_layers": 2, "num_attention_heads": 2, "patch_size": 8,
                         "image_size": 32, "num_register_tokens": 2},
}
# A size the patch / window geometry divides, and one it does not.
SIZES = {"swinv2": [(64, 64), (40, 56)], "vit": [(32, 32), (48, 40)],
         "dinov2": [(32, 32), (48, 48)], "dinov2_registers": [(32, 32), (40, 56)]}


# -- HF state dicts from flax trees --------------------------------------------


def _hf_name(family, path):
    """The HF key of one flax leaf path of a bare encoder (the inverse of
    the JAX package's key maps); ``None`` for none."""
    leaf = path[-1]
    w = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}.get(leaf, leaf)
    head = path[0]
    if family == "convnextv2":
        if head == "patch_embed":
            return f"embeddings.patch_embeddings.{w}"
        if head == "embed_norm":
            return f"embeddings.layernorm.{w}"
        if head.startswith("out_norm"):
            return f"hidden_states_norms.stage{int(head[8:]) + 1}.{w}"
        s = int(head[5])
        if head.endswith("_down_norm"):
            return f"encoder.stages.{s}.downsampling_layer.0.{w}"
        if head.endswith("_down_conv"):
            return f"encoder.stages.{s}.downsampling_layer.1.{w}"
        i = int(head.split("block")[1])
        mod = {"norm": "layernorm"}.get(path[1], path[1])
        return f"encoder.stages.{s}.layers.{i}.{mod}.{w}"
    if family == "resnet":
        if head == "stem_conv":
            return "embedder.embedder.convolution.weight"
        if head == "stem_bn":
            return f"embedder.embedder.normalization.{w}"
        s, i = head[5], head.split("block")[1]
        base = f"encoder.stages.{s}.layers.{i}"
        sub = path[1]
        if sub == "shortcut_conv":
            return f"{base}.shortcut.convolution.weight"
        if sub == "shortcut_bn":
            return f"{base}.shortcut.normalization.{w}"
        kind = "convolution" if sub.startswith("conv") else "normalization"
        return f"{base}.layer.{sub[-1]}.{kind}.{w}"
    if family == "swinv2":
        if head == "patch_embed":
            return f"embeddings.patch_embeddings.projection.{w}"
        if head == "embed_norm":
            return f"embeddings.norm.{w}"
        s = int(head[5])
        if head.endswith("_downsample"):
            return f"encoder.layers.{s}.downsample.{path[1]}.{w}"
        base = f"encoder.layers.{s}.blocks.{head.split('block')[1]}"
        sub = path[1]
        if sub == "attn":
            mod = path[2]
            if mod == "logit_scale":
                return f"{base}.attention.self.logit_scale"
            name = {"cpb_fc1": "continuous_position_bias_mlp.0",
                    "cpb_fc2": "continuous_position_bias_mlp.2"}.get(mod, mod)
            if mod == "proj":
                return f"{base}.attention.output.dense.{w}"
            return f"{base}.attention.self.{name}.{w}"
        return f"{base}." + {"norm1": "layernorm_before", "norm2": "layernorm_after",
                             "mlp_fc1": "intermediate.dense",
                             "mlp_fc2": "output.dense"}[sub] + f".{w}"
    # vit / dinov2
    dino = family.startswith("dinov2")
    if head in ("cls_token", "position_embeddings", "register_tokens"):
        return f"embeddings.{head}"
    if head == "patch_embed":
        return f"embeddings.patch_embeddings.projection.{w}"
    if head == "final_norm":
        return f"layernorm.{w}"
    base = f"encoder.layer.{head[5:]}"
    sub = path[1]
    if sub == "attn":
        if path[2] == "proj":
            return f"{base}.attention.output.dense.{w}"
        return f"{base}.attention.attention.{path[2]}.{w}"
    if sub in ("ls1", "ls2"):
        return f"{base}.layer_scale{sub[-1]}.lambda1"
    names = ({"norm1": "norm1", "norm2": "norm2", "mlp_fc1": "mlp.fc1", "mlp_fc2": "mlp.fc2"}
             if dino else {"norm1": "layernorm_before", "norm2": "layernorm_after",
                           "mlp_fc1": "intermediate.dense", "mlp_fc2": "output.dense"})
    return f"{base}.{names[sub]}.{w}"


def _hf_layout(value, how):
    if how == "conv":
        return value.transpose(3, 2, 0, 1)
    if how == "dense":
        return value.T
    if how == "squeeze":
        return value.reshape(1, 1, 1, -1)
    return value


def hf_state(family, variables):
    """An HF state dict of the bare encoder whose flax ``variables`` are
    given, in HF's layout, with the buffers HF checkpoints carry."""
    fam = "resnet" if family.startswith("resnet") else family
    mapper = {"convnextv2": jp._map_convnextv2_key, "resnet": jp._map_resnet_key,
              "swinv2": jte.map_swinv2_key}.get(fam, jte.map_vit_key)
    out = {}
    for coll, tree in variables.items():
        for path, value in jax.tree_util.tree_leaves_with_path(tree):
            path = tuple(p.key for p in path)
            key = _hf_name(fam, path)
            got = mapper(key)  # the JAX map sends the key back to its leaf
            assert got[0] == path and (len(got) == 2 or got[2] == coll), (key, got, path)
            out[key] = np.ascontiguousarray(_hf_layout(np.asarray(value), got[1]), np.float32)
    if fam == "resnet":
        out["embedder.embedder.normalization.num_batches_tracked"] = np.zeros((), np.int64)
    if fam == "swinv2":
        out["embeddings.mask_token"] = np.zeros((1, 1, 16), np.float32)
        out["encoder.layers.0.blocks.0.attention.self.relative_position_index"] = \
            np.zeros((16, 16), np.int64)
    if fam in ("vit", "dinov2", "dinov2_registers"):
        out["embeddings.mask_token"] = np.zeros((1, 32), np.float32)
        if fam == "vit":
            out["pooler.dense.weight"] = np.zeros((32, 32), np.float32)
    return out


def _jax_encoder(family):
    return jp.build_encoder(CONFIGS[family])


def _sample(family):
    return (SIZES.get(family) or [(64, 64), (48, 80)])[0]


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """Per family: (snapshot dir, the flax variables its weights hold)."""
    out = {}
    for family, cfg in CONFIGS.items():
        snap = tmp_path_factory.mktemp(f"snap_{family}")
        (snap / "config.json").write_text(json.dumps(cfg))
        x = jnp.zeros((1,) + _sample(family) + (3,))
        variables = random_params(_jax_encoder(family), x, seed=11)
        save_file(hf_state(family, variables), str(snap / "model.safetensors"))
        out[family] = (snap, variables)
    return out


def _holder(encoder):
    holder = torch.nn.Module()
    holder.backbone = torch.nn.Module()
    holder.backbone.encoder = encoder
    return holder


def _under_backbone(variables):
    return {coll: {"backbone": {"encoder": tree}} for coll, tree in variables.items()}


@pytest.mark.parametrize("family", list(CONFIGS))
def test_hf_import_and_features_match_jax(snapshots, family):
    snap, held = snapshots[family]
    jenc = _jax_encoder(family)
    x0 = jnp.zeros((1,) + _sample(family) + (3,))
    start = random_params(jenc, x0, seed=12)
    jvars, jloaded = jp.load_hf_encoder_params(str(snap), jax.tree_util.tree_map(
        np.array, start))
    assert jloaded
    tenc = tp.build_encoder(tp.resolve_hf_config(str(snap))[0], 3)
    holder = _holder(tenc)
    state0 = flax_to_torch_state(_under_backbone(start), holder)
    state, loaded = tp.load_hf_encoder_params(str(snap), state0)
    assert loaded
    want = flax_to_torch_state(_under_backbone(jax.device_get(jvars)), holder)
    assert set(state) == set(want)
    for k in want:
        torch.testing.assert_close(state[k], want[k], rtol=0, atol=0, msg=k)
    # Every leaf now holds the snapshot's weights.
    snap_state = flax_to_torch_state(_under_backbone(held), holder)
    for k in want:
        torch.testing.assert_close(state[k], snap_state[k], rtol=0, atol=0, msg=k)
    holder.load_state_dict(state, strict=True)
    tenc.eval()
    for i, hw in enumerate(SIZES.get(family) or [(64, 64), (48, 80)]):
        x = np.random.default_rng(i).standard_normal((2,) + hw + (3,)).astype(np.float32)
        want_feats = jax.jit(jenc.apply)(jvars, jnp.asarray(x))
        with torch.no_grad():
            got = tenc(torch.from_numpy(x))
        assert len(got) == len(want_feats)
        for g, w in zip(got, want_feats):
            assert_close(g, w)


@pytest.mark.parametrize("n_in,n_out", [(4, 6), (4, 5), (6, 4), (7, 3)])
def test_position_grid_resize_matches_jax_matrix(n_in, n_out):
    """The port resizes the ViT position grid with torch's bicubic; the JAX
    package builds the same map as a matrix."""
    grid = np.random.default_rng(n_in * n_out).standard_normal((n_in, n_in, 5)).astype(
        np.float32)
    wh = jte._torch_bicubic_matrix(n_in, n_out)
    ww = jte._torch_bicubic_matrix(n_in, n_out + 1)
    want = np.einsum("ih,hwc,jw->ijc", wh, grid, ww)
    got = tte.resize_pos_grid(torch.from_numpy(grid), n_out, n_out + 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _cfg(snap, **kw):
    return PretrainedConfig(model_name=str(snap), **kw)


@pytest.mark.parametrize("family,kw,model_type", [
    ("convnextv2", {"output_stride": 2}, "single_instance"),
    ("resnet_bottleneck", {"output_stride": 4, "out_indices": [0, 1, 2]}, "centroid"),
    ("resnet_basic", {"output_stride": 4, "up_interpolate": False}, "bottomup"),
    ("swinv2", {"output_stride": 4}, "single_instance"),
    ("dinov2_registers", {}, "single_instance"),
    ("vit", {"normalize": False, "in_channels": 1}, "multi_class_topdown"),
])
def test_backbone_and_model_match_jax(snapshots, family, kw, model_type):
    snap, _ = snapshots[family]
    cfg = _cfg(snap, **kw)
    jbb, tbb = jp.PretrainedBackbone.from_config(cfg), tp.PretrainedBackbone.from_config(cfg)
    assert tbb.mode == jbb.mode == tp.resolve_mode(CONFIGS[family])
    assert tbb.pyramid_strides == jbb.pyramid_strides
    assert tbb.pyramid_channels == jbb.pyramid_channels
    assert tbb.stride_to_filters == jbb.stride_to_filters
    parts = ["n0", "n1", "n2"]
    stride = min(tbb.stride_to_filters) if tbb.stride_to_filters else tbb.max_stride
    heads = {
        "single_instance": ns(confmaps=ns(part_names=parts, sigma=2.5, output_stride=stride,
                                          loss_weight=None)),
        "centroid": ns(confmaps=ns(anchor_part=None, sigma=2.5, output_stride=stride,
                                   loss_weight=None)),
        "bottomup": ns(confmaps=ns(part_names=parts, sigma=2.5, output_stride=stride,
                                   loss_weight=None),
                       pafs=ns(edges=[["n0", "n1"]], sigma=15.0, output_stride=2 * stride,
                               loss_weight=None)),
        "multi_class_topdown": ns(
            confmaps=ns(part_names=parts, anchor_part=None, sigma=2.5, output_stride=stride,
                        loss_weight=None),
            class_vectors=ns(classes=["a", "b"], num_fc_layers=1, num_fc_units=8,
                             global_pool=True, output_stride=stride, loss_weight=None)),
    }[model_type]
    fm = FlaxModel.from_config("pretrained", cfg, heads, model_type)
    hw = (64, 64)
    params = random_params(fm, jnp.zeros((1,) + hw + (1,)))
    tm = Model.from_config("pretrained", cfg, heads, model_type)
    tm.load_state_dict(flax_to_torch_state(params, tm), strict=True)
    x = np.random.default_rng(5).random((2,) + hw + (1,), dtype=np.float32)
    want = jax.jit(fm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k])


def test_mode_resolution_and_refusals_match_jax(snapshots):
    for arch in list(CONFIGS.values()) + [{"model_type": "deit"}, {"model_type": "other"},
                                          {"model_type": "x", "stage_names": ["a"]}]:
        for mode in ("auto", "decoder", "encoder"):
            assert tp.resolve_mode(arch, mode) == jp.resolve_mode(arch, mode)
    snap, _ = snapshots["dinov2"]
    for pkg in (jp, tp):
        with pytest.raises(ValueError, match="isotropic"):
            pkg.PretrainedBackbone.from_config(_cfg(snap, mode="decoder"))
        with pytest.raises(ValueError, match="out_indices"):
            pkg.PretrainedBackbone.from_config(_cfg(snapshots["convnextv2"][0],
                                                    out_indices=[0, 9]))
        with pytest.raises(ValueError, match="Cannot resolve"):
            pkg.resolve_hf_config("nonexistent/model-id")
        with pytest.raises(ValueError, match="Unsupported pretrained backbone"):
            pkg.build_encoder({"model_type": "mobilenet"})


@pytest.mark.parametrize("name", ["facebook/convnextv2-tiny-22k-224", "microsoft/resnet-50",
                                  "microsoft/swinv2-tiny-patch4-window8-256",
                                  "facebook/dinov2-small", "google/vit-base-patch16-224"])
def test_builtin_probe_matches_jax(name, tmp_path, monkeypatch):
    monkeypatch.setattr("pathlib.Path.home", lambda: tmp_path)
    arch, snap = tp.resolve_hf_config(name)
    assert snap is None and arch == jp.resolve_hf_config(name)[0]
    assert tp.probe_pyramid(arch) == tuple(map(list, jp.probe_pyramid(jp.build_encoder(arch))))


def test_no_snapshot_warns_and_keeps_random_init(tmp_path, monkeypatch):
    monkeypatch.setattr("pathlib.Path.home", lambda: tmp_path)
    name = "microsoft/resnet-18"
    enc = tp.build_encoder(tp.resolve_hf_config(name)[0], 3)
    state = enc.state_dict()
    with pytest.warns(UserWarning, match="No local snapshot"):
        got, loaded = tp.load_hf_encoder_params(name, state)
    assert loaded is False and got is state
    with pytest.warns(UserWarning, match="No local snapshot"):
        _, jloaded = jp.load_hf_encoder_params(name, {"params": {}})
    assert jloaded is False
    # A pinned revision that the cache lacks raises in both.
    for pkg in (tp, jp):
        with warnings.catch_warnings(), pytest.raises(FileNotFoundError):
            (tmp_path / ".cache/huggingface/hub/models--org--m/snapshots/aa11").mkdir(
                parents=True, exist_ok=True)
            pkg.find_local_snapshot("org/m", revision="bb")


def test_read_safetensors_matches_safetensors(tmp_path):
    from safetensors.torch import load_file, save_file as save_torch

    rng = np.random.default_rng(0)
    tensors = {"f32": torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)),
               "f16": torch.from_numpy(rng.standard_normal(5).astype(np.float16)),
               "bf16": torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32)).to(
                   torch.bfloat16),
               "i64": torch.arange(6).reshape(2, 3), "u8": torch.arange(4, dtype=torch.uint8),
               "scalar": torch.tensor(2.5)}
    save_torch(tensors, str(tmp_path / "t.safetensors"), metadata={"format": "pt"})
    got = tp.read_safetensors(tmp_path / "t.safetensors")
    want = load_file(str(tmp_path / "t.safetensors"))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.float().numpy() if k == "bf16" else v.numpy())
        assert got[k].shape == tuple(v.shape)
