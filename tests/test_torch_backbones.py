"""Port parity: the ConvNeXt and SwinT backbones (encoder features and the
wrapper's outputs) and transposed-conv upsampling at any kernel size,
against the JAX package's flax modules.

Both run the same random weights (drawn with numpy) on the same numpy
inputs on the CPU; the flax params reach the port through
``sleap_nn_tpu_torch.weights.flax_to_torch_state`` (strict). Widths are the
tiny test archs of ``tests/models/test_backbones.py``. SwinT also runs
with two blocks a stage, so that odd blocks shift. Inputs: 64x64, which the
windows divide, and 48x80, which makes Swin pad its windows (6x10 tokens to
8x12, shifted and masked) and, in the last stage (3x5 tokens under a
window of 4), drop its shift. Tolerance:
``max |port - jax| <= 1e-4 * max |jax|`` on every f32 map.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.models.convnext import ConvNeXtEncoder
from sleap_nn_tpu.models.convnext import ConvNextWrapper as JConvNext
from sleap_nn_tpu.models.encoder_decoder import SimpleUpsamplingBlock as JUpBlock
from sleap_nn_tpu.models.model import Model as FlaxModel
from sleap_nn_tpu.models.swint import SwinTransformerEncoder
from sleap_nn_tpu.models.swint import SwinTWrapper as JSwinT
from sleap_nn_tpu_torch.config.model_config import ConvNextConfig, SwinTConfig
from sleap_nn_tpu_torch.models.convnext import ConvNextWrapper
from sleap_nn_tpu_torch.models.encoder_decoder import SimpleUpsamplingBlock
from sleap_nn_tpu_torch.models.model import Model
from sleap_nn_tpu_torch.models.swint import SwinTWrapper
from sleap_nn_tpu_torch.weights import flax_to_torch_state
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

ns = types.SimpleNamespace

TINY_ARCH_CN = ((2, 2, 2, 2), (8, 16, 32, 64))
TINY_ARCH_SW = (8, (1, 1, 1, 1), (2, 2, 2, 2))
# Two blocks a stage, so that odd blocks shift their windows.
SHIFT_ARCH_SW = (8, (2, 2, 2, 2), (2, 2, 2, 2))
SIZES = [(64, 64), (48, 80)]


def random_params(module, *args, seed=0, scale=0.3):
    """``module``'s flax variables for ``args``, every leaf drawn from a
    numpy seed (BatchNorm variances kept positive). Only the shapes of
    ``init`` are traced: eager flax init is slow on the CPU."""
    rng = np.random.default_rng(seed)
    variables = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))

    def draw(path, p):
        v = scale * rng.standard_normal(p.shape)
        if path[-1].key == "var":
            v = 0.5 + np.abs(v)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def assert_close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * float(np.max(np.abs(want))), (err, float(np.max(np.abs(want))))


class _Bare(torch.nn.Module):
    """A backbone as the only module under ``backbone`` (for the bridge)."""

    def __init__(self, backbone):
        super().__init__()
        self.backbone = backbone


def _pair(kind, output_stride, hw, **kw):
    if kind == "convnext":
        jm = JConvNext(arch=TINY_ARCH_CN, output_stride_cfg=output_stride, **kw)
        tm = ConvNextWrapper(in_channels=1, arch=TINY_ARCH_CN, output_stride_cfg=output_stride,
                             **kw)
    else:
        arch = SHIFT_ARCH_SW if kind == "swint_shift" else TINY_ARCH_SW
        jm = JSwinT(arch=arch, window_size=4, output_stride_cfg=output_stride, **kw)
        tm = SwinTWrapper(in_channels=1, arch=arch, window_size=4,
                          output_stride_cfg=output_stride, **kw)
    params = random_params(jm, jnp.zeros((1,) + hw + (1,)))
    bare = _Bare(tm)
    bare.load_state_dict(flax_to_torch_state({"params": {"backbone": params["params"]}}, bare),
                         strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("kind", ["convnext", "swint", "swint_shift"])
@pytest.mark.parametrize("hw,output_stride,kw", [
    ((64, 64), 4, {}), ((48, 80), 4, {}), ((64, 64), 2, {"up_interpolate": False}),
    ((48, 80), 2, {"block_contraction": True}), ((64, 64), 4, {"convs_per_block": 1})])
def test_wrapper_outputs_match_flax(kind, hw, output_stride, kw):
    jm, params, tm = _pair(kind, output_stride, hw, **kw)
    x = np.random.default_rng(1).random((2,) + hw + (1,), dtype=np.float32)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert tm.stride_to_filters == jm.stride_to_filters
    assert tm.up_blocks == jm.up_blocks and tm.max_stride == jm.max_stride
    assert got["strides"] == list(want["strides"])
    assert len(got["outputs"]) == len(want["outputs"])
    for g, w in zip(got["outputs"], want["outputs"]):
        assert_close(g, w)
        assert g.shape[-1] == tm.stride_to_filters[hw[0] // g.shape[1]]
    assert_close(got["middle_output"], want["middle_output"])
    assert_close(got["intermediate_feat"], want["intermediate_feat"])


@pytest.mark.parametrize("kind", ["convnext", "swint", "swint_shift"])
@pytest.mark.parametrize("hw", SIZES)
def test_encoder_features_match_flax(kind, hw):
    jm, params, tm = _pair(kind, 4, hw)
    x = np.random.default_rng(2).random((2,) + hw + (1,), dtype=np.float32)
    enc_params = {"params": params["params"]["enc"]}
    if kind == "convnext":
        jenc = ConvNeXtEncoder(depths=TINY_ARCH_CN[0], channels=TINY_ARCH_CN[1])
    else:
        arch = SHIFT_ARCH_SW if kind == "swint_shift" else TINY_ARCH_SW
        jenc = SwinTransformerEncoder(embed_dim=arch[0], depths=arch[1], num_heads=arch[2],
                                      window_size=4)
    want = jax.jit(jenc.apply)(enc_params, jnp.asarray(x))
    with torch.no_grad():
        got = tm.enc(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_close(g, w)


def test_swin_window_paths_are_exercised():
    """At 48x80 the stage maps are 24x40, 12x20, 6x10 and 3x5 tokens under
    a window of 4: the third pads to 8x12 and its odd block shifts (the
    mask meets the padded edge); the fourth, at most 4 tokens high, drops
    its shift."""
    seen = {}
    _, _, tm = _pair("swint_shift", 4, (48, 80))
    for name, mod in tm.enc.named_modules():
        if name.endswith(".attn"):
            mod.register_forward_hook(lambda m, i, o, name=name: seen.__setitem__(
                name, (tuple(i[0].shape[1:3]), bool(m.shift) and min(i[0].shape[1:3]) > 4)))
    with torch.no_grad():
        tm(torch.zeros(1, 48, 80, 1))
    assert seen["stage2_block1.attn"] == ((6, 10), True)
    assert seen["stage3_block1.attn"] == ((3, 5), False)
    assert seen["stage0_block1.attn"] == ((24, 40), True)


@pytest.mark.parametrize("kind", ["convnext", "swint"])
@pytest.mark.parametrize("model_type", ["centroid", "bottomup", "multi_class_topdown"])
def test_model_with_heads_matches_flax(kind, model_type):
    cfg_cls = ConvNextConfig if kind == "convnext" else SwinTConfig
    arch = ({"depths": list(TINY_ARCH_CN[0]), "channels": list(TINY_ARCH_CN[1])}
            if kind == "convnext" else
            {"embed": TINY_ARCH_SW[0], "depths": list(TINY_ARCH_SW[1]),
             "num_heads": list(TINY_ARCH_SW[2])})
    kw = {"window_size": 4} if kind == "swint" else {}
    cfg = cfg_cls(arch=arch, output_stride=2, **kw)
    parts = ["n0", "n1", "n2"]
    heads = {
        "centroid": ns(confmaps=ns(anchor_part=None, sigma=5.0, output_stride=4,
                                   loss_weight=None)),
        "bottomup": ns(confmaps=ns(part_names=parts, sigma=2.5, output_stride=2,
                                   loss_weight=None),
                       pafs=ns(edges=[["n0", "n1"], ["n1", "n2"]], sigma=15.0,
                               output_stride=4, loss_weight=None)),
        "multi_class_topdown": ns(
            confmaps=ns(part_names=parts, anchor_part=None, sigma=2.5, output_stride=2,
                        loss_weight=None),
            class_vectors=ns(classes=["a", "b"], num_fc_layers=1, num_fc_units=8,
                             global_pool=True, output_stride=2, loss_weight=None)),
    }[model_type]
    fm = FlaxModel.from_config(kind, cfg, heads, model_type)
    params = random_params(fm, jnp.zeros((1, 64, 64, 1)))
    tm = Model.from_config(kind, cfg, heads, model_type)
    tm.load_state_dict(flax_to_torch_state(params, tm), strict=True)
    x = np.random.default_rng(3).random((2, 64, 64, 1), dtype=np.float32)
    want = jax.jit(fm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k])


@pytest.mark.parametrize("phase", ["torch", "tf"])
@pytest.mark.parametrize("kernel_size", [3, 5])
def test_transposed_conv_any_kernel_size(phase, kernel_size):
    """The transposed-conv upsampling block at kernel sizes 3 and 5 in
    both phases (with and without a skip) against the flax block."""
    rng = np.random.default_rng(kernel_size)
    x = rng.random((2, 6, 7, 4), dtype=np.float32)
    skip = rng.random((2, 12, 14, 3), dtype=np.float32)
    for feature in (skip, None):
        jb = JUpBlock(refine_convs_filters=5, kernel_size=kernel_size, up_interpolate=False,
                      transpose_convs_filters=6, trans_conv_phase=phase)
        args = (jnp.asarray(x), None if feature is None else jnp.asarray(feature))
        params = random_params(jb, *args)
        tb = SimpleUpsamplingBlock(4, 0 if feature is None else 3, 5, kernel_size=kernel_size,
                                   up_interpolate=False, transpose_convs_filters=6,
                                   trans_conv_phase=phase, prefix="dec0_s8_to_s4")
        holder = torch.nn.Module()
        holder.backbone = torch.nn.Module()
        holder.backbone.dec = tb
        p = {"params": {"backbone": {"dec": {"dec0_s8_to_s4": params["params"]}}}}
        holder.load_state_dict(flax_to_torch_state(p, holder), strict=True)
        want = jb.apply(params, *args)
        with torch.no_grad():
            got = tb(torch.from_numpy(x), None if feature is None else torch.from_numpy(feature))
        assert_close(got, want)
