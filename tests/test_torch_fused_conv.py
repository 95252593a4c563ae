"""Port parity: fused double 3x3 conv (sleap_nn_tpu_torch.ops.fused_conv).

The JAX side runs the Pallas kernel in interpret mode and its plain XLA
path; the port side runs the plain PyTorch version that CPU tensors take.
Inputs are drawn with numpy. Tolerances: f32 1e-5 (sums in another
order); bf16 compared in f32 after both round to bf16, to 2 bf16 ulps at
the output's scale (a mid value within an f32 rounding error of a bf16
tie may round the other way and move an output by a fraction of an ulp).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sleap_nn_tpu.ops.fused_conv import _plain_double_conv as jax_plain
from sleap_nn_tpu.ops.fused_conv import fused_double_conv3x3 as jax_fused
from sleap_nn_tpu_torch.ops.fused_conv import _plain_double_conv, fused_double_conv3x3


def _inputs(shape, c_mid, c_out, seed, bias=True):
    rng = np.random.default_rng(seed)
    c_in = shape[3]
    x = rng.standard_normal(shape).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, c_in, c_mid)) * 0.3).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, c_mid, c_out)) * 0.3).astype(np.float32)
    b1 = (rng.standard_normal(c_mid) * 0.1).astype(np.float32) if bias else None
    b2 = (rng.standard_normal(c_out) * 0.1).astype(np.float32) if bias else None
    return x, w1, b1, w2, b2


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize(
    "shape,c_mid,c_out,bias,activation",
    [
        ((2, 7, 9, 1), 4, 3, True, "relu"),      # odd H/W, C_in=1 (enc0-like)
        ((1, 8, 5, 3), 5, 6, True, "relu"),      # odd W, C_in=3
        ((1, 12, 11, 5), 3, 4, False, "relu"),   # odd W, C_in=5, no bias
        ((2, 4, 8, 5), 4, 4, True, "identity"),
    ],
)
def test_plain_matches_jax_f32(shape, c_mid, c_out, bias, activation):
    x, w1, b1, w2, b2 = _inputs(shape, c_mid, c_out, seed=sum(shape), bias=bias)
    got = fused_double_conv3x3(_t(x), _t(w1), _t(b1), _t(w2), _t(b2), activation).numpy()
    plain = jax_plain(_j(x), _j(w1), _j(b1), _j(w2), _j(b2), activation)
    np.testing.assert_allclose(got, np.asarray(plain), atol=1e-5, rtol=1e-5)
    if shape[1] % 4 == 0:  # the Pallas kernel's row strips need H % 4 == 0
        kern = jax_fused(_j(x), _j(w1), _j(b1), _j(w2), _j(b2), activation=activation,
                         interpret=True)
        np.testing.assert_allclose(got, np.asarray(kern), atol=1e-5, rtol=1e-5)


def test_plain_matches_jax_kernel_bf16():
    x, w1, b1, w2, b2 = _inputs((1, 8, 10, 3), 6, 5, seed=11)
    xb = x.astype(ml_dtypes.bfloat16)
    got = fused_double_conv3x3(
        torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16),
        _t(w1), _t(b1), _t(w2), _t(b2)).float().numpy()
    want = np.asarray(jax_fused(jnp.asarray(xb), _j(w1), _j(b1), _j(w2), _j(b2),
                                interpret=True)).astype(np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_array_less(np.abs(got - want), 2 * ulp + 1e-30)


def test_cpu_wrapper_is_the_plain_version():
    x, w1, b1, w2, b2 = _inputs((1, 4, 4, 2), 3, 3, seed=3)
    args = (_t(x), _t(w1), _t(b1), _t(w2), _t(b2))
    torch.testing.assert_close(fused_double_conv3x3(*args), _plain_double_conv(*args),
                               rtol=0, atol=0)


def test_rejects_bad_arguments():
    x, w1, b1, w2, b2 = _inputs((1, 4, 4, 2), 3, 3, seed=4)
    with pytest.raises(ValueError, match="activation"):
        fused_double_conv3x3(_t(x), _t(w1), _t(b1), _t(w2), _t(b2), "sigmoid")
    with pytest.raises(ValueError, match="chain"):
        fused_double_conv3x3(_t(x), _t(w2), _t(b1), _t(w1), _t(b2))


# ---------------------------------------------------------------------------
# The bf16 kernel's tile planner and weight packing (pure Python, no card)
# ---------------------------------------------------------------------------

def _fused_block_channels(cfg_cls):
    """(c_in, c_mid, c_out) of every double-conv block of a UNet preset."""
    from sleap_nn_tpu_torch.models.encoder_decoder import SimpleConvBlock, SimpleUpsamplingBlock
    from sleap_nn_tpu_torch.models.unet import UNet

    model = UNet.from_config(cfg_cls(in_channels=1, output_stride=2))
    out = []
    for mod in model.modules():
        if isinstance(mod, (SimpleConvBlock, SimpleUpsamplingBlock)):
            convs = [c for c in mod.blocks.values() if isinstance(c, torch.nn.Conv2d)]
            if len(convs) >= 2:
                out.append((convs[-2].in_channels, convs[-2].out_channels, convs[-1].out_channels))
    return out


@pytest.mark.parametrize("preset", ["UNetConfig", "UNetMediumRFConfig", "UNetLargeRFConfig"])
def test_tile_plan_fits_every_preset_block(preset):
    from sleap_nn_tpu_torch.config import model_config
    from sleap_nn_tpu_torch.ops.fused_conv import SMEM_LIMIT, plan_tiles, smem_bytes

    blocks = _fused_block_channels(getattr(model_config, preset))
    assert len(blocks) >= 7
    # Smoke sizes (8 frames of 1024^2, 48 crops of 256^2) and published ones
    # (SLEAP's 384 px frames and 160 px crops), at every stride a block meets.
    for bsz, size in ((8, 1024), (48, 256), (4, 384), (32, 160)):
        for stride in (1, 2, 4, 8, 16, 32):
            s = max(size // stride, 1)
            for c_in, c_mid, c_out in blocks:
                plan = plan_tiles(bsz, s, s, c_in, c_mid, c_out)
                assert plan.smem_bytes == smem_bytes(plan.tile_h, plan.tile_w, c_in, c_mid, c_out)
                assert plan.smem_bytes <= SMEM_LIMIT
                assert plan.blocks == bsz * -(-s // plan.tile_h) * -(-s // plan.tile_w) > 0
                assert plan.blocks_per_sm in (1, 2)


@pytest.mark.parametrize(
    "shape,c_mid,c_out",
    [((1, 7, 9, 1), 4, 3), ((2, 13, 21, 5), 24, 24), ((1, 9, 17, 303), 121, 121),
     ((3, 33, 40, 17), 7, 5), ((2, 37, 45, 90), 36, 36), ((1, 29, 35, 135), 54, 54),
     ((2, 19, 23, 81), 121, 121), ((1, 13, 11, 128), 256, 256), ((8, 64, 64, 768), 256, 256)],
)
def test_tile_plan_fits_card_test_shapes(shape, c_mid, c_out):
    from sleap_nn_tpu_torch.ops.fused_conv import SMEM_LIMIT, TILES, plan_tiles

    plan = plan_tiles(*shape, c_mid, c_out)
    assert (plan.tile_h, plan.tile_w) in TILES
    assert plan.smem_bytes <= SMEM_LIMIT and plan.blocks > 0


def test_tile_plan_refuses_what_fits_no_tile():
    from sleap_nn_tpu_torch.ops.fused_conv import plan_tiles

    with pytest.raises(ValueError, match="no tile fits"):
        plan_tiles(1, 64, 64, 4096, 1024, 1024)


def _unpack(frag, c_in, c_out):
    """The (K, N) matrix an mma.m16n8k16 B fragment holds, lane by lane."""
    ks, n_tiles = frag.shape[:2]
    k = torch.zeros(16 * ks, 8 * n_tiles)
    for lane in range(32):
        for j in range(4):
            row = (lane % 4) * 2 + j % 2 + 8 * (j // 2)
            for s in range(ks):
                for t in range(n_tiles):
                    k[16 * s + row, 8 * t + lane // 4] = frag[s, t, lane, j].float()
    return k


@pytest.mark.parametrize("c_in,c_out", [(1, 24), (3, 5), (24, 36), (36, 54), (17, 7)])
def test_pack_weight_gives_the_rounded_weights_back(c_in, c_out):
    from sleap_nn_tpu_torch.ops.fused_conv import pack_weight

    w = torch.from_numpy(np.random.default_rng(c_in).standard_normal(
        (3, 3, c_in, c_out)).astype(np.float32))
    frag = pack_weight(w)
    assert frag.dtype == torch.bfloat16 and frag.shape[1:] == (-(-c_out // 8), 32, 4)
    k = _unpack(frag, c_in, c_out)
    rounded = w.to(torch.bfloat16).float()
    if c_in == 1:  # the 9 taps form K, padded to 16
        assert k.shape[0] == 16
        torch.testing.assert_close(k[:9, :c_out], rounded.reshape(9, c_out), rtol=0, atol=0)
        assert not k[9:].any()
    else:  # K = (tap, channel padded to 8), padded to 16
        c_pad = -(-c_in // 8) * 8
        assert k.shape[0] == -(-9 * c_pad // 16) * 16
        body = k[:9 * c_pad].reshape(9, c_pad, -1)
        torch.testing.assert_close(body[:, :c_in, :c_out], rounded.reshape(9, c_in, c_out),
                                   rtol=0, atol=0)
        assert not body[:, c_in:].any() and not k[9 * c_pad:].any()
    assert not k[:, c_out:].any()


def test_packed_weights_are_reused_until_they_change():
    from sleap_nn_tpu_torch.models.encoder_decoder import hwio
    from sleap_nn_tpu_torch.ops.fused_conv import _packed

    conv = torch.nn.Conv2d(4, 6, 3)
    first = _packed(hwio(conv.weight), conv.bias, torch.bfloat16)
    assert _packed(hwio(conv.weight), conv.bias, torch.bfloat16) is first
    assert _packed(hwio(conv.weight), conv.bias, torch.float32) is not first
    with torch.no_grad():
        conv.bias.add_(1.0)
    again = _packed(hwio(conv.weight), conv.bias, torch.bfloat16)
    assert again is not first
    torch.testing.assert_close(again[1][:6], conv.bias.detach(), rtol=0, atol=0)
    assert not again[1][6:].any()
    with torch.no_grad():
        conv.weight.mul_(2.0)
    assert _packed(hwio(conv.weight), conv.bias, torch.bfloat16) is not again
