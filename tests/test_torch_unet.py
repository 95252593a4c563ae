"""Port parity: UNet + heads (sleap_nn_tpu_torch.models) against flax.

Both frameworks run the same random weights (drawn with numpy) on the
same numpy inputs on the CPU. The flax params reach the port through
``sleap_nn_tpu_torch.weights``; the JAX package's own checkpoint importer
maps the port's ``state_dict`` back onto the identical flax tree.
Tolerance: 1e-4 absolute on outputs of magnitude ~1 (f32 convs summed in
another order).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.models.model import Model as FlaxModel
from sleap_nn_tpu.torch_models import torch_state_to_flax
from sleap_nn_tpu_torch.inference.backends import TorchBackend
from sleap_nn_tpu_torch.models.model import Model
from sleap_nn_tpu_torch.weights import flax_to_torch_state

ns = types.SimpleNamespace


def _heads(model_type, output_stride, n_nodes=3):
    if model_type == "centroid":
        return ns(confmaps=ns(anchor_part=None, sigma=5.0, output_stride=output_stride,
                              loss_weight=None))
    return ns(confmaps=ns(part_names=[f"n{i}" for i in range(n_nodes)], anchor_part=None,
                          sigma=3.0, output_stride=output_stride, loss_weight=None))


def _unet_cfg(**kw):
    from sleap_nn_tpu_torch.config.model_config import UNetConfig

    base = dict(in_channels=1, filters=4, filters_rate=1.5, max_stride=8, output_stride=2)
    base.update(kw)
    return UNetConfig(**base)


def build_pair(model_type, seed=0, input_hw=(24, 32), **cfg_kw):
    """Flax model + randomized params and the port model loaded with them."""
    cfg = _unet_cfg(**cfg_kw)
    heads = _heads(model_type, cfg.output_stride)
    fmodel = FlaxModel.from_config("unet", cfg, heads, model_type)
    params = fmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1,) + input_hw + (cfg.in_channels,), jnp.float32))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: (0.3 * rng.standard_normal(p.shape)).astype(np.float32), params)
    tmodel = Model.from_config("unet", cfg, heads, model_type)
    tmodel.load_state_dict(flax_to_torch_state(params, tmodel), strict=True)
    return fmodel, params, tmodel


CASES = [
    ("centroid", dict()),
    ("centered_instance", dict()),
    ("centroid", dict(up_interpolate=False)),
    ("centered_instance", dict(up_interpolate=False)),
    ("centered_instance", dict(up_interpolate=False, trans_conv_phase="tf")),
    ("centroid", dict(stem_stride=2, max_stride=16, output_stride=4)),
    ("centroid", dict(middle_block=False, convs_per_block=1)),
]


@pytest.mark.parametrize("model_type,cfg_kw", CASES)
def test_model_outputs_match_flax(model_type, cfg_kw):
    fmodel, params, tmodel = build_pair(model_type, **cfg_kw)
    x = np.random.default_rng(1).random((2, 24, 32, 1), dtype=np.float32)
    want = fmodel.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_backend_odd_sizes_and_fused_twin(fused):
    """Odd spatial sizes exercise the SAME pool pad and the skip resize; the
    fused blocks' plain twin must compute the same function on the CPU."""
    fmodel, params, tmodel = build_pair("centered_instance", input_hw=(21, 27))
    x = np.random.default_rng(2).random((1, 21, 27, 1), dtype=np.float32)
    want = fmodel.apply(params, jnp.asarray(x))
    backend = TorchBackend(tmodel, None, fused_convs=fused, device="cpu")
    got = backend(torch.from_numpy(x))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("model_type,cfg_kw", CASES)
def test_state_dict_maps_back_to_flax_tree(model_type, cfg_kw):
    """The port's keys carry reference block names: the JAX package's own
    torch-checkpoint importer rebuilds the exact flax tree from them."""
    _, params, tmodel = build_pair(model_type, **cfg_kw)
    state = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    back = torch_state_to_flax(state, jax.tree_util.tree_map(np.asarray, params))
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_b[path]))


def test_reference_block_names_in_keys():
    tmodel = Model.from_config("unet", _unet_cfg(max_stride=32, filters=2),
                               _heads("centroid", 2), "centroid")
    keys = set(tmodel.state_dict())
    assert "backbone.encoders.0.encoder_stack.0.blocks.stack0_enc0_conv0.weight" in keys
    assert "backbone.middle_blocks.0.blocks.stack0_enc5_middle_expand_conv0.weight" in keys
    assert "backbone.decoders.0.decoder_stack.0.blocks.stack0_dec0_s32_to_s16_refine_conv0.weight" in keys
    assert "head_layers.0.CentroidConfmapsHead.0.weight" in keys


def test_backend_bf16_and_output_dtype():
    """use_bf16 casts input and weights; output_dtype=None keeps bf16."""
    _, _, tmodel = build_pair("centroid")
    x = torch.from_numpy(np.random.default_rng(3).random((1, 24, 32, 1), dtype=np.float32))
    keep = TorchBackend(tmodel, None, use_bf16=True, output_dtype=None, device="cpu")(x)
    f32 = TorchBackend(tmodel, None, use_bf16=True, device="cpu")(x)
    assert keep["CentroidConfmapsHead"].dtype == torch.bfloat16
    assert f32["CentroidConfmapsHead"].dtype == torch.float32
    np.testing.assert_array_equal(keep["CentroidConfmapsHead"].float().numpy(),
                                  f32["CentroidConfmapsHead"].numpy())


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tmodel = build_pair("centroid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend(tmodel, None)
