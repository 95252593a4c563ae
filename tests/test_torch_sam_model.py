"""The port's SAM graph (``sleap_nn_tpu_torch/models/sam_jax.py``) against
the JAX package's (``sleap_nn_tpu/models/sam_jax.py``) on the CPU.

Weights are drawn from a seed with numpy in the flat upstream keys and
PyTorch layouts, imported by the JAX ``convert_sam_state_dict`` and carried
to the port by ``weights.sam_params_to_torch``, at the tiny arch of the JAX
package's own SAM tests (hidden 32, 3 layers, one global, window 2, grid 4).
The relative-position tables and ``pos_embed`` are drawn nonzero, so those
paths count.

Tolerances, float32: encoder embeddings 1e-5 absolute, mask logits and IoU
scores 1e-4 absolute (the products run in another order in each package).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.models import sam_jax as jsam
from sleap_nn_tpu_torch.models import sam_jax as psam
from sleap_nn_tpu_torch.weights import sam_params_to_torch
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

EMB_TOL = 1e-5
LOGIT_TOL = 1e-4

TINY_HF = dict(
    vision_config=dict(hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
                       image_size=32, patch_size=8, window_size=2, global_attn_indexes=[1],
                       mlp_dim=64, output_channels=16, num_pos_feats=8),
    prompt_encoder_config=dict(hidden_size=16, image_size=32, patch_size=8,
                               image_embedding_size=4, mask_input_channels=8),
    mask_decoder_config=dict(hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                             mlp_dim=32, iou_head_hidden_dim=16),
)


# Embedding and token tables (std 1); every other weight of 2 or more
# dimensions is a linear or conv kernel.
EMBEDDINGS = ("point_embed.", "no_mask_embed.", "iou_token.", "mask_tokens.",
              "positional_embedding")


def seeded_state(arch, seed=0):
    """Upstream-keyed float32 arrays in PyTorch layouts, from ``seed``:
    weights of std fan_in^-0.5, norms near 1, biases and tables of 0.1-0.5."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, ref in psam.SamModel(arch).state_dict().items():
        shape = tuple(ref.shape)
        if "layer_norm" in key and key.endswith(".weight"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif key.endswith(".bias"):
            v = 0.1 * rng.standard_normal(shape)
        elif "rel_pos" in key or key.endswith("pos_embed"):
            v = 0.5 * rng.standard_normal(shape)
        elif len(shape) >= 2 and not any(m in key for m in EMBEDDINGS):
            fan_in = int(np.prod(shape[1:])) if "upscale" not in key else shape[0]
            v = rng.standard_normal(shape) * fan_in ** -0.5
        else:  # embeddings, tokens, the Fourier table
            v = rng.standard_normal(shape)
        out[key] = v.astype(np.float32)
    out["prompt_encoder.shared_embedding.positional_embedding"] = \
        out["shared_image_embedding.positional_embedding"]
    return out


@pytest.fixture(scope="module")
def pair():
    arch = psam.SamArch.from_hf_config(TINY_HF)
    state = seeded_state(arch)
    jparams = jsam.convert_sam_state_dict(state)
    jarch = jsam.SamArch.from_hf_config(TINY_HF)
    model = psam.SamModel(arch)
    model.load_state_dict(sam_params_to_torch(jparams), strict=True)
    return arch, jarch, jparams, model.eval()


def image(seed, b=1, size=32):
    return np.random.default_rng(seed).normal(size=(b, size, size, 3)).astype(np.float32)


def port_predict(model, arch, img, **prompts):
    with torch.inference_mode():
        masks, iou = psam.sam_predict(
            model, arch, torch.from_numpy(img),
            **{k: torch.from_numpy(v) for k, v in prompts.items() if k != "multimask_output"},
            multimask_output=prompts.get("multimask_output", True))
    return masks.numpy(), iou.numpy()


def jax_predict(jparams, jarch, img, **prompts):
    mm = prompts.pop("multimask_output", True)
    fn = jax.jit(lambda p, x, kw: jsam.sam_predict(p, jarch, x, multimask_output=mm, **kw))
    masks, iou = fn(jparams, jnp.asarray(img), {k: jnp.asarray(v) for k, v in prompts.items()})
    return np.asarray(masks), np.asarray(iou)


def test_arch_from_hf_config_matches_jax():
    SamConfig = pytest.importorskip("transformers").SamConfig

    for cfg in (TINY_HF, SamConfig(**TINY_HF)):
        got, want = psam.SamArch.from_hf_config(cfg), jsam.SamArch.from_hf_config(cfg)
        assert got.__dict__ == want.__dict__
    assert psam.SamArch().__dict__ == jsam.SamArch().__dict__


def test_image_encoder_parity(pair):
    arch, jarch, jparams, model = pair
    img = image(1, b=2)
    with torch.inference_mode():
        got = psam.sam_image_encoder(model, arch, torch.from_numpy(img)).numpy()
    want = np.asarray(jax.jit(lambda p, x: jsam.sam_image_encoder(p, jarch, x))(
        jparams, jnp.asarray(img)))
    assert got.shape == (2, 4, 4, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=EMB_TOL)


@pytest.mark.parametrize("hw,ws", [((5, 7), 3), ((4, 4), 2), ((6, 9), 4)])
def test_window_partition_pads_and_crops(hw, ws):
    x = np.random.default_rng(0).normal(size=(2, *hw, 3)).astype(np.float32)
    wins, padded = psam._window_partition(torch.from_numpy(x), ws)
    jwins, jpadded = jsam._window_partition(jnp.asarray(x), ws)
    assert padded == jpadded
    np.testing.assert_array_equal(wins.numpy(), np.asarray(jwins))
    back = psam._window_unpartition(wins, ws, padded, hw)
    np.testing.assert_array_equal(back.numpy(), x)


def test_encoder_with_padded_windows(pair):
    """A window of 3 on the 4x4 grid: windows zero-padded after layer_norm1,
    padded tokens taking part in the attention, cropped away after."""
    arch, jarch, jparams, _ = pair
    arch3 = psam.SamArch(**{**arch.__dict__, "window_size": 3})
    jarch3 = jsam.SamArch(**{**jarch.__dict__, "window_size": 3})
    state = seeded_state(arch3, seed=4)
    jp = jsam.convert_sam_state_dict(state)
    model = psam.SamModel(arch3)
    model.load_state_dict(sam_params_to_torch(jp), strict=True)
    img = image(2)
    with torch.inference_mode():
        got = psam.sam_image_encoder(model, arch3, torch.from_numpy(img)).numpy()
    want = np.asarray(jax.jit(lambda p, x: jsam.sam_image_encoder(p, jarch3, x))(
        jp, jnp.asarray(img)))
    np.testing.assert_allclose(got, want, rtol=0, atol=EMB_TOL)


@pytest.mark.parametrize("n_table,q,k", [(7, 4, 4), (5, 4, 4), (11, 4, 4), (27, 14, 14),
                                         (9, 3, 6), (13, 6, 3), (127, 40, 40)])
def test_rel_pos_resampled_off_its_grid(n_table, q, k):
    """Off the pretrain grid the table is resampled as jax.image.resize's
    "linear" does: antialiased when it shrinks (11 -> 7), plain linear when
    it grows (5 -> 7)."""
    table = np.random.default_rng(n_table).normal(size=(n_table, 6)).astype(np.float32)
    got = psam._get_rel_pos(torch.from_numpy(table), q, k).numpy()
    want = np.asarray(jsam._get_rel_pos(jnp.asarray(table), q, k))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_encoder_with_resampled_tables(pair):
    """The whole encoder with every table off its grid (global 7 -> 5 and
    11 rows, windows 3 -> 5 rows)."""
    arch, jarch, jparams, _ = pair
    rng = np.random.default_rng(8)
    jp = dict(jparams)
    for i in range(arch.num_hidden_layers):
        n = {0: 5, 1: 11, 2: 5}[i]
        for ax in ("h", "w"):
            jp[f"vision_encoder.layers.{i}.attn.rel_pos_{ax}"] = jnp.asarray(
                rng.normal(size=(n, 16)).astype(np.float32))
    model = psam.SamModel(arch)
    state = sam_params_to_torch(jp)
    for i in range(arch.num_hidden_layers):
        attn = model.vision_encoder.layers[i].attn
        for ax in ("h", "w"):
            table = state[f"vision_encoder.layers.{i}.attn.rel_pos_{ax}"]
            setattr(attn, f"rel_pos_{ax}", torch.nn.Parameter(torch.empty_like(table)))
    model.load_state_dict(state, strict=True)
    img = image(3)
    with torch.inference_mode():
        got = psam.sam_image_encoder(model, arch, torch.from_numpy(img)).numpy()
    want = np.asarray(jax.jit(lambda p, x: jsam.sam_image_encoder(p, jarch, x))(
        jp, jnp.asarray(img)))
    np.testing.assert_allclose(got, want, rtol=0, atol=EMB_TOL)


PROMPTS = {
    "points": dict(input_points=np.array([[[[8.0, 20.0], [25.0, 5.0]]]], np.float32),
                   input_labels=np.array([[[1, 0]]], np.int32)),
    "box": dict(input_boxes=np.array([[[4.0, 6.0, 28.0, 30.0]]], np.float32)),
    "points_and_box": dict(input_points=np.array([[[[10.0, 10.0]]]], np.float32),
                           input_labels=np.array([[[1]]], np.int32),
                           input_boxes=np.array([[[2.0, 2.0, 30.0, 30.0]]], np.float32)),
    # Three prompts padded to 2 points each with -10 ("processor padding").
    "multi_prompt_padded": dict(
        input_points=np.array([[[[8.0, 20.0], [25.0, 5.0]], [[16.0, 16.0], [0.0, 0.0]],
                                [[4.0, 28.0], [0.0, 0.0]]]], np.float32),
        input_labels=np.array([[[1, 1], [1, -10], [0, -10]]], np.int32)),
    "multi_prompt_boxes": dict(
        input_points=np.array([[[[8.0, 20.0], [0.0, 0.0]], [[16.0, 16.0], [3.0, 9.0]]]],
                              np.float32),
        input_labels=np.array([[[1, -10], [1, 1]]], np.int32),
        input_boxes=np.array([[[1.0, 2.0, 20.0, 30.0], [5.0, 5.0, 31.0, 25.0]]], np.float32)),
    "labels_default": dict(input_points=np.array([[[[12.0, 12.0]]]], np.float32)),
}


@pytest.mark.parametrize("name", sorted(PROMPTS))
@pytest.mark.parametrize("multimask", [True, False])
def test_predict_parity(pair, name, multimask):
    arch, jarch, jparams, model = pair
    img = image(5 + len(name))
    got_m, got_i = port_predict(model, arch, img, **PROMPTS[name], multimask_output=multimask)
    want_m, want_i = jax_predict(jparams, jarch, img, **PROMPTS[name],
                                 multimask_output=multimask)
    k = 3 if multimask else 1
    n_prompts = next(iter(PROMPTS[name].values())).shape[1]
    assert got_m.shape == want_m.shape == (1, n_prompts, k, 16, 16)
    assert got_i.shape == want_i.shape == (1, n_prompts, k)
    np.testing.assert_allclose(got_m, want_m, rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(got_i, want_i, rtol=0, atol=LOGIT_TOL)


def test_decode_from_cached_embeddings(pair):
    """sam_decode against embeddings computed once == the full forward, in
    the port, and == the JAX sam_decode on the JAX embeddings."""
    arch, jarch, jparams, model = pair
    img = image(6)
    pts = PROMPTS["multi_prompt_padded"]
    with torch.inference_mode():
        emb = psam.sam_image_encoder(model, arch, torch.from_numpy(img))
        m1, i1 = psam.sam_decode(model, arch, emb, **{k: torch.from_numpy(v)
                                                      for k, v in pts.items()})
    m2, i2 = port_predict(model, arch, img, **pts)
    np.testing.assert_array_equal(m1.numpy(), m2)
    np.testing.assert_array_equal(i1.numpy(), i2)
    jemb = jsam.sam_image_encoder(jparams, jarch, jnp.asarray(img))
    jm, ji = jsam.sam_decode(jparams, jarch, jemb, **{k: jnp.asarray(v) for k, v in pts.items()})
    np.testing.assert_allclose(m1.numpy(), np.asarray(jm), rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(i1.numpy(), np.asarray(ji), rtol=0, atol=LOGIT_TOL)


def test_prompt_encoder_and_grid_embedding_parity(pair):
    arch, jarch, jparams, model = pair
    p = PROMPTS["multi_prompt_boxes"]
    for pad_box in (True, False):
        kw = dict(p) if pad_box else {k: v for k, v in p.items() if k != "input_boxes"}
        with torch.inference_mode():
            sparse, dense = psam.sam_prompt_encoder(
                model, arch, torch.from_numpy(kw["input_points"]),
                torch.from_numpy(kw["input_labels"]),
                torch.from_numpy(kw["input_boxes"]) if pad_box else None, batch_size=1)
        js, jd = jsam.sam_prompt_encoder(
            jparams, jarch, jnp.asarray(kw["input_points"]), jnp.asarray(kw["input_labels"]),
            jnp.asarray(kw["input_boxes"]) if pad_box else None, batch_size=1)
        # Without a box a "not a point" pad is appended: 2 + 1 tokens; with
        # boxes 2 points + 2 corners.
        assert sparse.shape == js.shape == (1, 2, 4 if pad_box else 3, 16)
        np.testing.assert_allclose(sparse.numpy(), np.asarray(js), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(dense.detach().numpy(), np.asarray(jd))
    with torch.inference_mode():
        grid = psam.image_grid_positional_embedding(model, arch).numpy()
    np.testing.assert_allclose(grid, np.asarray(jsam.image_grid_positional_embedding(
        jparams, jarch)), rtol=0, atol=1e-5)


def test_state_dict_matches_transformers():
    """The port's keys and shapes are transformers' SamModel's, so a real
    snapshot loads with strict=True; its weights give the same logits."""
    SamConfig = pytest.importorskip("transformers").SamConfig
    from transformers.models.sam.modeling_sam import SamModel as HFSamModel

    config = SamConfig(**TINY_HF)
    torch.manual_seed(0)
    hf = HFSamModel(config).eval()
    arch = psam.SamArch.from_hf_config(config)
    ours = psam.SamModel(arch)
    want = {k: tuple(v.shape) for k, v in hf.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in ours.state_dict().items()}
    assert got == want
    with torch.no_grad():
        for layer in hf.vision_encoder.layers:
            layer.attn.rel_pos_h.normal_(std=0.5)
            layer.attn.rel_pos_w.normal_(std=0.5)
        hf.vision_encoder.pos_embed.normal_(std=0.5)
    state = {k: v for k, v in hf.state_dict().items()
             if k not in psam.TIED_KEYS}  # a snapshot may store the tied table once
    model = psam.SamModel.from_state_dict(arch, state)
    img = image(9)
    pts, labs = PROMPTS["multi_prompt_padded"].values()
    with torch.no_grad():
        ref = hf(pixel_values=torch.from_numpy(img.transpose(0, 3, 1, 2)),
                 input_points=torch.from_numpy(pts), input_labels=torch.from_numpy(labs).long(),
                 multimask_output=True)
    got_m, got_i = port_predict(model, arch, img, input_points=pts, input_labels=labs)
    np.testing.assert_allclose(got_m, ref.pred_masks.numpy(), rtol=0, atol=2e-3)
    np.testing.assert_allclose(got_i, ref.iou_scores.numpy(), rtol=0, atol=1e-3)


def test_sam_params_to_torch_inverts_the_jax_import(pair):
    arch = pair[0]
    state = seeded_state(arch, seed=3)
    back = sam_params_to_torch(jsam.convert_sam_state_dict(state))
    assert set(back) == set(state)
    for k, v in state.items():
        assert np.array_equal(back[k].numpy(), v), k


def test_bf16_graph_tracks_f32(pair):
    """The model cast to bfloat16 (softmax in float32, cast back) keeps its
    IoU scores within 0.1 of float32's and its logits' signs off only near
    0 (a bf16 bound: |logit| > 0.5 agrees)."""
    arch, _, _, model = pair
    img = image(11)
    pts = PROMPTS["multi_prompt_padded"]
    m32, i32 = port_predict(model, arch, img, **pts)
    bf = psam.SamModel(arch)
    bf.load_state_dict(model.state_dict())
    bf = bf.to(torch.bfloat16).eval()
    with torch.inference_mode():
        m16, i16 = psam.sam_predict(
            bf, arch, torch.from_numpy(img).bfloat16(),
            torch.from_numpy(pts["input_points"]).bfloat16(), torch.from_numpy(pts["input_labels"]))
    m16, i16 = m16.float().numpy(), i16.float().numpy()
    assert np.abs(i16 - i32).max() <= 0.1
    firm = np.abs(m32) > 0.5
    assert np.array_equal(m16[firm] > 0, m32[firm] > 0)
