"""Port parity: the identity (multi-class) ops, targets and heads against the
JAX package.

- ``inference/identity.py`` (host numpy and scipy, copied): the same
  inputs, made from a numpy seed, give exactly the same indices, points
  and probabilities, with tied class probabilities, peaks given out of
  scan order and NaN rows among the cases.
- ``data/identity.py``: class vectors and class maps within 1e-6 absolute
  of the JAX package's jnp (the same f32 ``exp`` arguments).
- The heads: ``ClassMapsHead`` and ``ClassVectorsHead`` (``global_pool``
  on and off, 1 and 2 dense layers) on a narrow UNet, the flax params
  loaded through ``weights.py`` with ``strict=True``: outputs within
  1e-5 absolute (the f32 forward tolerance of ``tests/test_torch_unet.py``);
  the port's ``state_dict`` goes back through the JAX package's
  ``torch_models.py`` importer to the same flax params, leaf for leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.data import identity as jdata
from sleap_nn_tpu.inference import identity as jid
from sleap_nn_tpu.models.model import Model as FlaxModel
from sleap_nn_tpu.torch_models import torch_state_to_flax
from sleap_nn_tpu_torch.config.model_config import UNetConfig
from sleap_nn_tpu_torch.data import identity as pdata
from sleap_nn_tpu_torch.inference import identity as pid
from sleap_nn_tpu_torch.models.heads import ClassVectorsHeadLayer
from sleap_nn_tpu_torch.models.model import Model
from sleap_nn_tpu_torch.weights import flax_path_for, flax_to_torch_state


def _peaks(rng, n_samples=3, n_channels=4, n_classes=3, per=5, ties=False, nan_rows=0,
           nan_points=0):
    """Random peaks over (sample, channel), shuffled out of scan order, with
    their class probabilities; ``ties`` quantizes the probabilities to a
    few levels so that rows tie; ``nan_rows`` rows get NaN probabilities,
    ``nan_points`` rows NaN points."""
    n = n_samples * n_channels * per
    sample = rng.integers(0, n_samples, n)
    channel = rng.integers(0, n_channels, n)
    rough = rng.integers(0, 40, (n, 2)).astype(np.float32)
    points = rough + rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32)
    vals = rng.random(n).astype(np.float32)
    probs = rng.random((n, n_classes)).astype(np.float32)
    if ties:
        probs = np.round(probs * 2) / 2
    probs[rng.choice(n, nan_rows, replace=False)] = np.nan
    points[rng.choice(n, nan_points, replace=False)] = np.nan
    return points, rough, vals, sample, channel, probs


@pytest.mark.parametrize("seed,ties,nan_rows", [(0, False, 0), (1, True, 0), (2, True, 3),
                                                (3, False, 2), (4, True, 0)])
def test_group_class_peaks_exact(seed, ties, nan_rows):
    rng = np.random.default_rng(seed)
    _, _, _, sample, channel, probs = _peaks(rng, ties=ties, nan_rows=nan_rows)
    if nan_rows:  # scipy refuses a NaN cost in either package
        with pytest.raises(ValueError) as jerr:
            jid.group_class_peaks(probs, sample, channel, 3, 4)
        with pytest.raises(ValueError) as perr:
            pid.group_class_peaks(probs, sample, channel, 3, 4)
        assert str(perr.value) == str(jerr.value)
        return
    want = jid.group_class_peaks(probs, sample, channel, 3, 4)
    got = pid.group_class_peaks(probs, sample, channel, 3, 4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(want[0]) > 0


def test_group_class_peaks_without_peaks():
    empty = np.zeros((0, 3), np.float32)
    none = np.zeros(0, np.int64)
    for g, w in zip(pid.group_class_peaks(empty, none, none, 2, 2),
                    jid.group_class_peaks(empty, none, none, 2, 2)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed,ties,nan_points,keys", [
    (0, False, 0, False), (1, True, 0, True), (2, True, 2, True), (5, True, 0, False),
    (6, False, 3, False)])
def test_group_and_assemble_exact(seed, ties, nan_points, keys):
    rng = np.random.default_rng(seed)
    points, rough, vals, sample, channel, probs = _peaks(rng, ties=ties, nan_points=nan_points)
    args = (points, vals, sample, channel, probs, 3, 3, 4)
    kw = {"sort_keys": rough} if keys else {}
    want = jid.group_and_assemble(*args, **kw)
    got = pid.group_and_assemble(*args, **kw)
    _assert_same(got, want)
    assert np.isfinite(want[0]).any()


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (7, True)])
def test_classify_peaks_from_maps_exact(seed, ties):
    """Peaks read the class maps at rounded (half to even: .5 positions
    included), clipped positions; tied maps leave the order to decide."""
    rng = np.random.default_rng(seed)
    maps = rng.random((3, 20, 24, 3)).astype(np.float32)
    if ties:
        maps = np.round(maps * 2) / 2
    points, rough, vals, sample, channel, _ = _peaks(rng)
    points = points / 2 - 1  # some off the map, clipped
    points[::7] = np.floor(points[::7]) + 0.5  # exact halves
    args = (maps, points, vals, sample, channel, 4)
    for kw in ({}, {"sort_keys": rough}):
        _assert_same(pid.classify_peaks_from_maps(*args, **kw),
                     jid.classify_peaks_from_maps(*args, **kw))


@pytest.mark.parametrize("seed,shape,ties,nan_rows", [
    (0, (4, 6), False, 0), (1, (6, 4), True, 0), (2, (5, 5), True, 2), (3, (1, 3), False, 0),
    (4, (3, 3), False, 1)])
def test_get_class_inds_from_vectors_exact(seed, shape, ties, nan_rows):
    rng = np.random.default_rng(seed)
    probs = rng.random(shape).astype(np.float32)
    if ties:
        probs = np.round(probs * 2) / 2
    probs[rng.choice(shape[0], nan_rows, replace=False)] = np.nan
    _assert_same(pid.get_class_inds_from_vectors(probs), jid.get_class_inds_from_vectors(probs))


# --- targets -------------------------------------------------------------------


def _class_inds(rng, b, n_inst, n_classes):
    inds = np.stack([rng.permutation(n_classes)[:n_inst] for _ in range(b)]).astype(np.int32)
    inds[rng.random(inds.shape) < 0.25] = -1
    return inds


@pytest.mark.parametrize("n_classes", [1, 3, 5])
def test_make_class_vectors(n_classes):
    rng = np.random.default_rng(n_classes)
    inds = _class_inds(rng, 6, min(n_classes, 3), n_classes)
    want = np.asarray(jdata.make_class_vectors(jnp.asarray(inds), n_classes))
    got = pdata.make_class_vectors(torch.from_numpy(inds), n_classes)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (got.sum(-1).numpy() == (inds >= 0)).all()


def _instances(rng, b, n_inst, n_nodes, hw):
    pts = rng.uniform(-2, max(hw) + 2, (b, n_inst, n_nodes, 2)).astype(np.float32)
    pts[rng.random(pts.shape[:3]) < 0.2] = np.nan
    pts[0, -1] = np.nan  # a padded instance
    return pts


@pytest.mark.parametrize("threshold", [0.2, 0.5])
def test_make_class_maps(threshold):
    rng = np.random.default_rng(3)
    cms = rng.random((2, 3, 10, 12, 4)).astype(np.float32)
    inds = _class_inds(rng, 2, 3, 4)
    want = np.asarray(jdata.make_class_maps(jnp.asarray(cms), jnp.asarray(inds), 4, threshold))
    got = pdata.make_class_maps(torch.from_numpy(cms), torch.from_numpy(inds), 4, threshold)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert want.max() > 0.5


@pytest.mark.parametrize("hw,sigma,stride", [((32, 40), 5.0, 2), ((24, 24), 2.5, 4),
                                             ((30, 18), 3.0, 1)])
def test_generate_class_maps(hw, sigma, stride):
    rng = np.random.default_rng(int(sigma * 10))
    pts = _instances(rng, 3, 3, 4, hw)
    inds = _class_inds(rng, 3, 3, 3)
    want = np.asarray(jdata.generate_class_maps(jnp.asarray(pts), hw, jnp.asarray(inds), 3,
                                                sigma=sigma, output_stride=stride))
    got = pdata.generate_class_maps(torch.from_numpy(pts), hw, torch.from_numpy(inds), 3,
                                    sigma=sigma, output_stride=stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert want.max() > 0.5


# --- heads ---------------------------------------------------------------------


HW = 32
UNET = UNetConfig(in_channels=1, filters=8, filters_rate=1.5, max_stride=8, output_stride=2)
PARTS = ["n0", "n1", "n2"]
CLASSES = ["a", "b", "c", "d"]


def _heads(model_type, global_pool=True, fc_layers=1):
    if model_type == "multi_class_bottomup":
        return {"confmaps": {"part_names": PARTS, "sigma": 2.5, "output_stride": 2},
                "class_maps": {"classes": CLASSES, "sigma": 5.0, "output_stride": 4}}
    return {"confmaps": {"part_names": PARTS, "sigma": 2.5, "output_stride": 2},
            "class_vectors": {"classes": CLASSES, "num_fc_layers": fc_layers,
                              "num_fc_units": 16, "global_pool": global_pool}}


HEAD_CASES = [("multi_class_bottomup", True, 1), ("multi_class_topdown", True, 1),
              ("multi_class_topdown", True, 2), ("multi_class_topdown", False, 1),
              ("multi_class_topdown", False, 2)]


def _pair(model_type, global_pool, fc_layers, seed=0):
    heads = _heads(model_type, global_pool, fc_layers)
    fmodel = FlaxModel.from_config("unet", UNET, heads, model_type)
    params = fmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, HW, HW, 1), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = Model.from_config("unet", UNET, heads, model_type, input_hw=(HW, HW))
    tmodel.load_state_dict(flax_to_torch_state(params, tmodel), strict=True)
    return fmodel, params, tmodel


@pytest.mark.parametrize("model_type,global_pool,fc_layers", HEAD_CASES)
def test_heads_match_jax(model_type, global_pool, fc_layers):
    fmodel, params, tmodel = _pair(model_type, global_pool, fc_layers)
    x = np.random.default_rng(1).random((3, HW, HW, 1)).astype(np.float32)
    want = fmodel.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert set(got) == set(want) == {h.name for h in tmodel.heads}
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-5, err_msg=k)
    if model_type == "multi_class_topdown":
        probs = got["ClassVectorsHead"].numpy()
        assert probs.shape == (3, len(CLASSES))
        np.testing.assert_allclose(probs.sum(-1), 1, atol=1e-6)
    else:
        assert got["ClassMapsHead"].shape == (3, HW // 4, HW // 4, len(CLASSES))
        assert 0 < got["ClassMapsHead"].min() and got["ClassMapsHead"].max() < 1


@pytest.mark.parametrize("model_type,global_pool,fc_layers", HEAD_CASES)
def test_class_head_keys_round_trip_through_the_jax_importer(model_type, global_pool,
                                                            fc_layers):
    _, params, tmodel = _pair(model_type, global_pool, fc_layers, seed=2)
    state = {f"model.{k}": v.numpy() for k, v in tmodel.state_dict().items()}
    if model_type == "multi_class_topdown":
        keys = {k for k in state if k.startswith("model.head_layers.1.")}
        assert keys == {f"model.head_layers.1.{n}.{leaf}" for leaf in ("weight", "bias")
                        for n in [f"pre_classification{j}_fc" for j in range(fc_layers)]
                        + ["ClassVectorsHead"]}
        assert flax_path_for("head_layers.1.ClassVectorsHead.weight") == (
            ("ClassVectorsHead", "logits", "kernel"), "dense_kernel")
    back = torch_state_to_flax(state, params)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert flat_back.keys() == flat_want.keys()
    for path, leaf in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf, err_msg=str(path))


def test_class_vectors_flatten_in_nhwc_order():
    """Without ``global_pool`` the dense input is the feature flattened in
    (H, W, C) order: a weight that picks one (y, x, c) entry reads it."""
    layer = ClassVectorsHeadLayer(2 * 3 * 4, 2, num_fc_layers=0, global_pool=False)
    x = torch.zeros(1, 2, 3, 4)
    x[0, 1, 2, 3] = 5.0
    with torch.no_grad():
        layer["ClassVectorsHead"].weight.zero_()
        layer["ClassVectorsHead"].bias.zero_()
        layer["ClassVectorsHead"].weight[0, (1 * 3 + 2) * 4 + 3] = 1.0
    probs = layer(x)
    torch.testing.assert_close(probs, torch.softmax(torch.tensor([[5.0, 0.0]]), -1))


def test_flat_class_vectors_need_the_input_size():
    with pytest.raises(ValueError, match="input_hw"):
        Model.from_config("unet", UNET, _heads("multi_class_topdown", False),
                          "multi_class_topdown")
