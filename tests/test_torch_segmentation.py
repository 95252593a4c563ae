"""Port parity: segmentation inference (``inference/segmentation.py``) and
its training targets (``data/segmentation_maps.py``) against the JAX
package.

Helpers, the fragment merge and the renders get seeded numpy inputs. The
three layers run the JAX package's and the port's on the same frames with
the same weights (flax init carried over by ``weights.py``): UNet filters
4, max stride 8, 64x64 frames that are black but for bright Gaussian
blobs, so that away from the blobs every feature is exactly 0 (a
foreground logit of exactly 0, a centre heatmap and offsets of exactly 0)
in both frameworks; the head kernels are scaled so the centre heatmap
peaks near 1, offsets reach a few pixels and foreground logits move well
away from 0.

Tolerances: integer outputs (centre validity, grid and crop indices) and
polygons exactly; f32 maps to 1e-5; masks exactly but for pixels whose
JAX value lies within 1e-5 of the threshold, counted and reported, at
most 0.1% of the mask (``assert_masks_match``); renders to 1e-6.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.data import segmentation_maps as jsm
from sleap_nn_tpu.inference import layers as jl
from sleap_nn_tpu.inference import segmentation as js
from sleap_nn_tpu.inference.backends import JaxBackend
from sleap_nn_tpu.models.model import Model as FlaxModel
from sleap_nn_tpu_torch.config.model_config import UNetConfig
from sleap_nn_tpu_torch.data import segmentation_maps as psm
from sleap_nn_tpu_torch.inference import layers as tl
from sleap_nn_tpu_torch.inference import segmentation as ps
from sleap_nn_tpu_torch.inference.backends import TorchBackend
from sleap_nn_tpu_torch.models.model import Model
from sleap_nn_tpu_torch.weights import flax_to_torch_state
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

ns = types.SimpleNamespace
HW, CROP = 64, 32
MARGIN, MAX_FRACTION = 1e-5, 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_masks_match(got, want, values=None, threshold=None):
    """Bool masks equal, but for pixels where ``values`` (the JAX package's
    map that was thresholded) lies within ``MARGIN`` of ``threshold``; such
    pixels are counted and must stay under ``MAX_FRACTION`` of the mask."""
    got, want = np.asarray(got, bool), np.asarray(want, bool)
    assert got.shape == want.shape
    diff = got != want
    if values is None:
        assert not diff.any(), int(diff.sum())
        return 0
    near = np.abs(np.asarray(values, np.float64) - threshold) <= MARGIN
    near = np.broadcast_to(near, diff.shape)
    assert not (diff & ~near).any(), int((diff & ~near).sum())
    n = int(diff.sum())
    assert n <= MAX_FRACTION * diff.size, (n, diff.size)
    return n


def blob_frames(n, seed=0, n_blobs=3, sigma=4.0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:HW, :HW]
    out = np.zeros((n, HW, HW, 1), np.float32)
    for i in range(n):
        for _ in range(n_blobs):
            cy, cx = rng.uniform(10, HW - 10, 2)
            out[i, ..., 0] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2))
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


SEG = ns(output_stride=2, loss_weight=None, bce_weight=None, dice_weight=None,
         bce_pos_weight=None)
HEADS = {
    "bottomup_segmentation": ns(segmentation=SEG,
                                center=ns(sigma=4.0, output_stride=2, loss_weight=None),
                                offsets=ns(output_stride=2, loss_weight=None)),
    "semantic_segmentation": ns(segmentation=SEG),
    "centered_instance_segmentation": ns(segmentation=SEG),
    "centroid": ns(confmaps=ns(anchor_part=None, sigma=3.0, output_stride=2, loss_weight=None)),
}
# Per head: the largest blob response scales to this (a logit for the
# sigmoid head: it is scaled before the sigmoid).
HEAD_SCALE = {"SegmentationHead": 6.0, "InstanceCenterHead": 1.0, "CenterOffsetHead": 4.0,
              "CentroidConfmapsHead": 1.0}


def model_pair(model_type, frames, seed, hw=HW):
    """A flax model with conditioned params, and the port's model holding them."""
    cfg = UNetConfig(in_channels=1, filters=4, filters_rate=1.5, max_stride=8, output_stride=2)
    heads = HEADS[model_type]
    fmodel = FlaxModel.from_config("unet", cfg, heads, model_type)
    params = fmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 1), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, params)
    x = jnp.asarray(frames / 255.0, jnp.float32)
    feats = fmodel.apply(params, x)
    for head in [k for k in params["params"] if k != "backbone"]:
        kernel = params["params"][head]["head_conv"]["kernel"]
        if head == "SegmentationHead":
            # The head's output is a sigmoid: scale its logits. The logit is
            # the pre-activation, sigmoid^-1 of the output.
            out = np.clip(np.asarray(feats[head]), 1e-7, 1 - 1e-7)
            logits = np.log(out / (1 - out))
            big = np.abs(logits).max(axis=(0, 1, 2))
            scale = HEAD_SCALE[head] / np.maximum(big, 1e-12)
        else:
            maps = np.asarray(feats[head])
            top, bottom = maps.max(axis=(0, 1, 2)), maps.min(axis=(0, 1, 2))
            scale = HEAD_SCALE[head] * np.where(
                top > 0, 1 / np.maximum(top, 1e-12), 1 / np.minimum(bottom, -1e-12))
        params["params"][head]["head_conv"]["kernel"] = (kernel * scale).astype(np.float32)
    tmodel = Model.from_config("unet", cfg, heads, model_type)
    return fmodel, params, tmodel, flax_to_torch_state(params, tmodel)


def _pre(mod, **kw):
    return mod.PreprocessConfig(ensure_grayscale=True, max_stride=8, **kw)


# -- helpers ------------------------------------------------------------------------


def _grouping_inputs(seed, b=2, h=12, w=14, k=5):
    rng = np.random.default_rng(seed)
    fg = rng.random((b, h, w, 1)).astype(np.float32)
    offsets = rng.normal(0, 4, (b, h, w, 2)).astype(np.float32)
    centers = rng.uniform(0, 2 * max(h, w), (b, k, 2)).astype(np.float32)
    valid = rng.random((b, k)) < 0.7
    valid[0] = False  # a frame without a centre: inf everywhere, index 0
    return fg, offsets, centers, valid


@pytest.mark.parametrize("kw", [{}, {"distance_gate_alpha": 1.5}, {"max_center_dist": 9.0},
                                {"output_stride": 4, "fg_threshold": 0.3}])
@pytest.mark.parametrize("seed", [0, 1])
def test_group_instances_from_offsets_matches(kw, seed):
    fg, offsets, centers, valid = _grouping_inputs(seed)
    want = np.asarray(jax.jit(lambda *a: js.group_instances_from_offsets(*a, **kw))(
        *map(jnp.asarray, (fg, offsets, centers, valid))))
    got = ps.group_instances_from_offsets(*map(_t, (fg, offsets, centers, valid)), **kw).numpy()
    assert got.dtype == np.bool_ and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert not got[0].any()


@pytest.mark.parametrize("nms_kernel", [3, 5])
def test_find_center_peaks_matches(nms_kernel):
    frames = blob_frames(3, seed=4).astype(np.float32) / 255.0
    hm = frames[:, ::2, ::2]
    want = js.find_center_peaks(jnp.asarray(hm), threshold=0.2, max_peaks=6,
                                nms_kernel=nms_kernel)
    got = ps.find_center_peaks(_t(hm), threshold=0.2, max_peaks=6, nms_kernel=nms_kernel)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def _random_mask(seed, hw=(40, 36), p=0.45, blobs=True):
    rng = np.random.default_rng(seed)
    m = rng.random(hw) < p
    if blobs:
        yy, xx = np.mgrid[:hw[0], :hw[1]]
        for _ in range(3):
            cy, cx = rng.uniform(5, min(hw) - 5, 2)
            m |= (yy - cy) ** 2 + (xx - cx) ** 2 < rng.uniform(9, 40)
    return m


@pytest.mark.parametrize("kw", [{}, {"min_area": 200}, {"radius": 2}, {"fill_holes": True},
                                {"radius": 1, "fill_holes": True, "min_area": 5}])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_cleanup_matches(kw, seed):
    m = _random_mask(seed)
    np.testing.assert_array_equal(ps.mask_cleanup(m, **kw), js.mask_cleanup(m, **kw))
    empty = np.zeros((5, 5), bool)
    np.testing.assert_array_equal(ps.mask_cleanup(empty, **kw), js.mask_cleanup(empty, **kw))


@pytest.mark.parametrize("eps,scale", [(0.01, 1.0), (0.0, 2.0), (0.05, 2.5)])
@pytest.mark.parametrize("seed", [0, 3])
def test_mask_to_polygon_matches(eps, scale, seed):
    m = _random_mask(seed, p=0.0)
    np.testing.assert_array_equal(ps.mask_to_polygon(m, eps, scale),
                                  js.mask_to_polygon(m, eps, scale))
    assert ps.mask_to_polygon(np.zeros((6, 6), bool)) is None
    assert js.mask_to_polygon(np.eye(6, dtype=bool)[:2]) is ps.mask_to_polygon(
        np.eye(6, dtype=bool)[:2])


@pytest.mark.parametrize("orig_hw,eff,scale,stride", [((64, 64), 1.0, 1.0, 2),
                                                      ((50, 61), 0.8, 0.5, 4),
                                                      ((33, 47), 1.0, 0.75, 2)])
def test_upsample_and_crop_valid_grid_match(orig_hw, eff, scale, stride):
    m = _random_mask(5, hw=(20, 24))
    np.testing.assert_array_equal(ps.upsample_mask(m, stride, orig_hw),
                                  js.upsample_mask(m, stride, orig_hw))
    np.testing.assert_array_equal(ps.crop_valid_grid(m, np.array(orig_hw), eff, scale, stride),
                                  js.crop_valid_grid(m, np.array(orig_hw), eff, scale, stride))


def _fragments(seed):
    """Candidate masks of one frame: two animals, one cut in three pieces,
    with a centre heatmap whose ridge joins the pieces and offsets that
    vote for their animal's centre."""
    rng = np.random.default_rng(seed)
    h, w, s = 32, 40, 2
    yy, xx = np.mgrid[:h, :w]
    heat = np.zeros((h, w), np.float32)
    animals = [((10, 10), 7), ((26, 22), 6)]
    owner = np.full((h, w), -1)
    for a, ((cx, cy), r) in enumerate(animals):
        heat = np.maximum(heat, np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r**2)))
        owner[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = a
    offsets = np.zeros((h, w, 2), np.float32)
    for a, ((cx, cy), _) in enumerate(animals):
        sel = owner == a
        offsets[sel, 0] = (cx * s + 1) - (xx[sel] * s + 1) + rng.normal(0, 1, sel.sum())
        offsets[sel, 1] = (cy * s + 1) - (yy[sel] * s + 1) + rng.normal(0, 1, sel.sum())
    pieces = [(owner == 0) & (xx < 8), (owner == 0) & (xx >= 8) & (yy < 10),
              (owner == 0) & (xx >= 8) & (yy >= 10), owner == 1]
    insts = []
    for m in pieces:
        ys, xs = np.nonzero(m)
        insts.append({"mask": m, "center": (xs.mean() * s + 1, ys.mean() * s + 1),
                      "score": float(rng.uniform(0.5, 1.0))})
    return insts, heat, offsets, s


def _same_groups(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["mask"], w["mask"])
        assert g["center"] == w["center"] and g["score"] == w["score"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fragment_merge_functions_match(seed):
    insts, heat, offsets, s = _fragments(seed)
    for i, m in enumerate(insts):
        np.testing.assert_array_equal(ps.mask_predicted_centers(m["mask"], offsets, s),
                                      js.mask_predicted_centers(m["mask"], offsets, s))
        for j in range(len(insts)):
            for it in (1, 2):
                assert ps.contact_fraction(m["mask"], insts[j]["mask"], it) == \
                    js.contact_fraction(m["mask"], insts[j]["mask"], it)
    for a, b in ((0, 1), (0, 3), (2, 3)):
        ca, cb = insts[a]["center"], insts[b]["center"]
        assert ps.center_valley_ridge(heat, ca, cb, 0.9, 0.8) == \
            js.center_valley_ridge(heat, ca, cb, 0.9, 0.8)
        pa = js.mask_predicted_centers(insts[a]["mask"], offsets, s)
        pb = js.mask_predicted_centers(insts[b]["mask"], offsets, s)
        assert ps.offset_agreement(pa, pb, s) == js.offset_agreement(pa, pb, s)
    for kw in ({}, {"dilate_iters": 2, "w_valley": 0.0, "w_offset": 0.0},
               {"w_valley": 0.5, "w_offset": 1.0}):
        edges = ps.build_merge_rag(insts, heat, offsets, s, **kw)
        assert edges == js.build_merge_rag(insts, heat, offsets, s, **kw)
        assert edges  # the touching pieces are joined by edges
        _same_groups(ps.merge_greedy_affinity(insts, edges), js.merge_greedy_affinity(insts, edges))
        _same_groups(ps.merge_greedy_affinity(insts, edges, (0.5, 0.2)),
                     js.merge_greedy_affinity(insts, edges, (0.5, 0.2)))
        for bias in (0.5, 0.2):
            _same_groups(ps.merge_multicut_greedy(insts, edges, bias),
                         js.merge_multicut_greedy(insts, edges, bias))
    for method in ("greedy", "multicut"):
        for kw in ({}, {"thresholds": (0.3,), "merge_bias": None}):
            kw = {k: v for k, v in kw.items() if k != "merge_bias"}
            got = ps.merge_instances(insts, heat, offsets, s, method=method, **kw)
            _same_groups(got, js.merge_instances(insts, heat, offsets, s, method=method, **kw))
    _same_groups(ps.merge_instances(insts[:1], heat, offsets, s),
                 js.merge_instances(insts[:1], heat, offsets, s))
    uf_p, uf_j = ps._UnionFind(5), js._UnionFind(5)
    for a, b in ((0, 3), (3, 4), (1, 2)):
        uf_p.union(a, b)
        uf_j.union(a, b)
    assert uf_p.groups(5) == uf_j.groups(5) and uf_p.parent == uf_j.parent


# -- renders --------------------------------------------------------------------------


def _instances(seed, b=2, i=3, n=4, hw=HW):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(4, hw - 4, (b, i, n, 2)).astype(np.float32)
    pts[rng.random((b, i, n)) < 0.2] = np.nan
    pts[0, -1] = np.nan  # a padded instance row
    return pts


@pytest.mark.parametrize("edges", [None, [(0, 1), (1, 2), (2, 3)], []])
@pytest.mark.parametrize("radius", [3.0, 12.0])
def test_render_masks_from_instances_matches(edges, radius):
    pts = _instances(0)
    ei = None if edges is None else np.asarray(edges, np.int64).reshape(-1, 2)
    want = np.stack([np.asarray(jsm.render_masks_from_instances(
        jnp.asarray(p), (HW, HW), None if ei is None else jnp.asarray(ei), radius)) for p in pts])
    got = psm.render_masks_from_instances(_t(pts), (HW, HW), None if ei is None else _t(ei),
                                          radius).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got[0, -1].any()


@pytest.mark.parametrize("stride,maxpool", [(1, False), (2, False), (4, True)])
def test_segmentation_targets_match(stride, maxpool):
    pts = _instances(1)
    masks = psm.render_masks_from_instances(_t(pts), (HW, HW), _t(np.array([[0, 1], [1, 2]])),
                                            8.0)
    valid = (~torch.isnan(_t(pts)[..., 0])).any(dim=-1)
    jm, jv = jnp.asarray(masks.numpy()), jnp.asarray(valid.numpy())
    checks = [
        (psm.generate_foreground_mask(masks, valid, stride, maxpool),
         jsm.generate_foreground_mask(jm, jv, stride, maxpool)),
        (psm.compute_mask_centroids(masks, valid), jsm.compute_mask_centroids(jm, jv)),
        (psm.generate_center_heatmap(masks, valid, stride, 3.0),
         jsm.generate_center_heatmap(jm, jv, stride, 3.0)),
        *zip(psm.generate_center_offsets(masks, valid, stride),
             jsm.generate_center_offsets(jm, jv, stride)),
    ]
    for got, want in checks:
        want = np.asarray(want)
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert np.asarray(checks[-1][1]).any()  # some cells are owned


# -- the layers ------------------------------------------------------------------------


def _bottomup_pair(frames, seed=3, **kw):
    fm, fp, tm, sd = model_pair("bottomup_segmentation", frames, seed)
    post = dict(peak_threshold=0.2)
    jlayer = js.BottomUpSegmentationLayer(JaxBackend(fm, fp), _pre(jl), jl.PostprocessConfig(**post),
                                          max_instances=6, **kw)
    tlayer = ps.BottomUpSegmentationLayer(TorchBackend(tm, sd, fused_convs=True, device="cpu"),
                                          _pre(tl), tl.PostprocessConfig(**post), max_instances=6,
                                          device="cpu", **kw)
    return jlayer, tlayer


def _compare_seg_masks(got, want, values=None, threshold=None):
    assert len(got) == len(want)
    n = 0
    for gf, wf in zip(got, want):
        assert len(gf) == len(wf)
        for g, w in zip(gf, wf):
            assert g.scale == w.scale
            np.testing.assert_allclose(g.score, w.score, rtol=0, atol=1e-5)
            n += assert_masks_match(g.mask, w.mask)
    return n


BOTTOMUP_KW = [
    {},
    {"center_nms_kernel": 5, "min_mask_area": 12},
    {"distance_gate_alpha": 2.0, "mask_cleanup_radius": 1},
    {"mask_cleanup": False, "full_res_masks": True},
    {"merge_fragments": True, "merge_method": "multicut", "merge_dilate": 2},
    {"merge_fragments": True, "merge_w_valley": 0.5, "merge_w_offset": 1.0,
     "merge_thresholds": (0.5, 0.2)},
    {"fg_threshold": 0.6, "max_center_dist": 30.0},
]


@pytest.mark.parametrize("kw", BOTTOMUP_KW, ids=lambda kw: "-".join(kw) or "default")
def test_bottomup_segmentation_layer_matches(kw):
    frames = blob_frames(3, seed=1)
    jlayer, tlayer = _bottomup_pair(frames, **kw)
    jdev = jax.device_get(jlayer.predict_async(frames))
    tdev = tl.to_host(tlayer.predict_async(frames))
    np.testing.assert_array_equal(tdev["center_valid"], np.asarray(jdev["center_valid"]))
    assert tdev["center_valid"].any()
    for key, atol in (("fg", 1e-5), ("centers", 1e-4), ("center_vals", 1e-5)):
        np.testing.assert_allclose(tdev[key], np.asarray(jdev[key]), rtol=0, atol=atol,
                                   err_msg=key)
    # Instance masks: a pixel may differ only where its foreground value
    # sits at the threshold.
    assert_masks_match(tdev["instance_masks"], jdev["instance_masks"],
                       np.asarray(jdev["fg"])[:, None, ..., 0], kw.get("fg_threshold", 0.5))
    want = jlayer.finalize(jdev)
    got = tlayer.postprocess_host(tdev)
    _compare_seg_masks(got["pred_masks"], want["pred_masks"])
    np.testing.assert_array_equal(got["centroid_valid"], want["centroid_valid"])
    assert got["mask_scale"] == want["mask_scale"]
    assert sum(len(f) for f in got["pred_masks"]) >= 2
    # The host step, fed the JAX package's device outputs, gives its masks.
    jhost = {k: np.asarray(v) for k, v in jdev.items()}
    _compare_seg_masks(tlayer.postprocess_host(dict(jhost))["pred_masks"], want["pred_masks"])


def test_semantic_segmentation_layer_matches():
    frames = blob_frames(3, seed=2)
    fm, fp, tm, sd = model_pair("semantic_segmentation", frames, 5)
    for kw in ({}, {"fg_threshold": 0.6}, {"full_res_masks": True}):
        jlayer = js.SemanticSegmentationLayer(JaxBackend(fm, fp), _pre(jl),
                                              jl.PostprocessConfig(), **kw)
        tlayer = ps.SemanticSegmentationLayer(
            TorchBackend(tm, sd, fused_convs=True, device="cpu"), _pre(tl),
            tl.PostprocessConfig(), device="cpu", **kw)
        want, got = jlayer.predict(frames), tlayer.predict(frames)
        np.testing.assert_allclose(got["fg_probs"], np.asarray(want["fg_probs"]), rtol=0,
                                   atol=1e-5)
        assert got["mask_scale"] == want["mask_scale"]
        assert sum(len(f) for f in got["pred_masks"]) >= 1
        for gf, wf, probs in zip(got["pred_masks"], want["pred_masks"], want["fg_probs"]):
            assert len(gf) == len(wf)
            if not wf:
                continue
            np.testing.assert_allclose(gf[0].score, wf[0].score, rtol=0, atol=1e-6)
            if kw.get("full_res_masks"):
                assert_masks_match(gf[0].mask, wf[0].mask)
            else:
                assert_masks_match(gf[0].mask, wf[0].mask, probs[..., 0],
                                   kw.get("fg_threshold", 0.5))


def _topdown_pair(frames, **kw):
    cm, cp, ctm, csd = model_pair("centroid", frames, 0)
    crops = np.zeros((2, CROP, CROP, 1), np.uint8)
    crops[:, 4:28, 4:28] = frames[:2, 20:44, 20:44]
    sm, sp, stm, ssd = model_pair("centered_instance_segmentation", crops, 6, hw=CROP)
    post = dict(peak_threshold=0.2, max_instances=3)
    jlayer = js.TopDownSegmentationLayer(
        jl.CentroidLayer(JaxBackend(cm, cp), _pre(jl), jl.PostprocessConfig(**post),
                         output_stride=2),
        JaxBackend(sm, sp), _pre(jl), max_instances=3, crop_size=CROP, **kw)
    tlayer = ps.TopDownSegmentationLayer(
        tl.CentroidLayer(TorchBackend(ctm, csd, fused_convs=True, device="cpu"), _pre(tl),
                         tl.PostprocessConfig(**post), output_stride=2, device="cpu"),
        TorchBackend(stm, ssd, fused_convs=True, device="cpu"), _pre(tl), max_instances=3,
        crop_size=CROP, device="cpu", **kw)
    return jlayer, tlayer


@pytest.mark.parametrize("kw", [{}, {"fg_threshold": 0.65, "min_mask_area": 30}])
def test_topdown_segmentation_layer_matches(kw):
    frames = blob_frames(4, seed=3)
    jlayer, tlayer = _topdown_pair(frames, **kw)
    jdev = jax.device_get(jlayer.predict_async(frames))
    tdev = tl.to_host(tlayer.predict_async(frames))
    np.testing.assert_array_equal(tdev["valid"], np.asarray(jdev["valid"]))
    np.testing.assert_array_equal(tdev["top_left"], np.asarray(jdev["top_left"]))
    assert tdev["valid"].sum() >= 3
    # Scores and values to 1e-5; centroids in pixels to 1e-4, as the
    # top-down tests hold keypoints.
    for key, atol in (("crop_scores", 1e-5), ("pred_centroids", 1e-4), ("centroid_vals", 1e-5)):
        np.testing.assert_allclose(tdev[key], np.asarray(jdev[key]), rtol=0, atol=atol,
                                   err_msg=key)
    assert float(tdev["stage2_scale"]) == float(np.asarray(jdev["stage2_scale"]))
    assert_masks_match(tdev["crop_masks"], jdev["crop_masks"])
    want = jlayer.finalize(jdev)
    got = tlayer.postprocess_host(tdev)
    _compare_seg_masks(got["pred_masks"], want["pred_masks"])
    assert sum(len(f) for f in got["pred_masks"]) >= 2


def test_topdown_segmentation_applies_a_second_sigmoid():
    """The layer (and the epoch-end ``val/fg_iou``) applies ``sigmoid`` to
    the SegmentationHead's output, which is a sigmoid already: every crop
    "probability" lies in (0.5, 0.731), so at ``fg_threshold`` 0.5 every
    crop pixel is foreground, in the JAX package and the port alike."""
    frames = blob_frames(2, seed=3)
    jlayer, tlayer = _topdown_pair(frames)
    seen = {}
    backend = tlayer.backend

    class Spy:
        device = backend.device

        def __call__(self, x):
            out = backend(x)
            seen["head"] = out["SegmentationHead"]
            return out

    tlayer.backend = Spy()
    tdev = tl.to_host(tlayer.predict_async(frames))
    head = seen["head"].numpy()
    assert head.min() > 0 and head.max() < 1  # the head's own sigmoid
    probs = 1 / (1 + np.exp(-head))
    assert probs.min() > 0.5 and probs.max() < 1 / (1 + np.exp(-1.0))
    assert tdev["crop_masks"].all()
    assert np.asarray(jax.device_get(jlayer.predict_async(frames))["crop_masks"]).all()
    valid = tdev["valid"].reshape(-1)
    scores = tdev["crop_scores"].reshape(-1)[valid]
    assert ((scores > 0.5) & (scores < 0.7311)).all()
