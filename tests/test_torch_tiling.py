"""Port parity: tiling (``data/tiling.py``, ``inference/tile_merger.py``,
``TiledLayer``, ``TiledDataset``, the disk cache and tiled training)
against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed. Host primitives (grids, seeds,
origins, ``extract_tile``, the sampler, dataset samples) must match
exactly. Merged canvases match to 1e-6 of their largest magnitude (the
JAX scatter-add and the port's slice adds sum in another order). The
``TiledLayer`` runs UNets with converted flax weights on blob frames (black
away from a few bright Gaussian blobs, so that the maps have clear peaks,
as in ``tests/test_torch_topdown.py``); peaks and keypoints match to 1e-4,
validity and channels exactly. Trainings: 3 steps of the JAX trainer and
of the port's on the same batches, at the tolerances of
``tests/test_torch_training.py`` (losses 1e-5 relative, parameters 1e-5
absolute).
"""

import copy
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.config import TrainingJobConfig as JConfig
from sleap_nn_tpu.data import pipeline as jpipe
from sleap_nn_tpu.data import tiling as jt
from sleap_nn_tpu.inference import layers as jl
from sleap_nn_tpu.inference import tile_merger as jm
from sleap_nn_tpu.inference.backends import JaxBackend
from sleap_nn_tpu.inference.predictor import Predictor as JaxPredictor
from sleap_nn_tpu.inference.providers import VideoProvider as JaxVideoProvider
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.models.model import Model as FlaxModel
from sleap_nn_tpu.training import ModelTrainer as JTrainer
from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.config.model_config import UNetConfig
from sleap_nn_tpu_torch.data import pipeline as ppipe
from sleap_nn_tpu_torch.data import tiling as pt
from sleap_nn_tpu_torch.inference import layers as tl
from sleap_nn_tpu_torch.inference import tile_merger as pm
from sleap_nn_tpu_torch.inference.backends import TorchBackend
from sleap_nn_tpu_torch.inference.predictor import Predictor
from sleap_nn_tpu_torch.inference.providers import VideoProvider
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.models.model import Model
from sleap_nn_tpu_torch.training import ModelTrainer
from sleap_nn_tpu_torch.weights import flax_to_torch_state
from tests.test_torch_pipeline import cfg_dict, make_labels
from tests.test_torch_topdown import ArrayVideo
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

ns = types.SimpleNamespace
N_NODES = 3


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


# -- host primitives -------------------------------------------------------------


GRID_CASES = [
    # image_hw, tile, overlap, output_stride, max_stride, min_overlap_fraction
    ((2048, 2048), 512, 128, 2, 32, 0.25),
    ((1080, 1920), 384, 64, 4, 16, 0.25),
    ((101, 78), 32, 8, 2, 16, 0.25),  # odd sizes: the flush-right origin snaps down
    ((24, 30), 32, 8, 2, 16, 0.25),  # a frame smaller than the tile
    ((500, 700), 96, 0, 2, 32, 0.5),  # the min_overlap_fraction floor
    ((300, 333), 64, 60, 2, 64, 0.0),  # advance below max_stride: snap to the output stride
    ((257, 257), 128, 32, 3, 16, 0.1),  # max_stride not a multiple of the output stride
    ((4000, 3000), 1024, 100, 1, 1, 0.25),
]


@pytest.mark.parametrize("case", GRID_CASES, ids=lambda c: "x".join(map(str, c[0])) + f"-{c[1]}")
def test_generate_tile_grid_matches(case):
    hw, tile, ov, os_, ms, mof = case
    want = jt.generate_tile_grid(hw, tile, ov, os_, max_stride=ms, min_overlap_fraction=mof)
    got = pt.generate_tile_grid(hw, tile, ov, os_, max_stride=ms, min_overlap_fraction=mof)
    assert got == want and len(got) >= 1
    for axis in range(2):
        args = (hw[axis], tile, ov, os_, ms, mof)
        assert pt._axis_tile_origins(*args) == jt._axis_tile_origins(*args)


def test_tile_sample_seed_and_sampler_match():
    for base, key, k, epoch in [(0, "0:0", 0, 0), (7, "2:15", 3, 1), (-3, "x", 11, 5003),
                                (2**40, "0:99999", 0, 1000)]:
        assert pt.tile_sample_seed(base, key, k, epoch) == jt.tile_sample_seed(base, key, k, epoch)
    for kw in [dict(shuffle=True, seed=3), dict(shuffle=False), dict(num_replicas=3, rank=1,
                                                                      seed=9)]:
        a = jt.FrameGroupedTileSampler(7, 4, **kw)
        b = pt.FrameGroupedTileSampler(7, 4, **kw)
        for epoch in (0, 1, 2002):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert list(a) == list(b) and len(a) == len(b)


def _instances(rng, n_inst=4, n_nodes=5, hw=(120, 90)):
    pts = rng.uniform(-10, max(hw) + 10, (n_inst, n_nodes, 2)).astype(np.float32)
    pts[rng.random((n_inst, n_nodes)) < 0.3] = np.nan
    pts[-1] = np.nan  # an empty slot
    return pts


@pytest.mark.parametrize("seed", range(4))
def test_foreground_centers_and_origin_draws_match(seed):
    rng = np.random.default_rng(seed)
    inst = _instances(rng)
    for mv in (1, 2, 4):
        _same(pt.frame_foreground_centers(inst, mv), jt.frame_foreground_centers(inst, mv))
    centers = jt.frame_foreground_centers(inst)
    for k in range(6):
        for fg, spf, jitter in ((0.5, 6, 0.5), (1.0, 6, 0.0), (0.0, 6, 1.0), (0.5, 1, 0.3)):
            for cs in (centers, centers[:0]):
                draws = [mod.draw_tile_origin(cs, (120, 90), 48, k, spf, fg, jitter,
                                              np.random.default_rng(seed * 100 + k))
                         for mod in (jt, pt)]
                assert draws[0] == draws[1]


@pytest.mark.parametrize("origin", [(0, 0), (-20, 13), (100, 70), (150, 200), (-64, -64)])
@pytest.mark.parametrize("min_visible", [1, 3])
def test_extract_tile_matches(origin, min_visible):
    rng = np.random.default_rng(abs(sum(origin)) + min_visible)
    image = rng.integers(0, 256, (120, 90, 3), dtype=np.uint8)
    inst = _instances(rng)
    want = jt.extract_tile(image, inst, origin, 64, min_visible_keypoints=min_visible)
    got = pt.extract_tile(image, inst, origin, 64, min_visible_keypoints=min_visible)
    for w, g in zip(want, got):
        _same(g, w)
        assert g.dtype == w.dtype


# -- the merge -------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["gaussian", "pyramid", "constant"])
@pytest.mark.parametrize("hw", [(16, 16), (7, 12)])
def test_build_importance_window_matches(mode, hw):
    want = np.asarray(jm.build_importance_window(hw, mode, 0.2))
    got = pm.build_importance_window(hw, mode, 0.2).numpy()
    _same(got, want)
    for mod in (jm, pm):
        with pytest.raises(ValueError, match="Unknown importance window mode"):
            mod.build_importance_window(hw, "cosine")


MERGE_CASES = {
    "inside": ([(0, 0), (0, 12), (12, 0), (12, 12)], (28, 28)),
    # Tiles past the bottom and right edges: their overhang piles onto the
    # last row and column (the clip of the JAX scatter's indices).
    "past_edge": ([(0, 0), (0, 20), (20, 0), (20, 20), (27, 27)], (30, 29)),
    "negative": ([(-5, -3), (4, 10), (-16, 0)], (20, 22)),
    "outside": ([(40, 2), (3, 50), (-40, -40)], (24, 24)),
    # h not divisible by the output stride: the canvas is floored, the last
    # tile hangs over by one line.
    "odd_canvas": ([(0, 0), (0, 34), (34, 0), (34, 34)], (50, 50)),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
@pytest.mark.parametrize("blend", ["gaussian", "constant"])
def test_merge_tiles_matches(case, blend):
    origins, canvas = MERGE_CASES[case]
    rng = np.random.default_rng(len(case))
    tiles = rng.standard_normal((len(origins), 16, 16, 3)).astype(np.float32)
    window_j = jm.build_importance_window((16, 16), blend)
    want = np.asarray(jm.merge_tiles(jnp.asarray(tiles), jnp.asarray(origins, jnp.int32),
                                     canvas, window_j))
    window_p = pm.build_importance_window((16, 16), blend)
    got = pm.merge_tiles(torch.from_numpy(tiles), origins, canvas, window_p)
    assert got.shape == want.shape == (*canvas, 3) and got.dtype == torch.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale)
    # The counts, made once for a grid, give the same merge.
    counts = pm.merge_counts(origins, canvas, window_p)
    torch.testing.assert_close(pm.merge_tiles(torch.from_numpy(tiles), np.asarray(origins),
                                              canvas, window_p, counts), got, rtol=0, atol=0)


def test_merge_tiles_piles_the_overhang_onto_the_edge():
    """A constant tile hanging 4 lines past the canvas: the edge line holds
    the weight of 5 lines (the last in-canvas line and the 4 past it)."""
    window = pm.build_importance_window((8, 8), "constant")
    tiles = torch.ones((1, 8, 8, 1))
    acc_only = pm.merge_counts([(6, 0)], (10, 8), window)
    assert acc_only[9, 0, 0].item() == 5.0 and acc_only[8, 0, 0].item() == 1.0
    assert acc_only[:6].abs().sum().item() == 0.0
    merged = pm.merge_tiles(tiles, [(6, 0)], (10, 8), window)
    assert torch.equal(merged[6:], torch.ones((4, 8, 1))) and merged[:6].abs().sum() == 0


# -- TiledLayer --------------------------------------------------------------------


def tiled_blob_frames(n, hw, seed=0, blobs=3):
    """uint8 (n, H, W, 1): black, with a few bright Gaussian blobs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    out = np.zeros((n, *hw, 1), np.float32)
    for i in range(n):
        for _ in range(blobs):
            cy, cx = rng.uniform(8, hw[0] - 8), rng.uniform(8, hw[1] - 8)
            out[i, ..., 0] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 3.0**2))
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def tiled_model_pair(model_type, tiles, seed, filters=4):
    """A flax UNet and its port twin with the same weights; the head scaled
    so that channel ``c``'s maps reach about ``1 / (1 + 0.1 c)`` on
    ``tiles``' blobs (distinct channel peaks: no exact tie between two
    channels' maxima for float rounding to order)."""
    cfg = UNetConfig(in_channels=1, filters=filters, filters_rate=1.5, max_stride=8,
                     output_stride=2)
    if model_type == "centroid":
        heads = ns(confmaps=ns(anchor_part=None, sigma=5.0, output_stride=2, loss_weight=None))
    else:
        heads = ns(confmaps=ns(part_names=[f"n{i}" for i in range(N_NODES)], anchor_part=None,
                               sigma=3.0, output_stride=2, loss_weight=None))
    fmodel = FlaxModel.from_config("unet", cfg, heads, model_type)
    params = fmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 1), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, params)
    head = next(k for k in params["params"] if k != "backbone")
    maps = np.asarray(fmodel.apply(params, jnp.asarray(tiles / 255.0, jnp.float32))[head])
    kernel = params["params"][head]["head_conv"]["kernel"]
    top, bottom = maps.max(axis=(0, 1, 2)), maps.min(axis=(0, 1, 2))
    scale = np.where(top > 0, 1 / np.maximum(top, 1e-12), 1 / np.minimum(bottom, -1e-12))
    scale = scale / (1 + 0.1 * np.arange(len(scale)))
    params["params"][head]["head_conv"]["kernel"] = (kernel * scale).astype(np.float32)
    tmodel = Model.from_config("unet", cfg, heads, model_type)
    return fmodel, params, tmodel, flax_to_torch_state(params, tmodel), head


def _tiles_of(frames, tile):
    return np.stack([jt.extract_tile(f, np.zeros((0, 1, 2), np.float32), o, tile)[0]
                     for f in frames for o in jt.generate_tile_grid(f.shape[:2], tile, 8, 2,
                                                                    max_stride=16)])


def tiled_layers(model_type, mode, frames, tile=32, overlap=8, tbs=4, blend="gaussian",
                 seed=0):
    fm, fp, tm, sd, head = tiled_model_pair(model_type, _tiles_of(frames, tile), seed)
    kw = dict(head_name=head, output_stride=2, tile_size=tile, overlap=overlap, blend=blend,
              tile_batch_size=tbs, mode=mode)
    post = dict(peak_threshold=0.2, max_peaks=8)
    jlayer = jl.TiledLayer(JaxBackend(fm, fp), jl.PreprocessConfig(), jl.PostprocessConfig(**post),
                           **kw)
    tlayer = tl.TiledLayer(TorchBackend(tm, sd, fused_convs=True, device="cpu"),
                           tl.PreprocessConfig(), tl.PostprocessConfig(**post), device="cpu", **kw)
    return jlayer, tlayer


def _compare(got, want, atol=1e-4):
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape, k
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            _same(g, w, k)
        else:
            _same(np.isnan(g), np.isnan(w), k)
            np.testing.assert_allclose(g, w.astype(np.float32), atol=atol, rtol=0, err_msg=k)


TILED_CASES = {
    # frames (n, h, w), tile, overlap, tile_batch_size
    "odd_frame_short_chunk": ((2, 101, 78), 32, 8, 5),  # 6 x 4 tiles: a short last chunk
    "smaller_than_tile": ((2, 24, 30), 32, 8, 4),  # one zero-padded tile past the canvas
    "even_frame_one_chunk": ((1, 64, 96), 32, 16, 16),
}


@pytest.mark.parametrize("case", sorted(TILED_CASES))
@pytest.mark.parametrize("model_type,mode", [("centroid", "local"),
                                             ("single_instance", "global"),
                                             ("single_instance", "local")])
def test_tiled_layer_matches_jax(case, model_type, mode):
    (n, h, w), tile, overlap, tbs = TILED_CASES[case]
    frames = tiled_blob_frames(n, (h, w), seed=h)
    jlayer, tlayer = tiled_layers(model_type, mode, frames, tile, overlap, tbs)
    origins = tlayer.tile_grid((h, w))
    assert origins == jt.generate_tile_grid((h, w), tile, overlap, 2, max_stride=16)
    # The merged canvases, against the JAX merge of the JAX tile maps.
    jmaps = [jm.merge_tiles(jnp.concatenate([jlayer._tile_fn(jnp.asarray(c)) for c in np.split(
        _tiles_of(frames[i:i + 1], tile), range(tbs, len(origins), tbs))]),
        jnp.asarray(np.asarray(origins) // 2, jnp.int32), (h // 2, w // 2), jlayer._window)
        for i in range(n)]
    want_maps = np.stack([np.asarray(m) for m in jmaps])
    got_maps = tlayer.merged_maps(torch.from_numpy(frames)).numpy()
    assert got_maps.shape == want_maps.shape == (n, h // 2, w // 2, want_maps.shape[-1])
    np.testing.assert_allclose(got_maps, want_maps, rtol=0, atol=1e-6 * np.abs(want_maps).max())
    want, got = jlayer.predict(frames), tlayer.predict(frames)
    _compare(got, want)
    found = want["peak_valid"].sum() if mode == "local" else np.isfinite(
        want["pred_keypoints"][..., 0]).sum()
    assert found >= n  # peaks were found, so the comparison means something
    if case == "odd_frame_short_chunk":
        assert len(origins) % tbs


def test_tiled_predictor_global_matches_jax():
    """A global-mode layer under ``Predictor(layer, "single_instance")``,
    raw outputs and ``Labels``, with a padded tail batch."""
    frames = tiled_blob_frames(5, (70, 90), seed=4)
    jlayer, tlayer = tiled_layers("single_instance", "global", frames)
    video = ArrayVideo(frames)
    skel_j = jio.Skeleton([f"n{i}" for i in range(N_NODES)])
    skel_p = pio.Skeleton([f"n{i}" for i in range(N_NODES)])
    jpred = JaxPredictor(jlayer, "single_instance", skel_j, [], batch_size=2)
    ppred = Predictor(tlayer, "single_instance", skel_p, [], batch_size=2, device="cpu")
    want = jpred.predict(video, provider=JaxVideoProvider(video, batch_size=2), make_labels=False)
    got = ppred.predict(provider=VideoProvider(video, batch_size=2), make_labels=False)
    assert len(got) == len(want) == 3 and got[-1]["valid"].tolist() == [True, False]
    for g, w in zip(got, want):
        _compare(g, w)
    labels = ppred.predict(video)
    wl = jpred.predict(video, provider=JaxVideoProvider(video, batch_size=2))
    assert [lf.frame_idx for lf in labels] == [lf.frame_idx for lf in wl] == list(range(5))
    for a, b in zip(labels, wl):
        np.testing.assert_allclose(a.instances[0].numpy(), b.instances[0].numpy(), atol=1e-4)
    assert tl.TiledLayer.consumes_host_frames


# -- TiledDataset ----------------------------------------------------------------------


def _tiling(**kw):
    return {"enabled": True, "tile_size": 32, "overlap": 8, **kw}


def _tiled_datasets(tiling, use_halo, n_frames=5, hw=(80, 70), model_type="centroid"):
    jlab = make_labels(jio, n_frames=n_frames, hw=hw, max_inst=3, seed=3)
    plab = make_labels(pio, n_frames=n_frames, hw=hw, max_inst=3, seed=3)
    d = cfg_dict(model_type=model_type)
    jctx = jpipe.build_pipeline_context(JConfig.from_dict(d), jlab, model_type)
    pctx = ppipe.build_pipeline_context(PConfig.from_dict(d), plab, model_type)
    jcfg = JConfig.from_dict({"data_config": {"preprocessing": {"tiling": tiling}}})
    pcfg = PConfig.from_dict({"data_config": {"preprocessing": {"tiling": tiling}}})
    jds = jpipe.TiledDataset(jpipe.make_dataset(model_type, [jlab], jctx),
                             jcfg.data_config.preprocessing.tiling, base_seed=5, use_halo=use_halo)
    pds = ppipe.TiledDataset(ppipe.make_dataset(model_type, [plab], pctx),
                             pcfg.data_config.preprocessing.tiling, base_seed=5, use_halo=use_halo)
    return jds, pds


def _same_samples(jds, pds):
    assert len(jds) == len(pds) > 0
    for i in range(len(jds)):
        a, b = jds.get_sample(i), pds.get_sample(i)
        assert set(a) == set(b), i
        for k in a:
            if k == "image_path":  # each package's own cache directory
                assert Path(b[k]).name == Path(a[k]).name
                continue
            _same(b[k], a[k], f"{i} {k}")
            assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype, k


TILED_DATASET_CASES = {
    "foreground": (_tiling(samples_per_frame=3), False),
    "halo": (_tiling(samples_per_frame=3, tile_fg_fraction=1.0), True),
    "full_frame_pass": (_tiling(samples_per_frame=2, full_frame_pass=True), False),
    "halo_full_frame_pass": (_tiling(full_frame_pass=True, center_jitter=1.0), True),
    "grid": (_tiling(sampling="grid", samples_per_frame=2), False),
    "min_visible": (_tiling(samples_per_frame=4, min_visible_keypoints=2), False),
}


@pytest.mark.parametrize("case", sorted(TILED_DATASET_CASES))
def test_tiled_dataset_samples_match_over_two_epochs(case):
    tiling, halo = TILED_DATASET_CASES[case]
    jds, pds = _tiled_datasets(tiling, halo)
    assert pds.samples_per_frame == jds.samples_per_frame
    assert pds.halo_size == jds.halo_size == 46
    side = 46 if halo else 32
    assert pds.get_sample(0)["image"].shape == (side, side, 1)
    draws = []
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        _same_samples(jds, pds)
        draws.append(pds.get_sample(0)["image"])
    if tiling.get("sampling") != "grid":
        assert not np.array_equal(draws[0], draws[1])  # epoch 1 draws new tiles
    batch_j, batch_p = jds.make_batch([0, 3, 4]), pds.make_batch([0, 3, 4])
    for k in batch_j:
        _same(batch_p[k], batch_j[k], k)


def test_tiled_dataset_keeps_track_ids_aligned():
    jds, pds = _tiled_datasets(_tiling(samples_per_frame=4), False, model_type="bottomup")
    for ds in (jds, pds):
        for s in ds.inner.samples:
            s["track_ids"] = np.arange(len(s["track_ids"]), dtype=np.int32)
    _same_samples(jds, pds)
    moved = [i for i in range(len(pds)) if pds.get_sample(i)["track_ids"][0] != 0]
    assert moved  # some tile's first visible instance was not the frame's first


def test_loader_set_epoch_reaches_the_tiled_dataset():
    jds, pds = _tiled_datasets(_tiling(samples_per_frame=3), False)
    jload = jpipe.Loader(jds, 4, shuffle=True, seed=2, prefetch=0)
    pload = ppipe.Loader(pds, 4, shuffle=True, seed=2, prefetch=2)
    for epoch in (0, 3, 2005):
        jload.set_epoch(epoch)
        pload.set_epoch(epoch)
        assert pds.epoch == jds.epoch == epoch
        for a, b in zip(list(jload), list(pload)):
            for k in a:
                _same(b[k], a[k], k)


# -- the render's halo crop ----------------------------------------------------------------


def test_render_crops_the_halo_like_jax():
    """The train render centre-crops a halo tile back to the tile after the
    augmentation (here an identity: affine_p 0), as the JAX render does;
    the val render leaves it."""
    jds, pds = _tiled_datasets(_tiling(samples_per_frame=2), True)
    geo = {"affine_p": 0.0}
    jctx = jpipe.PipelineContext(**{**vars(jds.ctx), "use_augmentations": True, "geometric": geo,
                                    "halo_crop_to": 32, "max_height": None, "max_width": None})
    pctx = ppipe.PipelineContext(**{**vars(pds.ctx), "use_augmentations": True, "geometric": geo,
                                    "halo_crop_to": 32, "max_height": None, "max_width": None})
    batch = jds.make_batch([0, 1, 2, 3])
    for train in (True, False):
        want = jpipe.make_render_fn(jctx, train)({k: jnp.asarray(v) for k, v in batch.items()},
                                                 jax.random.PRNGKey(0))
        got = ppipe.make_render_fn(pctx, train)({k: torch.from_numpy(v) for k, v in
                                                 pds.make_batch([0, 1, 2, 3]).items()},
                                                torch.Generator().manual_seed(0))
        assert got["image"].shape[1] == (32 if train else 48)
        for k in ("image", "instances", "confmaps"):
            w, g = np.asarray(want[k]), got[k].numpy()
            _same(np.isnan(g), np.isnan(w), k)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)


# -- the disk cache ----------------------------------------------------------------------


@pytest.mark.parametrize("workers", [0, 3])
def test_disk_cache_matches_memory_and_jax(tmp_path, workers):
    jlab, plab = make_labels(jio, n_frames=6), make_labels(pio, n_frames=6)
    d = cfg_dict()
    jctx = jpipe.build_pipeline_context(JConfig.from_dict(d), jlab, "centroid")
    pctx = ppipe.build_pipeline_context(PConfig.from_dict(d), plab, "centroid")
    jds = jpipe.make_dataset("centroid", [jlab], jctx, cache_mode="disk",
                             cache_dir=tmp_path / "j", cache_workers=workers)
    pds = ppipe.make_dataset("centroid", [plab], pctx, cache_mode="disk",
                             cache_dir=tmp_path / "p", cache_workers=workers)
    mem = ppipe.make_dataset("centroid", [plab], pctx)
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir()) == \
        sorted(f"sample_{i}.npy" for i in range(6))
    assert all("image" not in s for s in pds.samples)
    _same_samples(jds, pds)
    for i in range(6):
        _same(pds.get_sample(i)["image"], mem.get_sample(i)["image"])
    # A temporary directory of its own where none is given.
    tmp_ds = ppipe.make_dataset("centroid", [plab], pctx, cache_mode="disk")
    assert tmp_ds.cache_dir.exists() and len(list(tmp_ds.cache_dir.iterdir())) == 6


def test_disk_cache_use_existing_imgs(tmp_path):
    """``use_existing_imgs`` keeps a file already there (and reads it back),
    in both packages; without it the file is written anew."""
    jlab, plab = make_labels(jio, n_frames=3), make_labels(pio, n_frames=3)
    d = cfg_dict()
    jctx = jpipe.build_pipeline_context(JConfig.from_dict(d), jlab, "centroid")
    pctx = ppipe.build_pipeline_context(PConfig.from_dict(d), plab, "centroid")
    marker = np.full((64, 64, 1), 7, np.uint8)
    for name in ("j", "p"):
        (tmp_path / name).mkdir()
        np.save(tmp_path / name / "sample_1.npy", marker)
    jds = jpipe.make_dataset("centroid", [jlab], jctx, cache_mode="disk",
                             cache_dir=tmp_path / "j", use_existing_imgs=True)
    pds = ppipe.make_dataset("centroid", [plab], pctx, cache_mode="disk",
                             cache_dir=tmp_path / "p", use_existing_imgs=True)
    _same_samples(jds, pds)
    _same(pds.get_sample(1)["image"], marker)
    fresh = ppipe.make_dataset("centroid", [plab], pctx, cache_mode="disk",
                               cache_dir=tmp_path / "p")
    assert not np.array_equal(fresh.get_sample(1)["image"], marker)


# -- tiled and cached training -----------------------------------------------------------


def _train_dict(tiling=None, cache=None, model_type="centroid", augment=False, **trainer):
    d = cfg_dict(batch=4, model_type=model_type, augment=augment, **trainer)
    if tiling is not None:
        d["data_config"]["preprocessing"] = {"tiling": tiling}
    if cache is not None:
        d["data_config"].update(cache)
    return d


def _trainers(d, labels_kw=None):
    labels_kw = labels_kw or dict(n_frames=8, hw=(80, 72), seed=1)
    jtr = JTrainer.get_model_trainer_from_config(JConfig.from_dict(copy.deepcopy(d)),
                                                 [make_labels(jio, **labels_kw)])
    jtr.setup()
    ptr = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(copy.deepcopy(d)),
                                                     [make_labels(pio, **labels_kw)],
                                                     device="cpu")
    ptr.setup()
    ptr.model.load_state_dict(flax_to_torch_state(jax.device_get(jtr.params), ptr.model),
                              strict=True)
    return jtr, ptr


def _three_steps_match(jtr, ptr):
    assert ptr._input_shape == tuple(jtr._input_shape)
    batches = list(jtr.train_loader._gen())[:3]
    assert len(batches) == 3
    pbatches = list(ptr.train_loader._gen())[:3]
    for a, b in zip(batches, pbatches):
        for k in a:
            _same(b[k], a[k], k)
    params, opt_state = jtr.params, jtr.tx.init(jtr.params)
    cp = lambda t: jax.tree_util.tree_map(lambda x: x.copy(), t)  # noqa: E731 (donated)
    for step, batch in enumerate(batches):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        params, opt_state, want_loss, _ = jtr._train_step(cp(params), cp(opt_state), jbatch,
                                                          jax.random.PRNGKey(step))
        got_loss, _ = ptr.train_step(batch)
        np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    want_params = flax_to_torch_state(jax.device_get(params), ptr.model)
    for name, p in ptr.model.state_dict().items():
        torch.testing.assert_close(p, want_params[name], rtol=0, atol=1e-5, msg=name)


@pytest.mark.parametrize("model_type", ["centroid", "bottomup"])
def test_tiled_training_three_steps_match_jax(model_type):
    d = _train_dict(_tiling(samples_per_frame=2), model_type=model_type)
    jtr, ptr = _trainers(d)
    assert isinstance(ptr.train_ds, ppipe.TiledDataset) and ptr.ctx.max_height is None
    assert ptr.ctx.halo_crop_to is None and ptr._input_shape == (1, 32, 32, 1)
    _three_steps_match(jtr, ptr)


def test_tiled_training_history_matches_jax(tmp_path):
    """``tiling.steps_per_epoch`` caps each epoch; when the tiles run out,
    the re-draw (``set_epoch(epoch * 1000 + steps)``) reaches the tiles."""
    d = _train_dict(_tiling(samples_per_frame=1, steps_per_epoch=3), max_epochs=2,
                    train_steps_per_epoch=None)
    jtr, ptr = _trainers(d, dict(n_frames=5, hw=(80, 72), seed=1))
    assert len(ptr.train_loader) == 1  # 4 train frames x 1 tile: the epoch re-draws twice
    jh, ph = jtr.train(), ptr.train()
    assert len(jh) == len(ph) == 2
    for a, b in zip(jh, ph):
        for k in ("train/loss", "val/loss"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    assert ptr.train_ds.epoch == jtr.train_ds.epoch == 1002


def test_tiled_training_with_rotation_uses_the_halo():
    d = _train_dict(_tiling(samples_per_frame=2), augment=True)
    d["data_config"]["augmentation_config"] = {"geometric": {"rotation_min": -30.0,
                                                             "rotation_max": 30.0}}
    jtr, ptr = _trainers(d)
    assert ptr.train_ds.use_halo and jtr.train_ds.use_halo and not ptr.val_ds.use_halo
    assert ptr.ctx.halo_crop_to == jtr.ctx.halo_crop_to == 32
    assert ptr._input_shape == tuple(jtr._input_shape) == (1, 32, 32, 1)  # the val probe
    _same_samples(jtr.train_ds, ptr.train_ds)
    _same_samples(jtr.val_ds, ptr.val_ds)
    processed = ptr.render(ptr.train_ds.make_batch([0, 1, 2, 3]), train=True)
    assert processed["image"].shape == (4, 32, 32, 1)
    loss, _ = ptr.train_step(ptr.train_ds.make_batch([0, 1, 2, 3]))
    assert np.isfinite(loss.item())


def test_tiling_geometry_is_rounded_like_jax(capsys):
    d = _train_dict(_tiling(tile_size=30, overlap=3, min_overlap_fraction=0.5))
    labels_kw = dict(n_frames=8, hw=(80, 72), seed=1)
    jtr = JTrainer.get_model_trainer_from_config(JConfig.from_dict(copy.deepcopy(d)),
                                                 [make_labels(jio, **labels_kw)])
    jtr.setup()
    want = capsys.readouterr().out
    ptr = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(copy.deepcopy(d)),
                                                     [make_labels(pio, **labels_kw)],
                                                     device="cpu")
    ptr.setup()
    got = capsys.readouterr().out
    lines = [ln for ln in want.splitlines() if ln.startswith("WARNING: tiling")]
    assert len(lines) == 3 and lines == [ln for ln in got.splitlines()
                                        if ln.startswith("WARNING: tiling")]
    tj, tp = (t.config.data_config.preprocessing.tiling for t in (jtr, ptr))
    assert (tp.tile_size, tp.overlap) == (tj.tile_size, tj.overlap) == (32, 16)


@pytest.mark.parametrize("tiling,model_type,match", [
    (_tiling(), "centered_instance", "crop-based model type"),
    (_tiling(overlap=40), "centroid", "must be smaller"),
    ({"enabled": True}, "centroid", "requires tiling.tile_size"),
])
def test_tiling_refusals_match_jax(tiling, model_type, match):
    d = _train_dict(tiling, model_type=model_type)
    if model_type == "centered_instance":
        d["data_config"]["preprocessing"]["crop_size"] = 32
    for trainer, cfg, io, kw in ((JTrainer, JConfig, jio, {}), (ModelTrainer, PConfig, pio,
                                                               {"device": "cpu"})):
        t = trainer.get_model_trainer_from_config(cfg.from_dict(copy.deepcopy(d)),
                                                  [make_labels(io, n_frames=8, hw=(80, 72))],
                                                  **kw)
        with pytest.raises(ValueError, match=match):
            t.setup()


def test_disk_cached_training_matches_jax_and_cleans_up():
    d = _train_dict(cache={"data_pipeline_fw": "torch_dataset_cache_img_disk"},
                    max_epochs=1, train_steps_per_epoch=3)
    jtr, ptr = _trainers(d, dict(n_frames=16, hw=(80, 72), seed=1))
    dirs = [ptr.train_ds.cache_dir, ptr.val_ds.cache_dir]
    assert all(len(list(p.glob("sample_*.npy"))) for p in dirs)
    assert all("image" not in s for s in ptr.train_ds.samples)
    _three_steps_match(jtr, ptr)
    jtr, ptr = _trainers(d, dict(n_frames=16, hw=(80, 72), seed=1))  # fresh, for train()
    dirs = [ptr.train_ds.cache_dir, ptr.val_ds.cache_dir]
    jh, ph = jtr.train(), ptr.train()
    for k in ("train/loss", "val/loss"):
        np.testing.assert_allclose(ph[0][k], jh[0][k], rtol=1e-5, err_msg=k)
    assert not any(p.exists() for p in dirs)  # delete_cache_imgs_after_training
    assert not jtr.train_ds.cache_dir.exists()


def test_disk_cache_keeps_train_and_val_apart(tmp_path):
    """With ``cache_img_path`` set, the port caches each split in a
    directory of its own (``train_imgs``, ``val_imgs``), and each split
    reads back its own frames. The JAX trainer spills both splits to
    ``sample_{i}.npy`` in that one directory, so the val frames overwrite
    the first train frames (a fault of the reference, which the port does
    not copy)."""
    cache = {"data_pipeline_fw": "torch_dataset_cache_img_disk",
             "cache_img_path": str(tmp_path / "cache"), "delete_cache_imgs_after_training": False}
    d = _train_dict(cache=cache, max_epochs=1, train_steps_per_epoch=1)
    jtr, ptr = _trainers(d)
    mem = ModelTrainer.get_model_trainer_from_config(
        PConfig.from_dict(_train_dict()), [make_labels(pio, n_frames=8, hw=(80, 72), seed=1)],
        device="cpu")
    mem.setup()
    assert {p.name for p in (tmp_path / "cache").iterdir()} >= {"train_imgs", "val_imgs"}
    for ds, ref in ((ptr.train_ds, mem.train_ds), (ptr.val_ds, mem.val_ds)):
        for i in range(len(ref)):
            _same(ds.get_sample(i)["image"], ref.get_sample(i)["image"])
    assert not np.array_equal(jtr.train_ds.get_sample(0)["image"],
                              mem.train_ds.get_sample(0)["image"])
    _same(jtr.train_ds.get_sample(0)["image"], mem.val_ds.get_sample(0)["image"])
    ptr.train()
    assert (tmp_path / "cache" / "train_imgs").exists()  # kept, as asked
