"""Port parity: ``run.predict`` from video files against the JAX package's
``predict`` on the CPU, from the port's model dirs of
``tests/test_torch_model_dir.py`` (and a multi-class bottom-up dir built as
``tests/test_torch_multiclass.py`` builds its own).

The clips are that file's blob frames written here with cv2: an MJPG
``.avi`` of 10 frames (the main container), an ``mp4v`` ``.mp4``, a PNG
image sequence and a ``.pkg.slp`` whose embedded frames are JPEG bytes.
Both packages decode the same file with the same cv2, so they predict on
the same pixels: frame and instance counts exact, NaN placed alike,
keypoints to 1e-4 px and scores to 1e-5. Covered: every model type set
the port predicts from a file (centroid-only with each
``centroid_output``), ``host_resize`` (the host-resized frames equal),
weight swaps and their ``ValueError``s, the per-call ``return_confmaps``
/ ``return_paf_graph`` overrides (the predictor left as it was), each
source-scoping and output option of ``run.predict``, and the analysis
HDF5 output.
"""

import copy
import json
import shutil
import zlib
from types import SimpleNamespace as ns

import cv2
import h5py
import numpy as np
import pytest

from sleap_nn_tpu.inference.predictor import Predictor as JaxPredictor
from sleap_nn_tpu.inference.run import predict as jax_predict
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.io import video as jvideo
from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.inference import run as prun
from sleap_nn_tpu_torch.inference.predictor import Predictor
from sleap_nn_tpu_torch.io import hdf5
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.io import video as pvideo
from sleap_nn_tpu_torch.training import ModelTrainer
from tests.test_torch_model_dir import (  # noqa: F401  (dirs: fixtures)
    KW,
    FrameVideo,
    _paths,
    config_dict,
    dirs,
)
from tests.test_torch_multiclass import _condition, _dir_config, id_labels
from tests.test_torch_topdown import blob_frames
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

N_FRAMES = 10
ATOL_POINTS, ATOL_SCORES = 1e-4, 1e-5


def write_clip(path, frames, fourcc="MJPG"):
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 10.0, (w, h),
                             isColor=False)
    assert writer.isOpened(), path
    for f in frames:
        writer.write(np.ascontiguousarray(f[..., 0]))
    writer.release()
    return str(path)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    from tests.test_torch_video import write_jpeg_pkg

    root = tmp_path_factory.mktemp("clips")
    frames = blob_frames(N_FRAMES, seed=9)
    images = []
    for i, f in enumerate(frames[:6]):
        images.append(str(root / f"f{i}.png"))
        cv2.imwrite(images[-1], f)
    return ns(root=root, frames=frames, avi=write_clip(root / "clip.avi", frames),
              mp4=write_clip(root / "clip.mp4", frames, "mp4v"), images=images,
              pkg=write_jpeg_pkg(root / "clip.pkg.slp", np.repeat(frames, 3, axis=-1)))


@pytest.fixture(scope="module")
def mc_dirs(tmp_path_factory):
    """Identity dirs: a centroid, a multi-class bottom-up and a multi-class
    top-down model, each trained one step and conditioned."""
    root = tmp_path_factory.mktemp("mc")
    frames = blob_frames(8, seed=2)
    labels = id_labels(pio, frames=frames, max_inst=2, seed=2, spread=4)
    out = {}
    for model_type in ("centroid", "multi_class_bottomup", "multi_class_topdown"):
        trainer = ModelTrainer.get_model_trainer_from_config(
            PConfig.from_dict(_dir_config(model_type, root)), [labels], device="cpu")
        trainer.train()
        _condition(trainer.model, frames)
        trainer.save_checkpoint("best.ckpt")
        out[model_type] = trainer.ckpt_dir
    return out


def assert_same_labels(got, want):
    """Frames in order; per frame the same instances (points to 1e-4 px,
    scores to 1e-5, NaN alike, track names equal) and centroids."""
    assert [lf.frame_idx for lf in got] == [lf.frame_idx for lf in want]
    assert [t.name for t in got.tracks] == [t.name for t in want.tracks]
    for g, w in zip(got.labeled_frames, want.labeled_frames):
        assert len(g.instances) == len(w.instances), g.frame_idx
        for gi, wi in zip(g.instances, w.instances):
            assert type(gi).__name__ == type(wi).__name__
            np.testing.assert_array_equal(np.isnan(gi.points), np.isnan(wi.points))
            np.testing.assert_allclose(gi.points, wi.points, atol=ATOL_POINTS, rtol=0)
            np.testing.assert_allclose(gi.point_scores, wi.point_scores, atol=ATOL_SCORES, rtol=0)
            np.testing.assert_allclose(gi.score, wi.score, atol=ATOL_SCORES, rtol=0)
            assert (gi.track and gi.track.name) == (wi.track and wi.track.name)
        gc = getattr(g, "centroids", [])
        wc = getattr(w, "centroids", [])
        assert len(gc) == len(wc)
        for c, d in zip(gc, wc):
            np.testing.assert_allclose(c.point, d.point, atol=ATOL_POINTS, rtol=0)
            np.testing.assert_allclose(c.score, d.score, atol=ATOL_SCORES, rtol=0)


def _n_instances(labels):
    return sum(len(lf.instances) for lf in labels)


TYPE_SETS = ("single_instance", "topdown", "bottomup", "multi_class_bottomup",
             "multi_class_topdown")


def _type_paths(dirs, mc_dirs, type_set):  # noqa: F811
    if type_set == "multi_class_bottomup":
        return [mc_dirs["multi_class_bottomup"]]
    if type_set == "multi_class_topdown":
        return [mc_dirs["centroid"], mc_dirs["multi_class_topdown"]]
    return _paths(dirs, type_set)


@pytest.mark.parametrize("type_set", TYPE_SETS)
def test_run_predict_from_a_video_file_matches_jax(dirs, mc_dirs, clips,  # noqa: F811
                                                   type_set):
    paths = _type_paths(dirs, mc_dirs, type_set)
    kw = dict(batch_size=4, **KW.get(type_set, {}))
    got = prun.predict(clips.avi, paths, device="cpu", **kw)
    want = jax_predict(clips.avi, paths, **kw)
    assert_same_labels(got, want)
    assert _n_instances(got) >= N_FRAMES // 2
    assert got.videos[0].filename == clips.avi and got.videos[0].shape == want.videos[0].shape
    assert got.provenance["source_file"] == want.provenance["source_file"]
    # Frames of the file, picked out of order, as the JAX package picks them.
    picked = prun.predict(clips.avi, paths, device="cpu", frames=[7, 2, 5], **kw)
    assert_same_labels(picked, jax_predict(clips.avi, paths, frames=[7, 2, 5], **kw))


@pytest.mark.parametrize("centroid_output", ("instance", "centroid", "both"))
def test_centroid_only_matches_jax(dirs, clips, centroid_output):  # noqa: F811
    paths = _paths(dirs, "topdown")
    kw = dict(batch_size=4, centroid_only=True, centroid_output=centroid_output)
    got = prun.predict(clips.avi, paths, device="cpu", **kw)
    want = jax_predict(clips.avi, paths, **kw)
    assert_same_labels(got, want)
    assert got.provenance["model_type"] == "centroid"
    n_cent = sum(len(lf.centroids) for lf in got)
    n_inst = _n_instances(got)
    if centroid_output == "both":  # one centroid per one-node instance
        assert n_cent == n_inst >= N_FRAMES
        for lf in got:
            for inst, cent in zip(lf.instances, lf.centroids):
                np.testing.assert_array_equal(inst.points[0], cent.point)
    else:
        assert (n_cent, n_inst)[centroid_output == "instance"] >= N_FRAMES
        assert (n_inst, n_cent)[centroid_output == "instance"] == 0
    # The lone centroid dir is the same type set.
    alone = prun.predict(clips.avi, paths[:1], device="cpu", batch_size=4,
                         centroid_output=centroid_output)
    assert_same_labels(alone, got)


def test_centroid_only_needs_a_centroid_model(dirs):  # noqa: F811
    for fn, kw in ((Predictor.from_model_paths, {"device": "cpu"}),
                   (JaxPredictor.from_model_paths, {})):
        with pytest.raises(ValueError, match="requires a centroid model"):
            fn(_paths(dirs, "single_instance"), centroid_only=True, **kw)


@pytest.mark.parametrize("source", ("mp4", "images", "image", "pkg"))
def test_other_containers_match_jax(dirs, clips, source):  # noqa: F811
    """mp4v leaves coding noise where the frames were black, so features
    there are not exactly 0, and a low node peak's refinement patch can
    nearly cancel: its point then lands far off and moves with the last
    float bit in either package (PERF.md, section 6). Peaks of 0.5 and up keep
    such patches out, as ``chip_smoke.py`` phase 14 does."""
    paths = _paths(dirs, "topdown")
    if source in ("images", "image"):
        fn = clips.images if source == "images" else clips.images[3]
        data = (pvideo.Video.from_filename(fn), jvideo.Video.from_filename(fn))
    else:
        data = (getattr(clips, source),) * 2
    got = prun.predict(data[0], paths, device="cpu", batch_size=4, peak_threshold=0.5)
    want = jax_predict(data[1], paths, batch_size=4, peak_threshold=0.5)
    assert_same_labels(got, want)
    assert _n_instances(got) >= 1


@pytest.mark.parametrize("type_set", ("topdown", "single_instance"))
def test_host_resize_matches_jax(dirs, clips, type_set):  # noqa: F811
    paths = _paths(dirs, type_set)
    kw = dict(batch_size=4, host_resize=True, input_scale=0.5)
    got = prun.predict(clips.avi, paths, device="cpu", **kw)
    want = jax_predict(clips.avi, paths, **kw)
    assert_same_labels(got, want)
    assert _n_instances(got) >= 1
    # The resize runs on the host, to the same pixels, and each model keeps
    # its config's scale for the crop.
    p = Predictor.from_model_paths(paths, device="cpu", **kw)
    j = JaxPredictor.from_model_paths(paths, **kw)
    assert p._host_transform == j._host_transform == (0.5, 64, 64)  # the dirs' sizematcher
    for frames in (clips.frames[:4], np.pad(clips.frames[:4], ((0, 0), (0, 16), (0, 0), (0, 0)))):
        (pf, pfac), (jf, jfac) = p._apply_host_resize(frames), j._apply_host_resize(frames)
        assert pf.shape == jf.shape and pfac == jfac
        np.testing.assert_array_equal(pf, jf)
    assert pf.shape == (4, 32, 26, 1) and pfac == 0.5 * 0.8
    assert [m.host_scale for m in p.models] == [m.host_scale for m in j.models] == \
        [0.5] * len(paths)
    if type_set == "topdown":
        assert p.layer.crop_size == j.layer.crop_size
    # The device path resizes nothing then.
    pre = getattr(p.layer, "centroid_layer", p.layer).pre
    assert (pre.scale, pre.max_height, pre.max_width) == (1.0, None, None)


def test_host_resize_leaves_the_device_path_when_nothing_resizes(dirs, clips):  # noqa: F811
    """The dirs' sizematcher (64x64) leaves the clip's 64x64 frames as they
    are: the host passes them on untouched; stages that preprocess apart
    keep the resize on the device."""
    p = Predictor.from_model_paths(_paths(dirs, "topdown"), device="cpu", host_resize=True)
    j = JaxPredictor.from_model_paths(_paths(dirs, "topdown"), host_resize=True)
    assert p._host_transform == j._host_transform == (1.0, 64, 64)
    frames = clips.frames[:4]
    assert p._apply_host_resize(frames) == (frames, 1.0)
    apart = [prun.Predictor.from_model_paths(_paths(dirs, "bottomup"), device="cpu",
                                             host_resize=True, max_height=48)._host_transform,
             JaxPredictor.from_model_paths(_paths(dirs, "bottomup"), host_resize=True,
                                           max_height=48)._host_transform]
    assert apart == [(1.0, 48, 64)] * 2


def test_weight_swaps_match_jax(dirs, clips):  # noqa: F811
    paths = _paths(dirs, "single_instance")
    for swap in ({"backbone_ckpt_path": dirs["centroid"].cond},
                 {"head_ckpt_path": dirs["single_instance"].trained},
                 {"backbone_ckpt_path": dirs["bottomup"].cond,
                  "head_ckpt_path": dirs["single_instance"].trained}):
        got = prun.predict(clips.avi, paths, device="cpu", batch_size=4, **swap)
        want = jax_predict(clips.avi, paths, batch_size=4, **swap)
        assert_same_labels(got, want)
    # The swapped weights are the source's, and only those.
    p = Predictor.from_model_paths(paths, device="cpu",
                                   head_ckpt_path=dirs["single_instance"].trained)
    src = ModelTrainer.load_checkpoint_params(dirs["single_instance"].trained / "best.ckpt")
    own = ModelTrainer.load_checkpoint_params(dirs["single_instance"].cond / "best.ckpt")
    state = p.layer.backend.model.state_dict()
    for key, value in state.items():
        want_value = (own if key.startswith("backbone.") else src)[key]
        np.testing.assert_array_equal(value.numpy(), want_value.numpy(), err_msg=key)


@pytest.mark.parametrize("swap,match", [
    ({"head_ckpt_path": "centroid"}, "has no 'SingleInstanceConfmapsHead' subtree"),
    ({"head_ckpt_path": "other_nodes"}, "parameter shapes do not match"),
    ({"backbone_ckpt_path": "other_nodes_wide"}, "'backbone' parameter shapes do not match"),
])
def test_weight_swaps_refuse_like_jax(dirs, tmp_path, swap, match):  # noqa: F811
    def source(name):
        if name == "centroid":
            return dirs["centroid"].cond
        # A single-instance dir of 2 nodes (and wider filters).
        d = config_dict("single_instance", tmp_path)
        d["trainer_config"]["run_name"] = name
        if name.endswith("wide"):
            d["model_config"]["backbone_config"]["unet"]["filters"] = 12
        video = FrameVideo(blob_frames(4, seed=1))
        skel = pio.Skeleton(["n0", "n1"])
        labels = pio.Labels([pio.LabeledFrame(video, i, [pio.Instance(
            np.array([[20.0, 20.0], [30.0, 30.0]]), skel)]) for i in range(4)])
        trainer = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(d), [labels],
                                                             device="cpu")
        trainer.train()
        return trainer.ckpt_dir

    swap = {k: source(v) for k, v in swap.items()}
    paths = _paths(dirs, "single_instance")
    with pytest.raises(ValueError, match=match) as perr:
        Predictor.from_model_paths(paths, device="cpu", **swap)
    with pytest.raises(ValueError) as jerr:
        JaxPredictor.from_model_paths(paths, **swap)
    assert str(perr.value) == str(jerr.value)


class _Frames:
    def __init__(self, frames):
        self.frames, self.num_frames, self.shape = frames, len(frames), frames.shape

    def get_frame(self, idx, fmt=None):
        return self.frames[idx]


@pytest.mark.parametrize("type_set,flag", [("centroid", "return_confmaps"),
                                           ("bottomup", "return_paf_graph"),
                                           ("single_instance", "return_confmaps")])
def test_per_call_overrides_match_jax_and_leave_the_predictor(dirs, clips,  # noqa: F811
                                                              type_set, flag):
    paths = _paths(dirs, "topdown")[:1] if type_set == "centroid" else _paths(dirs, type_set)
    kw = dict(batch_size=4, **KW.get(type_set, {}))
    p = Predictor.from_model_paths(paths, device="cpu", **kw)
    j = JaxPredictor.from_model_paths(paths, **kw)
    layer, before = p.layer, copy.deepcopy(p.layer.__dict__.get("post"))
    got = p.predict(clips.avi, make_labels=False, **{flag: True})
    want = j.predict(clips.avi, make_labels=False, **{flag: True})
    key = "confmaps" if flag == "return_confmaps" else "pred_paf_graph"
    for g, w in zip(got, want):
        assert set(g) == set(w) and key in g
        if key == "confmaps":
            np.testing.assert_allclose(np.asarray(g[key], np.float32), np.asarray(w[key]),
                                       atol=1e-4, rtol=0)
        else:
            for (gp, ge, gep, gls), (wp, we, wep, wls) in zip(g[key], w[key]):
                np.testing.assert_array_equal(np.isnan(gp), np.isnan(wp))
                np.testing.assert_allclose(gp, wp, atol=ATOL_POINTS, rtol=0)
                np.testing.assert_array_equal(ge, we)
                np.testing.assert_array_equal(gep, wep)
                np.testing.assert_allclose(gls, wls, atol=ATOL_SCORES, rtol=0)
    # The shared predictor is unchanged: the next call returns no such key.
    assert p.layer is layer and p.layer.__dict__.get("post") == before
    plain = p.predict(clips.avi, make_labels=False)
    assert all(key not in out for out in plain)
    # An override equal to the construction's flag keeps the layer.
    assert p._scoped_postprocess_layer(**{flag: False}) is p.layer


def test_per_call_override_of_a_top_down_pair_copies_its_stages(dirs, clips):  # noqa: F811
    paths = _paths(dirs, "topdown")
    p = Predictor.from_model_paths(paths, device="cpu", batch_size=4)
    j = JaxPredictor.from_model_paths(paths, batch_size=4)
    stages = (p.layer.centroid_layer, p.layer.instance_layer)
    posts = [copy.deepcopy(s.post) for s in stages]
    scoped = p._scoped_postprocess_layer(return_confmaps=True)
    for name, stage, post in zip(("centroid_layer", "instance_layer"), stages, posts):
        copied = getattr(scoped, name)
        # Its own post config over the same weights: nothing is reloaded.
        assert copied is not stage and copied.backend is stage.backend
        assert copied.post.return_confmaps and stage.post == post
    got = p.predict(clips.avi, make_labels=False, return_confmaps=True)
    want = j.predict(clips.avi, make_labels=False, return_confmaps=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("pred_keypoints", "pred_centroids"):
            np.testing.assert_array_equal(np.isnan(g[key]), np.isnan(w[key]))
            np.testing.assert_allclose(g[key], w[key], atol=ATOL_POINTS, rtol=0)
        np.testing.assert_allclose(g["pred_peak_values"], w["pred_peak_values"],
                                   atol=ATOL_SCORES, rtol=0)
    assert p.layer.centroid_layer is stages[0] and [s.post for s in stages] == posts


# -- the source options and the output ----------------------------------------------


def _two_video_source(io, video_mod, clips, moved=False):
    """Labels over two media videos of the clip: user instances on some
    frames, predictions on others, suggestions on both videos."""
    root = clips.root
    v0 = video_mod.Video.from_filename(clips.avi)
    v1 = video_mod.Video.from_filename(str(root / ("moved" if moved else "second") / "clip.avi"))
    assert v0.shape == v1.shape  # probed: the file records grayscale, as SLEAP's do
    skel = io.Skeleton(["n0", "n1", "n2"])
    pts = np.array([[20.0, 20.0], [24.0, 24.0], [28.0, 28.0]])
    lfs = [io.LabeledFrame(v0, 0, [io.Instance(pts, skel)]),
           io.LabeledFrame(v0, 3, [io.PredictedInstance(pts, skel, point_scores=np.ones(3),
                                                        score=0.9)]),
           io.LabeledFrame(v0, 5, [io.Instance(pts, skel),
                                   io.PredictedInstance(pts, skel, point_scores=np.ones(3))]),
           io.LabeledFrame(v0, 8, []),
           io.LabeledFrame(v1, 1, [io.Instance(pts, skel)]),
           io.LabeledFrame(v1, 6, [io.PredictedInstance(pts, skel, point_scores=np.ones(3))])]
    return io.Labels(lfs, videos=[v0, v1], suggestions=[
        io.SuggestionFrame(v0, 2), io.SuggestionFrame(v1, 4), io.SuggestionFrame(v1, 6)])


OPTIONS = {
    "video_index": {"video_index": 1},
    "exclude_user_labeled": {"exclude_user_labeled": True},
    "only_labeled_frames": {"only_labeled_frames": True},
    "only_predicted_frames": {"only_predicted_frames": True},
    "both_only": {"only_labeled_frames": True, "only_predicted_frames": True},
    "no_empty_frames": {"no_empty_frames": True, "centroid_only": True,
                        "centroid_output": "both"},
    "no_empty_frames_of_centroids": {"no_empty_frames": True, "centroid_only": True,
                                     "centroid_output": "centroid"},
    "queue_maxsize": {"queue_maxsize": 9},
    "video_path_map": {"video_path_map": "SECOND=moved"},
    "suggested_of_one_video": {"video_index": 1, "only_suggested_frames": True},
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_source_options_match_jax(dirs, clips, tmp_path, option):  # noqa: F811
    for sub in ("second", "moved"):
        (clips.root / sub).mkdir(exist_ok=True)
        shutil.copy(clips.avi, clips.root / sub / "clip.avi")
    slp = tmp_path / "source.slp"
    _two_video_source(pio, pvideo, clips).save(str(slp))
    kw = dict(OPTIONS[option])
    if option == "video_path_map":
        kw["video_path_map"] = f"{clips.root / 'second'}={clips.root / 'moved'}"
    paths = _paths(dirs, "topdown")
    got = prun.predict(str(slp), paths, device="cpu", batch_size=4, **kw)
    want = jax_predict(str(slp), paths, batch_size=4, **kw)
    assert_same_labels(got, want)
    assert [v.filename for v in got.videos] == [v.filename for v in want.videos]
    assert [(got.videos.index(lf.video), lf.frame_idx) for lf in got] == \
        [(want.videos.index(lf.video), lf.frame_idx) for lf in want]
    assert got.provenance["frame_selection"] == want.provenance["frame_selection"]
    if option.startswith("no_empty_frames"):  # frames of centroids alone count as empty
        assert all(lf.instances for lf in got)
        assert len(got) == (0 if option.endswith("centroids") else 6)
    if option == "video_path_map":
        assert str(clips.root / "moved") in got.videos[1].filename


def test_video_dataset_matches_jax(dirs, clips, tmp_path, monkeypatch):  # noqa: F811
    inflated = []
    monkeypatch.setattr(hdf5, "zlib", ns(decompress=lambda b: inflated.append(1) or
                                         zlib.decompress(b)))
    # Contiguous frames in either layout, and raw frames as SLEAP writes
    # them: one gzip chunk a frame, each inflated when its frame is read
    # (not the whole video a frame).
    for name, fmt, data, opts in (
            ("last", "channels_last", clips.frames, {}),
            ("first", "channels_first", clips.frames.transpose(0, 3, 1, 2), {}),
            ("chunked", "channels_last", clips.frames,
             dict(chunks=(1,) + clips.frames.shape[1:], compression="gzip"))):
        path = tmp_path / f"{name}.h5"
        with h5py.File(path, "w") as f:
            f.create_dataset("box", data=data, **opts)
        kw = dict(batch_size=4, video_dataset="box", video_input_format=fmt)
        del inflated[:]
        got = prun.predict(str(path), _paths(dirs, "topdown"), device="cpu", **kw)
        assert len(inflated) <= 2 * N_FRAMES and bool(inflated) == bool(opts)
        want = jax_predict(str(path), _paths(dirs, "topdown"), **kw)
        assert_same_labels(got, want)
        assert _n_instances(got) >= N_FRAMES


def test_restore_source_videos_matches_jax(dirs, clips):  # noqa: F811
    out = {}
    for name, io, mod, fn in (("port", pio, pvideo, prun.predict), ("jax", jio, jvideo, None)):
        src = mod.Video.from_filename(clips.avi)
        embedded = mod.Video(str(clips.pkg), backend=_Frames(clips.frames), source_video=src)
        labels = io.Labels([io.LabeledFrame(embedded, i) for i in (1, 4, 6)])
        kw = dict(batch_size=4, restore_source_videos=True)
        res = (fn(labels, _paths(dirs, "topdown"), device="cpu", **kw) if fn
               else jax_predict(labels, _paths(dirs, "topdown"), **kw))
        assert res.videos == [src] and all(lf.video is src for lf in res)
        out[name] = res
    assert_same_labels(out["port"], out["jax"])


def test_analysis_h5_output_matches_jax(dirs, clips, tmp_path):  # noqa: F811
    paths = _paths(dirs, "topdown")
    written = {}
    for name in ("port", "jax"):
        kw = dict(batch_size=4, output_path=tmp_path / "out.predictions.slp",
                  output_format=["slp", "analysis_h5"])
        if name == "port":
            prun.predict(clips.avi, paths, device="cpu", **kw)
        else:
            jax_predict(clips.avi, paths, **kw)
        h5 = tmp_path / "out.analysis.h5"
        with h5py.File(h5, "r") as f:
            written[name] = {k: (f[k].dtype, f[k][()]) for k in f}
        h5.unlink()
    got, want = written["port"], written["jax"]
    assert sorted(got) == sorted(want)
    for key, (wd, wv) in want.items():
        gd, gv = got[key]
        assert gd == wd or key == "provenance", key  # each package's own provenance
        if key == "provenance":
            gp, wp = json.loads(gv), json.loads(wv)
            assert gp["model_type"] == wp["model_type"] == "topdown"
            assert gp["source_file"] == wp["source_file"]
        elif wd.kind == "f":
            np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv), err_msg=key)
            np.testing.assert_allclose(gv, wv, atol=ATOL_POINTS, rtol=0, err_msg=key)
        else:
            assert np.array_equal(gv, wv), key
    assert got["tracks"][1].shape[-1] == N_FRAMES
    with pytest.raises(ValueError, match="Unknown output_format"):
        prun.predict(clips.avi, paths, device="cpu", output_format="csv")
