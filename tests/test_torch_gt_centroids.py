"""Port parity: prediction with a lone centered-instance model on
ground-truth centroids (``LabelsProvider(with_centroids=True)``,
``GTCentroidTopDownLayer``, ``Predictor.from_model_paths``,
``run.predict`` and the command line) against the JAX package, on the
CPU.

Frames are black with bright Gaussian blobs (``blob_frames``), and the
labels' instances sit around the blobs: user instances, predicted
instances with scores, mixed frames, an instance whose anchor node is
missing and one with no visible point. The model is a port-trained
centered-instance dir whose weights are conditioned as in
``tests/test_torch_model_dir.py`` (biases zeroed, the head scaled so the
maps reach about 1 on the blobs); both packages load that dir. Provider
batches match exactly; keypoints and peak values to 1e-4, scores to
1e-6, validity and counts exactly. A few crops put a strong peak beside
negative map values, where the integral refinement's patch mass nearly
cancels and throws the point far outside the frame (about 150 px off);
there the division amplifies the f32 rounding of the maps by orders of
magnitude, so such points (outside the frame in the JAX result) must lie
outside the frame in the port's too and agree to 1e-3 relative.
"""

import copy
import shutil

import numpy as np
import pytest
from click.testing import CliRunner

from sleap_nn_tpu import cli as jcli
from sleap_nn_tpu.inference import layers as jl
from sleap_nn_tpu.inference.backends import JaxBackend
from sleap_nn_tpu.inference.predictor import Predictor as JaxPredictor
from sleap_nn_tpu.inference.providers import LabelsProvider as JaxLabelsProvider
from sleap_nn_tpu.inference.run import predict as jax_predict
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.io.slp import load_slp as jax_load_slp
from sleap_nn_tpu_torch import cli as pcli
from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.inference import layers as tl
from sleap_nn_tpu_torch.inference import run as prun
from sleap_nn_tpu_torch.inference.backends import TorchBackend
from sleap_nn_tpu_torch.inference.predictor import UNPORTED_KNOBS, Predictor
from sleap_nn_tpu_torch.inference.providers import LabelsProvider
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.io.slp import load_slp
from sleap_nn_tpu_torch.io.video import Video
from sleap_nn_tpu_torch.training import ModelTrainer
from tests.test_torch_model_dir import FrameVideo, condition, config_dict, frames_and_labels
from tests.test_torch_run_video import write_clip
from tests.test_torch_topdown import HW, _model_pair, blob_frames
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

N_FRAMES, SEED = 7, 11
NODES = ["n0", "n1", "n2"]


def blob_centres(n, seed):
    """The blob centres ``(x, y)`` of ``blob_frames(n, seed)``, by the same draws."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        frame = []
        for _ in range(2):
            cy, cx = rng.uniform(12, HW - 12, 2)
            frame.append((cx, cy))
        out.append(frame)
    return out


def gt_labels(io, video, seed=SEED):
    """Labels on ``video`` (frames of ``blob_frames(N_FRAMES, seed)``):
    per frame 0-2 user instances and 0-2 predicted ones (scored) around the
    blobs; frame 1 has an instance without its anchor node ``n0``, frame 2
    one with no visible point, frame 3 five instances."""
    rng = np.random.default_rng(seed + 1)
    skel = io.Skeleton(NODES, edges=[(0, 1), (1, 2)])
    lfs = []
    for f, centres in enumerate(blob_centres(N_FRAMES, seed)):
        insts = []
        n_user = int(rng.integers(0, 3))
        n_pred = int(rng.integers(0 if n_user else 1, 3))
        for i in range(n_user + n_pred + (3 if f == 3 else 0)):
            pts = np.asarray(centres[i % 2]) + rng.normal(0, 3, (3, 2))
            if i < n_user:
                insts.append(io.Instance(pts, skel))
            else:
                insts.append(io.PredictedInstance(pts, skel, point_scores=rng.uniform(0, 1, 3),
                                                  score=float(rng.uniform(0.1, 1.0))))
        if f == 1:
            pts = np.asarray(centres[0]) + rng.normal(0, 3, (3, 2))
            pts[0] = np.nan
            insts.insert(0, io.Instance(pts, skel))
        if f == 2:
            insts.insert(0, io.Instance(np.full((3, 2), np.nan), skel))
        lfs.append(io.LabeledFrame(video, f, insts))
    return io.Labels(lfs, videos=[video], skeletons=[skel])


# -- the provider --------------------------------------------------------------------


@pytest.mark.parametrize("anchor", [None, 0, 2])
@pytest.mark.parametrize("user_only", [False, True])
@pytest.mark.parametrize("k", [2, 20])
def test_labels_provider_gt_centroids_match(anchor, user_only, k):
    frames = blob_frames(N_FRAMES, seed=SEED)
    video = FrameVideo(frames)
    jlab, plab = gt_labels(jio, video), gt_labels(pio, video)
    kw = dict(batch_size=3, with_centroids=True, max_instances=k, anchor_ind=anchor,
              user_frames_only=user_only)
    want = list(JaxLabelsProvider(jlab, **kw)._gen())
    got = list(LabelsProvider(plab, **kw)._gen())
    assert len(got) == len(want) == (2 if user_only else 3)
    for g, w in zip(got, want):
        for name in ("frames", "frame_inds", "video_inds", "valid", "gt_centroids",
                     "gt_centroid_valid", "gt_centroid_vals"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.shape == b.shape and a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    last = got[-1]
    assert not last.valid.all()  # a short last batch: its pad slots are NaN / invalid
    assert np.isnan(last.gt_centroids[~last.valid]).all()
    assert not last.gt_centroid_valid[~last.valid].any()
    # Without the flag the batch carries no centroids.
    plain = next(iter(LabelsProvider(plab, batch_size=3)._gen()))
    assert plain.gt_centroids is None and plain.gt_centroid_valid is None


def test_labels_provider_falls_back_to_the_visible_mean():
    """Frame 1's first instance lacks its anchor ``n0``: its centroid is the
    mean of its visible points; frame 2's first instance has no visible
    point: its slot stays invalid, and the next instance keeps its slot."""
    video = FrameVideo(blob_frames(N_FRAMES, seed=SEED))
    plab = gt_labels(pio, video)
    batch = next(iter(LabelsProvider(plab, batch_size=3, with_centroids=True,
                                     anchor_ind=0)._gen()))
    pts = plab[1].instances[0].numpy()
    np.testing.assert_allclose(batch.gt_centroids[1, 0], np.nanmean(pts, axis=0), rtol=1e-6)
    assert not batch.gt_centroid_valid[2, 0] and batch.gt_centroid_valid[2, 1]
    np.testing.assert_allclose(batch.gt_centroids[0, 0], plab[0].instances[0].numpy()[0],
                               rtol=1e-6)


# -- the layer ----------------------------------------------------------------------


@pytest.mark.parametrize("pre", [dict(ensure_grayscale=True, max_stride=8),
                                 dict(ensure_grayscale=True, max_stride=8, scale=0.5),
                                 dict(ensure_grayscale=True, max_stride=8, max_height=80,
                                      max_width=96)],
                         ids=["plain", "scale", "sizematch"])
def test_gt_centroid_layer_matches_jax(pre):
    frames = blob_frames(4, seed=SEED)
    fm, fp, tm, sd = _model_pair("centered_instance", frames, seed=1)
    jlayer = jl.GTCentroidTopDownLayer(
        jl.CenteredInstanceLayer(JaxBackend(fm, fp), jl.PreprocessConfig(**pre),
                                 jl.PostprocessConfig(peak_threshold=0.2), output_stride=2),
        max_instances=3, crop_size=32)
    tlayer = tl.GTCentroidTopDownLayer(
        tl.CenteredInstanceLayer(TorchBackend(tm, sd, fused_convs=True, device="cpu"),
                                 tl.PreprocessConfig(**pre),
                                 tl.PostprocessConfig(peak_threshold=0.2), output_stride=2,
                                 device="cpu"),
        max_instances=3, crop_size=32, device="cpu")
    cents = np.full((4, 3, 2), np.nan, np.float32)
    valid = np.zeros((4, 3), bool)
    for f, centres in enumerate(blob_centres(4, SEED)):
        for i, c in enumerate(centres[: 1 + f % 2]):
            cents[f, i], valid[f, i] = c, True
    vals = np.linspace(0.2, 0.9, 12, dtype=np.float32).reshape(4, 3)
    for cv in (vals, None):
        want = jlayer.predict_async(frames, cents, valid, cv)
        want = {k: np.asarray(v) for k, v in jlayer.finalize(want).items()}
        got = tlayer.finalize(tlayer.predict_async(frames, cents, valid, cv))
        assert set(got) == set(want)
        for k in want:
            w, g = want[k], got[k]
            assert g.shape == w.shape, k
            if w.dtype == bool:
                np.testing.assert_array_equal(g, w, err_msg=k)
            else:
                np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
                np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=k)
        kp = got["pred_keypoints"]
        assert np.isfinite(kp[valid]).all() and np.isnan(kp[~valid]).all()
        assert (got["pred_peak_values"][~valid] == 0).all()
        want_vals = np.ones_like(vals) if cv is None else vals
        np.testing.assert_array_equal(got["pred_instance_scores"][valid], want_vals[valid])


# -- from model dirs ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def ci_dir(tmp_path_factory):
    """A port-trained centered-instance dir, conditioned on the blob frames."""
    root = tmp_path_factory.mktemp("gt_runs")
    frames, labels = frames_and_labels(pio, 2)
    trainer = ModelTrainer.get_model_trainer_from_config(
        PConfig.from_dict(copy.deepcopy(config_dict("centered_instance", root))), [labels],
        device="cpu")
    trainer.train()
    cond = root / "conditioned"
    shutil.copytree(trainer.ckpt_dir, cond)
    condition(trainer.model, blob_frames(N_FRAMES, seed=SEED), "centered_instance")
    trainer.ckpt_dir = cond
    trainer.save_checkpoint("best.ckpt")
    return cond


def _assert_same_labels(got, want, atol=1e-4):
    assert [lf.frame_idx for lf in got] == [lf.frame_idx for lf in want]
    n = 0
    for g, w in zip(got.labeled_frames, want.labeled_frames):
        gp = [i for i in g.instances if type(i).__name__ == "PredictedInstance"]
        wp = [i for i in w.instances if type(i).__name__ == "PredictedInstance"]
        assert len(gp) == len(wp), g.frame_idx
        for gi, wi in zip(gp, wp):
            a, b = gi.numpy(), wi.numpy()
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            inside = ((b >= 0) & (b < HW)).all(axis=-1)
            np.testing.assert_allclose(a[inside], b[inside], atol=atol, rtol=0)
            assert not ((a[~inside] >= 0) & (a[~inside] < HW)).all(axis=-1).any()
            np.testing.assert_allclose(a[~inside], b[~inside], atol=0, rtol=1e-3)
            np.testing.assert_allclose(gi.point_scores, wi.point_scores, atol=atol, rtol=0)
            np.testing.assert_allclose(gi.score, wi.score, atol=1e-6, rtol=0)
            n += 1
    return n


def test_from_model_paths_builds_the_gt_layer(ci_dir):
    assert "anchor_part" not in UNPORTED_KNOBS
    pred = Predictor.from_model_paths([ci_dir], device="cpu", max_instances=4)
    jpred = JaxPredictor.from_model_paths([ci_dir], max_instances=4)
    assert isinstance(pred.layer, tl.GTCentroidTopDownLayer) and pred.layer.needs_gt_centroids
    assert pred.model_type == jpred.model_type == "topdown"
    assert pred.layer.crop_size == jpred.layer.crop_size
    assert pred.layer.max_instances == jpred.layer.max_instances == 4
    assert pred.layer.anchor_ind is None
    assert Predictor.from_model_paths([ci_dir], device="cpu", anchor_part="n2").layer.anchor_ind \
        == JaxPredictor.from_model_paths([ci_dir], anchor_part="n2").layer.anchor_ind == 2
    errors = []
    for fn, kw in ((Predictor.from_model_paths, {"device": "cpu"}),
                   (JaxPredictor.from_model_paths, {})):
        with pytest.raises(ValueError, match="not a skeleton node") as info:
            fn([ci_dir], anchor_part="tail", **kw)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_video_sources_are_refused_like_jax(ci_dir, tmp_path):
    clip = write_clip(tmp_path / "clip.avi", blob_frames(3, seed=SEED))
    pred = Predictor.from_model_paths([ci_dir], device="cpu")
    jpred = JaxPredictor.from_model_paths([ci_dir])
    for src_p, src_j in ((clip, clip), (FrameVideo(blob_frames(3)), None)):
        with pytest.raises(ValueError) as got:
            pred.predict(src_p)
        if src_j is not None:
            with pytest.raises(ValueError) as want:
                jpred.predict(src_j)
            assert str(got.value) == str(want.value)
            assert "GROUND-TRUTH" in str(got.value)
        else:
            assert str(got.value) == "Centered-instance-only inference needs a .slp source."
    with pytest.raises(ValueError, match="GROUND-TRUTH"):
        prun.predict(clip, [ci_dir], device="cpu")


@pytest.mark.parametrize("kw", [{}, {"anchor_part": "n0"}, {"only_labeled_frames": True},
                                {"max_instances": 1, "batch_size": 2},
                                {"anchor_part": "n1", "only_labeled_frames": True}],
                         ids=["default", "anchor", "only_labeled", "max_instances_1",
                              "anchor_only_labeled"])
def test_run_predict_gt_matches_jax(ci_dir, kw):
    frames = blob_frames(N_FRAMES, seed=SEED)
    video = FrameVideo(frames)
    kw = {"batch_size": 3, "peak_threshold": 0.2, **kw}
    want = jax_predict(gt_labels(jio, video), [ci_dir], **kw)
    got = prun.predict(gt_labels(pio, video), [ci_dir], device="cpu", **kw)
    n = _assert_same_labels(got, want)
    assert n >= 5
    scores = sorted({round(i.score, 6) for lf in got for i in lf.instances})
    assert 1.0 in scores  # user instances score 1.0 ...
    if not kw.get("only_labeled_frames"):
        assert len(scores) > 2  # ... predicted ones carry their source score
    else:
        assert scores == [1.0]  # a mixed frame gives its user instances alone
        assert {lf.frame_idx for lf in got} <= {lf.frame_idx for lf in gt_labels(pio, video)
                                                 if lf.user_instances}


def test_gt_predictions_sit_on_the_source_instances(ci_dir):
    """Each predicted instance lies within a few pixels of its source
    instance's points (the crop lands where the ground truth is)."""
    video = FrameVideo(blob_frames(N_FRAMES, seed=SEED))
    src = gt_labels(pio, video)
    got = prun.predict(src, [ci_dir], device="cpu", batch_size=3, make_labels=False)
    for out in got:
        for i in np.nonzero(out["valid"])[0]:
            lf = src[int(out["frame_inds"][i])]
            for k in np.nonzero(out["instance_valid"][i])[0]:
                kp = out["pred_keypoints"][i, k]
                kp = kp[((kp >= 0) & (kp < HW)).all(axis=-1)]  # not the refinement's outliers
                if len(kp):
                    c = out["pred_centroids"][i, k]
                    assert np.abs(kp.mean(axis=0) - c).max() < 16


def _slp_pair(tmp_path):
    """The labels of ``gt_labels`` (mixed frames: user and predicted
    instances) as a ``.pkg.slp`` the port wrote, its frames embedded
    (lossless PNG, so the blob frames stay exact)."""
    path = tmp_path / "gt.pkg.slp"
    gt_labels(pio, FrameVideo(blob_frames(N_FRAMES, seed=SEED))).save(str(path), embed=True)
    return path


def test_labels_source_on_a_gray_clip_decodes_like_jax(ci_dir, tmp_path):
    """A ``.slp`` on an MJPG clip of gray content: as the JAX predictor
    (whose start log reads the first video's shape), the port's finds the
    gray content before the first batch, and the frames decode to one
    channel in both."""
    clip = write_clip(tmp_path / "clip.avi", blob_frames(N_FRAMES, seed=SEED))
    path = tmp_path / "gt.slp"
    gt_labels(pio, Video.from_filename(clip)).save(str(path))
    shapes = []
    for pred, load, kw in ((Predictor.from_model_paths([ci_dir], device="cpu", batch_size=3),
                            load_slp, {}),
                           (JaxPredictor.from_model_paths([ci_dir], batch_size=3),
                            lambda p: jax_load_slp(str(p)), {})):
        labels = load(path)
        out = pred.predict(labels, make_labels=False, **kw)
        shapes.append((labels[0].image.shape, len(out)))
    assert shapes[0] == shapes[1] == ((64, 64, 1), 3)


@pytest.mark.parametrize("extra", [[], ["--anchor_part", "n0"], ["--only-labeled-frames"],
                                   ["--anchor-part", "n2", "--only_labeled_frames"]],
                         ids=["default", "anchor", "only_labeled", "both"])
def test_cli_predict_gt_matches_jax(ci_dir, tmp_path, extra):
    slp = _slp_pair(tmp_path)
    argv = ["predict", "-i", str(slp), "-m", str(ci_dir), "--device", "cpu", "-b", "3",
            "--peak-threshold", "0.2"] + extra
    assert pcli.main(argv + ["-o", str(tmp_path / "port.slp")]) == 0
    res = CliRunner().invoke(jcli.cli, argv + ["-o", str(tmp_path / "jax.slp")])
    assert res.exit_code == 0, res.output
    got, want = load_slp(tmp_path / "port.slp"), load_slp(tmp_path / "jax.slp")
    assert _assert_same_labels(got, want) >= 5
    assert len(jax_load_slp(str(tmp_path / "port.slp"))) == len(got)
    # In-process, with the kwargs the command passes, the same Labels.
    kw = {"anchor_part": extra[extra.index("--anchor_part") + 1] if "--anchor_part" in extra
          else extra[extra.index("--anchor-part") + 1] if "--anchor-part" in extra else None,
          "only_labeled_frames": any("only" in a for a in extra)}
    direct = prun.predict(str(slp), [ci_dir], device="cpu", batch_size=3, peak_threshold=0.2,
                          **kw)
    assert _assert_same_labels(got, direct, atol=0) == _assert_same_labels(got, want)


def test_cli_refuses_a_video_source_like_jax(ci_dir, tmp_path):
    clip = write_clip(tmp_path / "clip.avi", blob_frames(3, seed=SEED))
    argv = ["predict", "-i", clip, "-m", str(ci_dir), "--device", "cpu",
            "-o", str(tmp_path / "o.slp")]
    res = CliRunner().invoke(jcli.cli, argv)
    assert res.exit_code == 1 and isinstance(res.exception, ValueError)
    with pytest.raises(ValueError) as info:
        pcli.main(argv)
    assert str(info.value) == str(res.exception)
    with pytest.raises(ValueError, match="not a skeleton node"):
        pcli.main(argv[:1] + ["-i", str(_slp_pair(tmp_path))] + argv[3:] + ["--anchor_part",
                                                                             "tail"])


def test_gt_layer_runs_on_the_card_unless_asked(ci_dir, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor.from_model_paths([ci_dir])
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.GTCentroidTopDownLayer(None)
