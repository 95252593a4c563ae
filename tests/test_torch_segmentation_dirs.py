"""Port parity for the segmentation slice as a whole: model dirs trained by
the port, served by ``run.predict`` (``Predictor.from_model_paths``,
``predict``, ``to_labels``), written and read as ``.slp``, tracked,
evaluated and trained end to end by ``run_training``, against the JAX
package on the same dirs.

The port's trainer writes one dir per type (UNet filters 8, max_stride 8,
64x64 blob frames, 3-node chain, one train step on the CPU). A copy of
each gets conditioned weights, as ``tests/test_torch_model_dir.py`` does:
every bias zeroed, so that away from the blobs every feature is exactly 0
(a foreground logit of 0, a sigmoid of exactly 0.5, which no threshold of
0.5 or more passes), and the heads scaled so the centre heatmap peaks
near 1, offsets reach a few pixels and foreground logits reach 6. The JAX
package loads the port's checkpoints. Masks, polygons, centre validity and
track names must match exactly; scores to 1e-4 and centre points to 1e-4
px, but to 1e-2 px for a centre that the integral refinement put outside
the frame: there the 5x5 patch of a random-weight centre heatmap (which
goes negative) sums near 0, and the division magnifies the frameworks'
f32 rounding (maps 2e-6 apart moved one such centre by 2e-3 px).
"""

import copy
import shutil
from types import SimpleNamespace as ns

import numpy as np
import pytest
import torch

from sleap_nn_tpu import evaluation as jev
from sleap_nn_tpu import train as jtrain
from sleap_nn_tpu.inference.run import predict as jax_predict
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.io.slp import load_slp as jax_load_slp
from sleap_nn_tpu_torch import evaluation as pev
from sleap_nn_tpu_torch import train as ptrain
from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.inference import run as prun
from sleap_nn_tpu_torch.inference.loaders import load_model
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.io.slp import load_slp
from sleap_nn_tpu_torch.training import ModelTrainer
from tests.test_torch_model_dir import (
    HW,
    N_FRAMES,
    FrameVideo,
    condition,
    frames_and_labels,
)
from tests.test_torch_segmentation_train import SEG_HEADS
from tests.test_torch_pipeline import cfg_dict
from tests.test_torch_topdown import blob_frames
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

CROP = 32
TYPES = ("bottomup_segmentation", "semantic_segmentation", "centered_instance_segmentation",
         "centroid")
TYPE_SETS = {"bottomup": ("bottomup_segmentation",), "semantic": ("semantic_segmentation",),
             "topdown": ("centroid", "centered_instance_segmentation")}


def seg_config(model_type, root, **trainer):
    d = cfg_dict(model_type="centroid", batch=2, max_epochs=1, train_steps_per_epoch=1,
                 save_ckpt=True, ckpt_dir=str(root), run_name=model_type, **trainer)
    if model_type != "centroid":
        d["model_config"]["head_configs"] = {model_type: copy.deepcopy(SEG_HEADS[model_type])}
    if model_type == "centered_instance_segmentation":
        d["data_config"]["preprocessing"] = {"crop_size": CROP}
    return d


def condition_seg(model, frames):
    """Zero every bias; scale the heads: foreground logits to at most 6,
    the centre heatmap to a peak of 1, offsets to at most 4 px."""
    heads = {h.name for h in model.heads}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
        model.eval()
        out = model(torch.from_numpy(frames / np.float32(255.0)))
        for head in heads:
            y = out[head].numpy()
            if head == "SegmentationHead":
                y = np.clip(y, 1e-7, 1 - 1e-7)
                scale = 6.0 / np.abs(np.log(y / (1 - y))).max(axis=(0, 1, 2))
            elif head == "CenterOffsetHead":
                scale = 4.0 / np.abs(y).max(axis=(0, 1, 2))
            else:
                top, bottom = y.max(axis=(0, 1, 2)), y.min(axis=(0, 1, 2))
                scale = np.where(top > 0, 1 / np.maximum(top, 1e-12),
                                 1 / np.minimum(bottom, -1e-12))
            conv = next(layer[head][0] for layer in model.head_layers if head in layer)
            conv.weight.mul_(torch.from_numpy(scale.astype(np.float32))[:, None, None, None])


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg_runs")
    out = {}
    for mt in TYPES:
        frames, labels = frames_and_labels(pio, 2)
        trainer = ModelTrainer.get_model_trainer_from_config(
            PConfig.from_dict(seg_config(mt, root)), [labels], device="cpu")
        trainer.train()
        cond = root / "conditioned" / mt
        shutil.copytree(trainer.ckpt_dir, cond)
        if mt == "centroid":
            condition(trainer.model, frames, mt)
        elif mt == "centered_instance_segmentation":
            crops = np.zeros((4, CROP, CROP, 1), np.uint8)
            crops[:, 4:28, 4:28] = frames[:4, 20:44, 20:44]
            condition_seg(trainer.model, crops)
        else:
            condition_seg(trainer.model, frames)
        trainer.ckpt_dir = cond
        trainer.save_checkpoint("best.ckpt")
        out[mt] = ns(trained=trainer.ckpt_dir, cond=cond, frames=frames, labels=labels)
    return out


def _paths(dirs, type_set):
    return [str(dirs[mt].cond) for mt in TYPE_SETS[type_set]]


def _sources(seed=9):
    frames = blob_frames(N_FRAMES, seed=seed)
    return (pio.Labels([pio.LabeledFrame(FrameVideo(frames), i) for i in range(N_FRAMES)]),
            jio.Labels([jio.LabeledFrame(FrameVideo(frames), i) for i in range(N_FRAMES)]))


def assert_same_seg_labels(got, want, atol=1e-4):
    """Frames, masks (bits, scale, score, track), polygons and the centre
    instances of a bottom-up model, equal."""
    assert [lf.frame_idx for lf in got] == [lf.frame_idx for lf in want]
    for g, w in zip(got.labeled_frames, want.labeled_frames):
        assert len(g.masks) == len(w.masks) and len(g.rois) == len(w.rois)
        for gm, wm in zip(g.masks, w.masks):
            np.testing.assert_array_equal(gm.mask, wm.mask)
            assert gm.scale == wm.scale
            np.testing.assert_allclose(gm.score, wm.score, rtol=0, atol=atol)
            assert getattr(gm.track, "name", None) == getattr(wm.track, "name", None)
        for gr, wr in zip(g.rois, w.rois):
            np.testing.assert_array_equal(gr.points, wr.points)
            np.testing.assert_allclose(gr.score, wr.score, rtol=0, atol=atol)
        assert len(g.instances) == len(w.instances)
        for gi, wi in zip(g.instances, w.instances):
            inside = ((wi.points >= 0) & (wi.points < HW)).all()
            np.testing.assert_allclose(gi.points, wi.points, rtol=0,
                                       atol=atol if inside else 1e-2)
            np.testing.assert_allclose(gi.score, wi.score, rtol=0, atol=atol)
            assert gi.skeleton.node_names == wi.skeleton.node_names


def _n_masks(labels):
    return sum(len(lf.masks) + len(lf.rois) for lf in labels)


KNOBS = {
    "bottomup": [
        {},
        {"center_nms_kernel": 5, "merge_fragments": True, "distance_gate_alpha": 2.0,
         "mask_output": "both"},
        {"merge_fragments": True, "merge_method": "multicut", "merge_dilate": 2,
         "merge_w_valley": 0.5, "merge_w_offset": 1.0, "merge_thresholds": (0.5, 0.2),
         "min_mask_area": 8, "mask_cleanup_radius": 1, "max_instances": 4},
        {"full_res_masks": True, "mask_output": "polygon", "polygon_epsilon": 0.0},
        {"mask_cleanup": False, "fg_threshold": 0.6, "peak_threshold": 0.3},
    ],
    "semantic": [
        {},
        {"full_res_masks": True, "mask_output": "both"},
        {"fg_threshold": 0.6, "mask_output": "polygon", "polygon_epsilon": 0.05},
    ],
    "topdown": [
        {},
        {"fg_threshold": 0.65, "mask_output": "both", "max_instances": 2},
        {"crop_size": 24, "centroid_peak_threshold": 0.3, "min_mask_area": 20},
    ],
}
CASES = [(ts, i) for ts in KNOBS for i in range(len(KNOBS[ts]))]


@pytest.mark.parametrize("type_set,case", CASES, ids=[f"{t}-{i}" for t, i in CASES])
def test_predict_from_dirs_matches_jax(dirs, type_set, case):
    kw = KNOBS[type_set][case]
    psrc, jsrc = _sources()
    got = prun.predict(psrc, _paths(dirs, type_set), batch_size=4, device="cpu", **kw)
    want = jax_predict(jsrc, _paths(dirs, type_set), batch_size=4, **kw)
    assert_same_seg_labels(got, want)
    assert _n_masks(got) >= 3
    if kw.get("mask_output") == "polygon":
        assert all(not lf.masks for lf in got) and any(lf.rois for lf in got)
    assert got.provenance["model_type"] == want.provenance["model_type"]


@pytest.mark.parametrize("type_set", TYPE_SETS)
def test_track_save_load_and_evaluate_match_jax(dirs, type_set, tmp_path):
    """``run.predict`` with tracking (masks and mask IoU by default for a
    segmentation model), saved as ``.slp`` with masks and polygons, read
    back by both packages, then evaluated against a second prediction."""
    psrc, jsrc = _sources()
    kw = dict(batch_size=4, tracking=True, mask_output="both", window_size=3)
    got = prun.predict(psrc, _paths(dirs, type_set), device="cpu",
                       output_path=tmp_path / "p.slp", **kw)
    want = jax_predict(jsrc, _paths(dirs, type_set), output_path=str(tmp_path / "j.slp"), **kw)
    assert_same_seg_labels(got, want)
    assert got.provenance["tracking"]["features"] == "masks" \
        if "tracking" in got.provenance else True
    assert [t.name for t in got.tracks] == [t.name for t in want.tracks] and got.tracks
    for back, written in ((load_slp(tmp_path / "p.slp"), got),
                          (jax_load_slp(str(tmp_path / "p.slp")), got),
                          (load_slp(tmp_path / "j.slp"), want)):
        assert_same_seg_labels(back, written, atol=1e-6)
    psrc2, jsrc2 = _sources()
    other = {"fg_threshold": 0.6}
    gt_p = prun.predict(psrc2, _paths(dirs, type_set), device="cpu", **other)
    gt_j = jax_predict(jsrc2, _paths(dirs, type_set), **other)
    method = "semantic" if type_set == "semantic" else "mask"
    from tests.test_torch_evaluation import assert_same

    assert_same(jev.run_evaluation(gt_j, want, match_method=method, user_labels_only=False),
                pev.run_evaluation(gt_p, got, match_method=method, user_labels_only=False))


def test_load_model_builds_the_segmentation_types(dirs):
    for mt in TYPES[:3]:
        m = load_model(dirs[mt].cond)
        assert m.model_type == mt
        assert [h.name for h in m.model.heads] == {
            "bottomup_segmentation": ["SegmentationHead", "InstanceCenterHead",
                                      "CenterOffsetHead"]}.get(mt, ["SegmentationHead"])


@pytest.mark.parametrize("model_type", TYPES[:3])
def test_run_training_evaluates_splits_like_jax(model_type, tmp_path, capsys):
    """``run_training`` trains, writes the dir and runs the post-training
    evaluation of each split as the JAX package's ``_eval_split`` does:
    the OKS branch, which finds no instance to score for a bottom-up
    segmentation model trained one step (no centre clears the threshold)
    nor for a semantic model (masks only), and a refused type set for a
    lone centered-instance segmentation model."""
    frames, labels = frames_and_labels(pio, 2)
    trainer = ptrain.run_training(PConfig.from_dict(seg_config(model_type, tmp_path / "p")),
                                  [labels], device="cpu")
    assert trainer.ckpt_dir is not None and (trainer.ckpt_dir / "best.ckpt").exists()
    printed = capsys.readouterr().out
    _, jlabels = frames_and_labels(jio, 2)

    def outcome(fn, *args):
        try:
            m = fn(*args)
        except Exception as e:  # noqa: BLE001 (run_training catches and prints it)
            return ("raises", type(e).__name__)
        if m is None:
            return None
        return sorted(m)

    got = outcome(ptrain._eval_split, trainer.ckpt_dir, model_type, "val", 0,
                  trainer.val_labels[0], 0.2, "cpu")
    want = outcome(jtrain._eval_split, trainer.ckpt_dir, model_type, "val", 0,
                   jlabels.extract([lf.frame_idx for lf in trainer.val_labels[0]]))
    assert got == want
    expected = {"bottomup_segmentation": None,
                "semantic_segmentation": None,
                "centered_instance_segmentation": ("raises", "ValueError")}[model_type]
    assert got == expected
    if expected is None:
        assert "no usable predictions" in printed
    else:
        assert "Post-training eval failed" in printed


def test_eval_split_oks_branch_on_found_centres_matches_jax(dirs, tmp_path):
    """The conditioned bottom-up segmentation dir finds centres: the OKS
    branch then holds its one-node centre instances against the 3-node
    ground truth, and ``compute_oks`` fails on the node counts with a
    ``ValueError``, in the port as in the JAX package (``run_training``
    prints it and goes on)."""
    d = dirs["bottomup_segmentation"]
    work = tmp_path / "dir"
    shutil.copytree(d.cond, work)
    _, jlabels = frames_and_labels(jio, 2)

    def outcome(fn, labels, *args):
        try:
            fn(work, "bottomup_segmentation", "val", 0, labels, *args)
        except Exception as e:  # noqa: BLE001
            return type(e).__name__
        return None

    assert outcome(ptrain._eval_split, d.labels, 0.2, "cpu") == \
        outcome(jtrain._eval_split, jlabels) == "ValueError"
    assert (work / "labels_pr.val_0.slp").exists()  # saved before the evaluation


@pytest.mark.parametrize("model_type", TYPES[:3])
def test_jax_trained_orbax_segmentation_dir_converts(model_type, tmp_path):
    """A segmentation dir of the JAX trainer (an orbax checkpoint) converts
    with ``tools/orbax_to_torch.py``: the port loads every head's flax
    parameters bit for bit, the JAX package reads the converted file back
    to the same params, and both predict the same foreground maps."""
    pytest.importorskip("orbax.checkpoint")
    import jax

    from sleap_nn_tpu.config import TrainingJobConfig as JConfig
    from sleap_nn_tpu.inference.predictor import Predictor as JaxPredictor
    from sleap_nn_tpu.training import ModelTrainer as JTrainer
    from sleap_nn_tpu_torch.inference.layers import to_host
    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from tests.test_torch_model_dir import _orbax_to_torch
    from sleap_nn_tpu.inference.loaders import load_model as jax_load_model

    _, labels = frames_and_labels(jio, 2)
    jt = JTrainer.get_model_trainer_from_config(
        JConfig.from_dict(seg_config(model_type, tmp_path)), [labels])
    jt.train()
    run = jt.ckpt_dir
    assert (run / "best.ckpt").is_dir()
    converted = _orbax_to_torch().convert(run, tmp_path / "converted")
    loaded = load_model(converted)
    assert loaded.model_type == model_type
    orig = dict(jax.tree_util.tree_leaves_with_path(jax.device_get(jt.params)))
    back = jax.tree_util.tree_leaves_with_path(jax_load_model(converted).params)
    assert len(back) == len(orig)
    for path, leaf in back:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(orig[path]))
    if model_type == "centered_instance_segmentation":
        return  # served beside a centroid model only
    frames = blob_frames(4, seed=9)
    got = to_host(Predictor.from_model_paths([converted], device="cpu").layer.predict_async(
        frames))
    want = jax.device_get(JaxPredictor.from_model_paths([run]).layer.predict_async(frames))
    np.testing.assert_allclose(got["fg"], np.asarray(want["fg"]), rtol=0, atol=1e-5)
