"""Port parity: ``SegmentationMask``, ``LabeledFrame.masks`` and the ``.slp``
mask rows against the JAX package.

A ``.slp`` with masks written by the JAX package (h5py) is read by the
port, and one the port writes (its own HDF5 writer, the mask bits as a
contiguous variable-length dataset) is read by the JAX package's
``load_slp``: masks bit-identical, scores, scales and tracks equal, in
both directions.
"""

import h5py
import numpy as np
import pytest

from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.io.slp import load_slp as jax_load_slp
from sleap_nn_tpu.io.slp import save_slp as jax_save_slp
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.io.slp import load_slp, save_slp
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)


def _mask(rng, hw):
    m = rng.random(hw) < 0.3
    m[0, 0] = True
    return m


def build(io, seed=0):
    """Labels whose frames hold instances and masks: several shapes (odd
    sizes, so the packed bits pad), scales, scores and tracks; a frame with
    masks only and a mask on a frame without instances."""
    rng = np.random.default_rng(seed)
    skel = io.Skeleton(["a", "b"])
    tracks = [io.Track("t0"), io.Track("t1")]
    lfs = []
    for f in range(4):
        insts = [io.PredictedInstance(rng.uniform(0, 30, (2, 2)), skel, score=0.5)] \
            if f != 2 else []
        masks = [io.SegmentationMask(_mask(rng, (17 + f, 23 - f)), score=float(rng.random()),
                                     track=tracks[k % 2] if f % 2 else None,
                                     scale=[1.0, 2.0, 4.0][k % 3])
                 for k in range(1 + f % 3)]
        lfs.append(io.LabeledFrame(None, f, insts, masks=masks))
    return io.Labels(lfs, skeletons=[skel], tracks=tracks)


def assert_same_masks(got, want):
    assert len(got.labeled_frames) == len(want.labeled_frames)
    for g, w in zip(got.labeled_frames, want.labeled_frames):
        assert g.frame_idx == w.frame_idx and len(g.masks) == len(w.masks)
        for gm, wm in zip(g.masks, w.masks):
            assert gm.mask.dtype == np.bool_
            np.testing.assert_array_equal(gm.mask, wm.mask)
            assert (gm.score, gm.scale) == (wm.score, wm.scale)
            assert getattr(gm.track, "name", None) == getattr(wm.track, "name", None)


def test_jax_written_masks_read_by_the_port(tmp_path):
    labels = build(jio)
    jax_save_slp(tmp_path / "j.slp", labels)
    assert_same_masks(load_slp(tmp_path / "j.slp"), labels)
    assert_same_masks(load_slp(tmp_path / "j.slp"), jax_load_slp(tmp_path / "j.slp"))


def test_port_written_masks_read_by_jax(tmp_path):
    labels = build(pio)
    save_slp(tmp_path / "p.slp", labels)
    assert_same_masks(jax_load_slp(tmp_path / "p.slp"), labels)
    assert_same_masks(load_slp(tmp_path / "p.slp"), labels)
    with h5py.File(tmp_path / "p.slp", "r") as f:
        ds = f["pred_masks_data"]
        assert ds.chunks is None and ds.compression is None  # contiguous, as h5py writes it
        assert h5py.check_vlen_dtype(ds.dtype) == np.uint8
    # The rows equal the JAX writer's.
    jax_save_slp(tmp_path / "j.slp", build(jio))
    with h5py.File(tmp_path / "p.slp", "r") as f, h5py.File(tmp_path / "j.slp", "r") as g:
        assert list(f["pred_masks_json"][:]) == list(g["pred_masks_json"][:])
        for a, b in zip(f["pred_masks_data"][:], g["pred_masks_data"][:]):
            np.testing.assert_array_equal(a, b)


def test_no_masks_write_no_mask_rows(tmp_path):
    labels = build(pio)
    for lf in labels.labeled_frames:
        lf.masks = []
    save_slp(tmp_path / "p.slp", labels)
    with h5py.File(tmp_path / "p.slp", "r") as f:
        assert "pred_masks_json" not in f and "pred_masks_data" not in f
    assert all(not lf.masks for lf in load_slp(tmp_path / "p.slp"))


@pytest.mark.parametrize("scale,out_hw", [(1.0, None), (2.0, None), (2.5, None),
                                          (2.0, (30, 50)), (1.0, (5, 6)), (4.0, (70, 70))])
def test_segmentation_mask_matches(scale, out_hw):
    rng = np.random.default_rng(1)
    m = _mask(rng, (13, 17))
    j, p = jio.SegmentationMask(m, score=0.25, scale=scale), \
        pio.SegmentationMask(m, score=0.25, scale=scale)
    assert (p.area, p.image_area, p.score, p.scale) == (j.area, j.image_area, j.score, j.scale)
    np.testing.assert_array_equal(p.decode(out_hw), j.decode(out_hw))
    np.testing.assert_array_equal(p.centroid(), j.centroid())
    empty = np.zeros((4, 6), bool)
    np.testing.assert_array_equal(pio.SegmentationMask(empty).centroid(),
                                  jio.SegmentationMask(empty).centroid())
    assert repr(p) == repr(j)


def test_labels_edits_carry_masks():
    """Split, extract, clean and the training splits keep each frame's masks
    with the frame, as in the JAX package."""
    jl, pl = build(jio), build(pio)
    for lab, io in ((jl, jio), (pl, pio)):
        for lf in lab.labeled_frames:
            lf.instances = [io.Instance(np.ones((2, 2)), lab.skeletons[0])] if lf.frame_idx != 2 \
                else []
    for op in (lambda lab: lab.split(2, seed=3), lambda lab: (lab.extract([3, 1]),),
               lambda lab: lab.make_training_splits(0.5, seed=1)):
        for g, w in zip(op(pl), op(jl)):
            assert_same_masks(g, w)
    for lab in (jl, pl):
        lab.clean(frames=True)
    assert_same_masks(pl, jl)
    assert [lf.frame_idx for lf in pl] == [0, 1, 3]
