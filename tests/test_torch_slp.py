"""Port parity: ``.slp`` files (``io/slp.py``), embedded frames
(``io/png.py``, ``io/video.py``) and the incremental writer, against the
JAX package.

The same labels are built in both packages from a numpy seed: a skeleton
with edges and a symmetry, a track, user instances (NaN points, a point
with coordinates but not visible, ``complete`` flags, one made from a
prediction), predicted instances with scores and tracking scores, an empty
(negative) frame, suggestions on both videos, a polygon ROI, user and
predicted centroids, provenance, and two videos: 1-channel and RGB frames.
Each package writes them, with frames embedded and without. Every HDF5
dataset and attribute of the two files has the same name, dtype and
values (NaN equal to NaN), except the embedded PNG bytes: the two
encoders compress differently, so those rows are compared by their
pixels, decoded with cv2. Each package's ``load_slp`` reads the other's
file to labels equal to its own, and embedded pixels come back
identical.
"""

import json

import cv2
import h5py
import numpy as np
import pytest

from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.io import video as jvideo
from sleap_nn_tpu.io.slp import load_slp as jax_load_slp
from sleap_nn_tpu.io.slp import save_slp as jax_save_slp
from sleap_nn_tpu_torch.inference.writer import IncrementalLabelsWriter
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.io import video as pvideo
from sleap_nn_tpu_torch.io.png import decode_png, encode_png
from sleap_nn_tpu_torch.io.slp import load_slp, save_slp
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)


class ArrayBackend:
    """Frames held in memory, as a ``Video`` backend of either package."""

    def __init__(self, frames):
        self.frames = frames
        self.num_frames = len(frames)
        self.shape = frames.shape

    def get_frame(self, idx, fmt=None):
        return self.frames[idx]


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (6, 24, 32, 1), dtype=np.uint8),
            rng.integers(0, 256, (5, 20, 16, 3), dtype=np.uint8))


def build_labels(io, video_mod, seed=0):
    rng = np.random.default_rng(seed)
    gray, rgb = _frames(seed)
    videos = [video_mod.Video("gray.mp4", backend=ArrayBackend(gray)),
              video_mod.Video("rgb.mp4", backend=ArrayBackend(rgb))]
    skel = io.Skeleton(["head", "left", "right"], edges=[(0, 1), (0, 2)],
                       symmetries=[(1, 2)], name="mouse")
    track = io.Track(name="t0", spawned_on=2)
    lfs = []
    for f, (vi, fi) in enumerate([(0, 0), (0, 3), (1, 1), (1, 4), (0, 5)]):
        insts = []
        pred = io.PredictedInstance(rng.uniform(0, 16, (3, 2)), skel,
                                    point_scores=rng.random(3), score=float(rng.random()),
                                    track=track if f % 2 else None,
                                    tracking_score=float(rng.random()))
        pts = rng.uniform(0, 16, (3, 2))
        pts[f % 3] = np.nan
        visible = ~np.isnan(pts[:, 0])
        visible[(f + 1) % 3] = False  # coordinates kept, not visible
        user = io.Instance(pts, skel, track=track if f == 1 else None, visible=visible,
                           complete=rng.random(3) < 0.5,
                           from_predicted=pred if f == 2 else None)
        if f != 4:  # frame 4 is a negative frame
            insts = [user, pred] if f != 3 else [pred]
        lf = io.LabeledFrame(videos[vi], fi, insts)
        if f == 1:
            lf.rois = [io.PredictedROI(rng.uniform(0, 16, (4, 2)), score=0.7, track=track)]
            lf.centroids = [io.UserCentroid(rng.uniform(0, 16, 2)),
                            io.PredictedCentroid(rng.uniform(0, 16, 2), score=0.4)]
        lfs.append(lf)
    return io.Labels(lfs, videos=videos, skeletons=[skel], tracks=[track],
                     provenance={"source": "test", "n": 1},
                     suggestions=[io.SuggestionFrame(videos[1], 2, group=1),
                                  io.SuggestionFrame(videos[0], 1)])


def _datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            out[name] = (obj[()] if isinstance(obj, h5py.Dataset) else None,
                         obj.dtype if isinstance(obj, h5py.Dataset) else None,
                         {k: obj.attrs[k] for k in obj.attrs})
        f.visititems(visit)
        out["/"] = (None, None, {k: f.attrs[k] for k in f.attrs})
    return out


def _equal_values(a, b):
    if a.dtype.names:
        return all(_equal_values(a[n], b[n]) for n in a.dtype.names)
    if a.dtype.kind == "f":
        return np.array_equal(a, b, equal_nan=True)
    return np.array_equal(a, b)


def _attr_value(name, key, value):
    if key == "json":
        return json.loads(value)
    return np.asarray(value).tolist() if isinstance(value, np.ndarray) else value


@pytest.mark.parametrize("embed", [False, True])
def test_both_packages_write_the_same_slp(tmp_path, embed):
    port_path, jax_path = tmp_path / "port.slp", tmp_path / "jax.slp"
    save_slp(port_path, build_labels(pio, pvideo), embed=embed)
    jax_save_slp(jax_path, build_labels(jio, jvideo), embed=embed)
    got, want = _datasets(port_path), _datasets(jax_path)
    assert set(got) == set(want)
    assert got["metadata"][2]["format_id"] == want["metadata"][2]["format_id"] == 1.2
    originals = _frames()
    n_embedded = 0
    for name, (value, dtype, attrs) in want.items():
        g_value, g_dtype, g_attrs = got[name]
        assert g_dtype == dtype, name
        assert {k: _attr_value(name, k, v) for k, v in g_attrs.items()} == \
            {k: _attr_value(name, k, v) for k, v in attrs.items()}, name
        if value is None:
            continue
        if name.endswith("/video"):
            vi = int(name[len("video"):].split("/")[0])
            numbers = want[name.replace("/video", "/frame_numbers")][0]
            for g_row, w_row, fi in zip(g_value, value, numbers):
                for row in (g_row, w_row):
                    img = cv2.imdecode(np.asarray(row, np.uint8), cv2.IMREAD_UNCHANGED)
                    img = img[..., None] if img.ndim == 2 else img[..., ::-1]
                    np.testing.assert_array_equal(img, originals[vi][fi])
                n_embedded += 1
            continue
        assert _equal_values(np.asarray(g_value), np.asarray(value)), name
    assert n_embedded == (5 if embed else 0)


def _floats(a):
    """A float array as a list, NaN as None (NaN is not equal to itself)."""
    a = np.round(np.asarray(a, np.float64), 12)
    return np.where(np.isnan(a), None, a).tolist()


def summary(labels):
    """Everything a ``.slp`` stores, with objects as indices."""
    vid = {id(v): i for i, v in enumerate(labels.videos)}
    trk = {id(t): i for i, t in enumerate(labels.tracks)}
    insts = [i for lf in labels.labeled_frames for i in lf.instances]
    iid = {id(i): k for k, i in enumerate(insts)}
    frames = []
    for lf in labels.labeled_frames:
        rows = []
        for i in lf.instances:
            pred = type(i).__name__ == "PredictedInstance"
            rows.append((pred, _floats(i.points), i.visible.tolist(),
                         i.complete.tolist() if not pred else None,
                         _floats(i.point_scores) if pred else None,
                         float(np.float32(i.score)) if pred else None,
                         float(np.float32(i.tracking_score)) if pred else None,
                         trk.get(id(i.track)),
                         iid.get(id(i.from_predicted)) if not pred else None))
        frames.append((vid[id(lf.video)], lf.frame_idx, rows,
                       [(r.points.tolist(), r.score, trk.get(id(r.track))) for r in lf.rois],
                       [(type(c).__name__, c.point.tolist(), c.score) for c in lf.centroids]))
    return {
        "frames": frames,
        "tracks": [(t.name, t.spawned_on) for t in labels.tracks],
        "skeletons": [(s.name, s.node_names, s.edge_inds, s.symmetry_inds)
                      for s in labels.skeletons],
        "suggestions": [(vid[id(s.video)], s.frame_idx, s.group) for s in labels.suggestions],
        "provenance": labels.provenance,
        "n_videos": len(labels.videos),
    }


@pytest.mark.parametrize("embed", [False, True])
def test_each_package_reads_the_others_slp(tmp_path, embed):
    port_path, jax_path = tmp_path / "port.slp", tmp_path / "jax.slp"
    port_labels, jax_labels = build_labels(pio, pvideo), build_labels(jio, jvideo)
    save_slp(port_path, port_labels, embed=embed)
    jax_save_slp(jax_path, jax_labels, embed=embed)
    from_jax, from_port = load_slp(jax_path), jax_load_slp(port_path)
    own = load_slp(port_path)
    assert summary(from_jax) == summary(own) == summary(from_port) == summary(jax_load_slp(
        jax_path))
    # What was written comes back (scores through the file's f4 columns).
    assert summary(own)["frames"] == summary(port_labels)["frames"]
    originals = _frames()
    for labels in (from_jax, from_port, own):
        if not embed:
            assert [v.filename for v in labels.videos] == ["gray.mp4", "rgb.mp4"]
            continue
        for lf in labels.labeled_frames:
            vi = labels.videos.index(lf.video)
            np.testing.assert_array_equal(lf.image, originals[vi][lf.frame_idx])
        assert from_jax.videos[1].shape == (2, 20, 16, 3)  # frames 1 and 4 embedded


@pytest.mark.parametrize("embed", [False, True])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_port_reader_reads_both_packages_files_as_h5py_does(tmp_path, embed, writer):
    """The port's HDF5 reader (``io/hdf5.py``) gives every dataset, dtype,
    value and attribute h5py gives, on either package's ``.slp``, with and
    without embedded frames."""
    from sleap_nn_tpu_torch.io import hdf5
    from tests.test_torch_hdf5 import _h5py_tree, _port_tree, assert_trees_equal

    path = tmp_path / f"{writer}.slp"
    if writer == "port":
        save_slp(path, build_labels(pio, pvideo), embed=embed)
    else:
        jax_save_slp(path, build_labels(jio, jvideo), embed=embed)
    assert_trees_equal(_port_tree(path), _h5py_tree(path))
    with hdf5.File(path, "r") as f:
        assert isinstance(f["metadata"].attrs["json"], np.bytes_)
        assert f["metadata"].attrs["format_id"] == 1.2


def _analysis_labels(io, video_mod, tracked):
    labels = build_labels(io, video_mod)
    if not tracked:
        for lf in labels.labeled_frames:
            for inst in lf.instances:
                inst.track = None
    return labels


@pytest.mark.parametrize("tracked", [False, True])
def test_both_packages_write_the_same_analysis_h5(tmp_path, tracked):
    """The analysis HDF5 of the same labels: the same datasets, dtypes,
    values (NaN equal to NaN), chunking and deflate level, by h5py; and the
    port's reader reads the JAX package's file as h5py does."""
    from sleap_nn_tpu.io.analysis import save_analysis_h5 as jax_save_analysis_h5
    from sleap_nn_tpu_torch.io.analysis import save_analysis_h5
    from tests.test_torch_hdf5 import _h5py_tree, _port_tree, assert_trees_equal

    for vi in (0, 1):
        port_path, jax_path = tmp_path / f"port{vi}.h5", tmp_path / f"jax{vi}.h5"
        save_analysis_h5(_analysis_labels(pio, pvideo, tracked), port_path, video=vi,
                         labels_path="l.slp")
        jax_save_analysis_h5(_analysis_labels(jio, jvideo, tracked), jax_path, video=vi,
                             labels_path="l.slp")
        assert_trees_equal(_h5py_tree(port_path), _h5py_tree(jax_path))
        assert_trees_equal(_port_tree(jax_path), _h5py_tree(jax_path))
        with h5py.File(port_path, "r") as f, h5py.File(jax_path, "r") as g:
            for key in ("tracks", "track_occupancy", "point_scores", "instance_scores",
                        "tracking_scores"):
                assert f[key].compression == g[key].compression == "gzip", key
                assert f[key].compression_opts == g[key].compression_opts == 1, key
            assert f["tracks"].shape[-1] == (6 if vi == 0 else 5)


def test_load_slp_refuses_segmentation_masks(tmp_path):
    # Segmentation masks are ported: the port reads the JAX writer's mask
    # rows bit for bit (tests/test_torch_segmentation_io.py holds both
    # directions).
    labels = build_labels(jio, jvideo)
    labels.labeled_frames[0].masks = [jio.SegmentationMask(np.eye(4, dtype=bool), score=0.5)]
    jax_save_slp(tmp_path / "m.slp", labels)
    back = load_slp(tmp_path / "m.slp")
    (m,) = back.labeled_frames[0].masks
    np.testing.assert_array_equal(m.mask, np.eye(4, dtype=bool))
    assert (m.score, m.scale, m.track) == (0.5, 1.0, None)


def test_labels_save_and_the_incremental_writer(tmp_path):
    labels = build_labels(pio, pvideo)
    labels.save(tmp_path / "a.slp", embed=True)
    assert summary(load_slp(tmp_path / "a.slp"))["frames"] == summary(labels)["frames"]
    out = tmp_path / "w.slp"
    writer = IncrementalLabelsWriter(out, flush_every=2, provenance={"run": 1})
    writer.add_frames(labels.labeled_frames[:1])
    assert not writer.tmp_path.exists()
    writer.add_frames(labels.labeled_frames[1:3])
    assert writer.tmp_path.exists() and len(load_slp(writer.tmp_path)) == 3
    writer.add_frames(labels.labeled_frames[3:])
    with writer:
        pass
    assert out.exists() and not writer.tmp_path.exists()
    back = jax_load_slp(out)
    assert len(back) == 5 and back.provenance == {"run": 1}


# -- PNG ------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (7, 13, 1), (9, 5, 3), (64, 48, 3)])
def test_png_encoder_round_trips_through_cv2(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    data = encode_png(img)
    back = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3 and img.shape[-1] == 3:
        back = back[..., ::-1]  # cv2 hands RGB pixels back as BGR
    np.testing.assert_array_equal(back.reshape(img.shape), img)
    np.testing.assert_array_equal(decode_png(data).reshape(img.shape), img)


def _row_filters(data):
    """The filter type of every row of a PNG stream."""
    import struct
    import zlib

    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    w, h, _, color = header[:4]
    stride = 1 + w * (3 if color == 2 else 1)
    return set(np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)[::stride][:h].tolist())


FILTERS = {"none": (cv2.IMWRITE_PNG_FILTER_NONE, 0), "sub": (cv2.IMWRITE_PNG_FILTER_SUB, 1),
           "up": (cv2.IMWRITE_PNG_FILTER_UP, 2), "avg": (cv2.IMWRITE_PNG_FILTER_AVG, 3),
           "paeth": (cv2.IMWRITE_PNG_FILTER_PAETH, 4)}


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("name", FILTERS)
def test_png_decoder_reads_cv2_pngs_of_every_filter(name, channels):
    rng = np.random.default_rng(channels)
    noise = rng.integers(0, 256, (33, 47, channels), dtype=np.uint8)
    smooth = (np.cumsum(np.cumsum(noise.astype(int), 0), 1) // 97 % 256).astype(np.uint8)
    flag, kind = FILTERS[name]
    for img in (noise, smooth):
        src = img[..., 0] if channels == 1 else img[..., ::-1]  # cv2 encodes BGR
        ok, buf = cv2.imencode(".png", src, [cv2.IMWRITE_PNG_FILTER, flag])
        assert ok and _row_filters(buf.tobytes()) <= {0, kind}
        np.testing.assert_array_equal(decode_png(buf.tobytes()), img)
    # cv2's own choice of filters, row by row.
    ok, buf = cv2.imencode(".png", smooth[..., 0] if channels == 1 else smooth[..., ::-1])
    np.testing.assert_array_equal(decode_png(buf.tobytes()), smooth)


def test_png_codec_refuses_what_it_does_not_cover():
    for img in (np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4), np.uint16)):
        ok, buf = cv2.imencode(".png", img)
        with pytest.raises(ValueError, match="8-bit gray or RGB"):
            decode_png(buf.tobytes())
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")
    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match="1 or 3 channels"):
        encode_png(np.zeros((2, 2, 2), np.uint8))


# -- videos ---------------------------------------------------------------------


@pytest.mark.parametrize("input_format", ["channels_last", "channels_first"])
def test_hdf5_video_of_raw_frames_matches_jax(tmp_path, input_format):
    frames = np.random.default_rng(3).integers(0, 256, (4, 6, 5, 3), dtype=np.uint8)
    stored = frames if input_format == "channels_last" else frames.transpose(0, 3, 1, 2)
    with h5py.File(tmp_path / "v.h5", "w") as f:
        f.create_dataset("box", data=stored)
    md = {"dataset": "box", "input_format": input_format}
    got = pvideo.Video(str(tmp_path / "v.h5"), backend_metadata=md)
    want = jvideo.Video(str(tmp_path / "v.h5"), backend_metadata=md)
    assert len(got) == len(want) == 4 and got.shape == want.shape
    np.testing.assert_array_equal(got[[0, 2]], want[[0, 2]])
    np.testing.assert_array_equal(got[1], frames[1])
    np.testing.assert_array_equal(got.get_frame(3, fmt="gray"), want.get_frame(3, fmt="gray"))
    assert got.to_backend_json() == want.to_backend_json()


def test_media_videos_are_not_ported():
    """Media videos were refused here before the cv2 backends were ported.
    Now a media file that is not there reads as the JAX package's does: no
    shape, ``FileNotFoundError`` on a read, and a ``videos_json`` row that
    round-trips alike."""
    video, want = pvideo.Video("clip.mp4"), jvideo.Video("clip.mp4")
    assert video.shape is None and want.shape is None
    assert type(video.backend).__name__ == type(want.backend).__name__ == "MediaVideoBackend"
    for call in (lambda v: v[0], len):
        for v in (video, want):
            with pytest.raises(FileNotFoundError, match="clip.mp4"):
                call(v)
    row = {"backend": {"filename": "clip.mp4", "grayscale": True, "bgr": True, "dataset": "",
                       "input_format": ""}}
    assert pvideo.Video.from_backend_json(row).to_backend_json() == \
        jvideo.Video.from_backend_json(row).to_backend_json()