"""Port parity: video files (``io/video.py``), ``VideoProvider`` by filename
and the analysis HDF5 export (``io/analysis.py``), against the JAX package.

The media are written here with cv2, small: an MJPG ``.avi`` and an
``mp4v`` ``.mp4`` of 9 frames of 48x64 (moving RGB gradients over noise,
and grayscale content stored as RGB), a PNG image sequence, a single
image, and a ``.pkg.slp`` whose embedded frames are JPEG bytes. Both
packages decode the same file with the same cv2, so frames must be equal
bit for bit: sequential reads, out-of-order and repeated indices (which
seek at the same points in both), ``fmt="gray"``, the grayscale probe of
the first frame, ``shape`` and ``len``, and the errors of a missing file
or a frame past the end. ``.slp`` files that reference a media video are
read by the other package to the same frames, also after the files moved
together (the stale-path rule). The analysis HDF5 files of the two
packages hold the same datasets, dtypes and values, NaN placed alike.
Embedded PNG frames of either package's ``.pkg.slp`` read through the
port's own HDF5 reader, one handle a thread, equal to the JAX package's.
"""

import json
import shutil

import cv2
import h5py
import numpy as np
import pytest

from sleap_nn_tpu.inference.providers import VideoProvider as JaxVideoProvider
from sleap_nn_tpu.io import analysis as janalysis
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.io import video as jvideo
from sleap_nn_tpu.io.slp import load_slp as jax_load_slp
from sleap_nn_tpu_torch.inference.providers import VideoProvider
from sleap_nn_tpu_torch.io import analysis as panalysis
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.io import video as pvideo
from sleap_nn_tpu_torch.io.slp import load_slp
from tests.test_torch_slp import build_labels
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

N, H, W = 9, 48, 64


def clip_frames(gray=False, seed=0):
    """``(N, H, W, 3)`` uint8: gradients that move a pixel a frame over
    noise; with ``gray``, one channel repeated three times."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    out = np.empty((N, H, W, 3), np.uint8)
    for t in range(N):
        base = np.stack([(xx + 3 * t) * 4, (yy + 2 * t) * 5, (xx + yy + t) * 2], -1)
        out[t] = np.clip(base % 256 + rng.integers(-20, 20, (H, W, 3)), 0, 255)
    if gray:
        out[:] = out[..., :1]
    return out


def write_media(path, frames, fourcc, is_color=True):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 10.0, (W, H),
                             isColor=is_color)
    assert writer.isOpened(), path
    for f in frames:
        writer.write(np.ascontiguousarray(f[..., ::-1] if is_color else f[..., 0]))
    writer.release()
    return str(path)


def write_jpeg_pkg(path, frames):
    """A ``.pkg.slp`` of one instance on every other frame, whose embedded
    frames are JPEG bytes, as sleap-io writes them (``format`` = ``jpg``)."""
    video = pvideo.Video("src.mp4", backend=_Frames(frames))
    skel = pio.Skeleton(["a", "b"])
    lfs = [pio.LabeledFrame(video, i, [pio.Instance(np.full((2, 2), 8.0 + i), skel)])
           for i in range(0, len(frames), 2)]
    pio.Labels(lfs).save(str(path), embed=True)
    with h5py.File(path, "r+") as f:
        ds = f["video0/video"]
        for row, i in enumerate(f["video0/frame_numbers"][:]):
            ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(frames[i][..., ::-1]))
            assert ok
            ds[row] = buf.ravel()
        ds.attrs["format"] = "jpg"
    return str(path)


class _Frames:
    """Frames in memory as a ``Video`` backend of either package."""

    def __init__(self, frames):
        self.frames, self.num_frames, self.shape = frames, len(frames), frames.shape

    def get_frame(self, idx, fmt=None):
        return self.frames[idx]


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    root = tmp_path_factory.mktemp("media")
    color, gray = clip_frames(), clip_frames(gray=True, seed=1)
    images = []
    for i, f in enumerate(color[:5]):
        images.append(str(root / f"img_{i}.png"))
        cv2.imwrite(images[-1], np.ascontiguousarray(f[..., ::-1]))
    return {
        "avi": write_media(root / "color.avi", color, "MJPG"),
        "gray_avi": write_media(root / "gray.avi", gray, "MJPG", is_color=False),
        "mp4": write_media(root / "color.mp4", color, "mp4v"),
        "images": images,
        "image": images[2],
        "pkg": write_jpeg_pkg(root / "jpeg.pkg.slp", color),
        "color": color,
    }


SOURCES = ("avi", "gray_avi", "mp4", "images", "image")
ORDERS = {"sequential": list(range(N)), "out_of_order": [5, 1, 7, 2, 2, 8, 0, 3],
          "repeated": [4, 4, 4, 5, 5, 3, 3]}


def _pair(media, source, **md):
    fn = media[source]
    return pvideo.Video.from_filename(fn, **md), jvideo.Video.from_filename(fn, **md)


@pytest.mark.parametrize("source", SOURCES)
def test_video_shape_probe_and_backend_match_jax(media, source):
    got, want = _pair(media, source)
    assert type(got.backend).__name__ == type(want.backend).__name__
    assert got.shape == want.shape and len(got) == len(want)
    assert got.backend.grayscale == want.backend.grayscale
    if source == "gray_avi":  # the probe finds grayscale content stored as RGB
        assert got.backend.grayscale is True and got.shape[-1] == 1
    if source == "avi":
        assert got.backend.grayscale is False and got.shape == (N, H, W, 3)
    assert got.to_backend_json() == want.to_backend_json()
    assert got.exists() and got.is_open


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("source", ("avi", "gray_avi", "mp4"))
@pytest.mark.parametrize("fmt", (None, "gray"))
def test_media_frames_match_jax_bit_for_bit(media, source, order, fmt):
    got, want = _pair(media, source)
    for i in ORDERS[order]:
        g, w = got.get_frame(i, fmt=fmt), want.get_frame(i, fmt=fmt)
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[[3, 1]], want[[3, 1]])


@pytest.mark.parametrize("fmt", (None, "gray"))
def test_image_sequences_match_jax_bit_for_bit(media, fmt):
    for source in ("images", "image"):
        got, want = _pair(media, source)
        for i in (0, len(want) - 1, 0):
            np.testing.assert_array_equal(got.get_frame(i, fmt=fmt), want.get_frame(i, fmt=fmt))
    got, _ = _pair(media, "images")
    np.testing.assert_array_equal(got[1], media["color"][1])  # PNG is lossless


def test_mjpg_frames_stay_close_to_what_was_written(media):
    got = pvideo.Video.from_filename(media["avi"])
    err = np.abs(got[list(range(N))].astype(int) - media["color"].astype(int))
    assert err.mean() < 12, err.mean()  # lossy, but these frames


def test_video_errors_match_jax(media, tmp_path):
    for mod in (pvideo, jvideo):
        with pytest.raises(FileNotFoundError, match="missing.avi"):
            mod.Video.from_filename(str(tmp_path / "missing.avi"))[0]
        video = mod.Video.from_filename(media["avi"])
        with pytest.raises(IndexError, match="Failed to read frame"):
            video.get_frame(N + 3)
        with pytest.raises(FileNotFoundError):
            mod.Video.from_filename([str(tmp_path / "none.png")])[0]
        assert mod.Video.from_filename(str(tmp_path / "missing.avi")).shape is None


def test_each_thread_keeps_its_own_capture(media):
    """The probe decodes frame 0 on the thread that asks for ``shape``; a
    second thread reading on keeps its own position."""
    import threading

    got = pvideo.Video.from_filename(media["avi"])
    want = jvideo.Video.from_filename(media["avi"])
    assert got.shape == want.shape
    out = {}

    def read():
        out["frames"] = [got.get_frame(i) for i in (0, 1, 2, 6)]

    thread = threading.Thread(target=read)
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive()
    for i, frame in zip((0, 1, 2, 6), out["frames"]):
        np.testing.assert_array_equal(frame, want.get_frame(i))
    np.testing.assert_array_equal(got.get_frame(3), want.get_frame(3))


@pytest.mark.parametrize("fmt", (None, "gray"))
def test_jpeg_embedded_frames_match_jax(media, fmt):
    got, want = load_slp(media["pkg"]), jax_load_slp(media["pkg"])
    assert [lf.frame_idx for lf in got] == [lf.frame_idx for lf in want] == [0, 2, 4, 6, 8]
    gv, wv = got.videos[0], want.videos[0]
    assert gv.shape == wv.shape
    for lf in got:
        np.testing.assert_array_equal(gv.get_frame(lf.frame_idx, fmt=fmt),
                                      wv.get_frame(lf.frame_idx, fmt=fmt))
        np.testing.assert_array_equal(lf.image, wv[lf.frame_idx])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_embedded_png_frames_read_through_the_port_reader_in_threads(tmp_path, writer):
    """A ``.pkg.slp`` of PNG frames, written by either package, read by
    the embedded-frame backend over the port's HDF5 reader: each of four
    threads opens its own handle, and every frame equals the JAX
    package's read."""
    import threading

    from sleap_nn_tpu.io.slp import save_slp as jax_save_slp
    from sleap_nn_tpu_torch.io.slp import save_slp

    path = tmp_path / "emb.pkg.slp"
    if writer == "port":
        save_slp(path, build_labels(pio, pvideo), embed=True)
    else:
        jax_save_slp(path, build_labels(jio, jvideo), embed=True)
    got, want = load_slp(path), jax_load_slp(path)
    pairs = [(gv, wv, fi) for gv, wv in zip(got.videos, want.videos)
             for fi in gv.backend.frame_numbers]
    assert len(pairs) == 5
    out, handles = {}, []

    def read(k):
        for j, (gv, _, fi) in enumerate(pairs):
            out[k, j] = gv.get_frame(fi)
        handles.append(got.videos[0].backend._file())  # kept alive: ids stay distinct

    threads = [threading.Thread(target=read, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len({id(h) for h in handles}) == 4  # one open handle a thread
    for (k, j), frame in out.items():
        gv, wv, fi = pairs[j]
        np.testing.assert_array_equal(frame, wv.get_frame(fi))
        assert gv.shape == wv.shape


@pytest.mark.parametrize("batch_size,frames", [(4, None), (4, [7, 2, 5, 5, 0]), (3, [1, 2, 3])])
@pytest.mark.parametrize("out_format", (None, "gray"))
def test_video_provider_by_filename_matches_jax(media, batch_size, frames, out_format):
    kw = dict(batch_size=batch_size, frames=frames, out_format=out_format)
    got = list(VideoProvider(media["avi"], prefetch=3, **kw))
    want = list(JaxVideoProvider(media["avi"], prefetch=3, **kw))
    assert len(got) == len(want) == -(-len(frames or range(N)) // batch_size)
    for g, w in zip(got, want):
        for key in ("frames", "frame_inds", "video_inds", "valid"):
            np.testing.assert_array_equal(getattr(g, key), getattr(w, key), err_msg=key)
    assert not got[-1].valid.all() or len(frames or range(N)) % batch_size == 0


def test_video_provider_host_step_runs_on_its_thread(media):
    import threading

    threads = set()

    def step(batch):
        threads.add(threading.current_thread())
        return batch.frames.shape

    provider = VideoProvider(media["avi"], batch_size=4)
    assert list(provider.batches(step)) == [(4, H, W, 3)] * 3
    assert threading.current_thread() not in threads and len(threads) == 1


# -- .slp files that reference media videos ---------------------------------------


def _media_labels(io, video_mod, path):
    video = video_mod.Video.from_filename(path)
    skel = io.Skeleton(["a", "b"], edges=[(0, 1)])
    lfs = [io.LabeledFrame(video, i, [io.Instance(np.array([[3.0, 4.0], [5.0 + i, 6.0]]), skel)])
           for i in (1, 4, 7)]
    return io.Labels(lfs)


@pytest.mark.parametrize("writer", ("port", "jax"))
def test_slp_referencing_a_media_video_reads_alike(media, tmp_path, writer):
    src = tmp_path / "data" / "clip.avi"
    src.parent.mkdir()
    shutil.copy(media["avi"], src)
    if writer == "port":
        _media_labels(pio, pvideo, str(src)).save(str(tmp_path / "data" / "l.slp"))
    else:
        _media_labels(jio, jvideo, str(src)).save(str(tmp_path / "data" / "l.slp"))
    # Move the labels and the video together: the stored path goes stale.
    moved = tmp_path / "moved"
    shutil.move(str(src.parent), str(moved))
    for reader in (load_slp, jax_load_slp):
        back = reader(str(moved / "l.slp"))
        video = back.videos[0]
        assert video.filename == str(moved / "clip.avi")
        assert video.shape == (N, H, W, 3)
        for lf in back:
            np.testing.assert_array_equal(
                lf.image, jvideo.Video.from_filename(str(moved / "clip.avi"))[lf.frame_idx])
    got, want = load_slp(str(moved / "l.slp")), jax_load_slp(str(moved / "l.slp"))
    assert got.videos[0].to_backend_json() == want.videos[0].to_backend_json()
    with h5py.File(moved / "l.slp") as f:
        row = json.loads(f["videos_json"][0])
    assert row["backend"]["filename"] == str(src)


# -- the analysis HDF5 export -------------------------------------------------------


def _h5_datasets(path):
    with h5py.File(path, "r") as f:
        return {k: (f[k].dtype, f[k][()]) for k in f}


def _assert_same_h5(got, want):
    g, w = _h5_datasets(got), _h5_datasets(want)
    assert sorted(g) == sorted(w)
    for key in w:
        (gd, gv), (wd, wv) = g[key], w[key]
        assert gd == wd, key
        if key == "provenance":
            assert json.loads(gv) == json.loads(wv)
        elif wd.kind == "f":
            np.testing.assert_array_equal(gv, wv, err_msg=key)  # NaN equal to NaN
        else:
            assert np.array_equal(gv, wv), key


def _predicted_labels(io, video_mod, tracked, seed=4):
    rng = np.random.default_rng(seed)
    video = video_mod.Video("clip.mp4", backend=_Frames(np.zeros((12, 8, 8, 1), np.uint8)))
    skel = io.Skeleton(["a", "b", "c"], edges=[(0, 1), (1, 2)])
    tracks = [io.Track("t0"), io.Track("t1")] if tracked else []
    lfs = []
    for f in (0, 3, 4, 9):
        insts = []
        for k in range(1 + f % 2):
            pts = rng.normal(4, 2, (3, 2))
            pts[rng.random(3) < 0.3] = np.nan
            insts.append(io.PredictedInstance(pts, skel, point_scores=rng.random(3),
                                              score=float(rng.random()),
                                              track=tracks[k] if tracked else None,
                                              tracking_score=0.5 if tracked else 0.0))
        if f == 3:
            insts.append(io.Instance(rng.normal(4, 2, (3, 2)), skel))  # user: not exported
        lfs.append(io.LabeledFrame(video, f, insts))
    return io.Labels(lfs, tracks=tracks, provenance={"model_type": "topdown"})


@pytest.mark.parametrize("tracked", (False, True))
def test_analysis_h5_matches_jax_dataset_by_dataset(tmp_path, tracked):
    got = panalysis.save_analysis_h5(_predicted_labels(pio, pvideo, tracked),
                                     tmp_path / "p.h5", labels_path="x.slp")
    want = janalysis.save_analysis_h5(_predicted_labels(jio, jvideo, tracked),
                                      tmp_path / "j.h5", labels_path="x.slp")
    _assert_same_h5(got, want)
    tracks = _h5_datasets(got)["tracks"][1]
    assert tracks.shape == (2, 3, 2, 12) and np.isnan(tracks).any()


def test_analysis_h5_files_match_jax_per_video(tmp_path):
    labels = {}
    for name, io, mod in (("p", pio, pvideo), ("j", jio, jvideo)):
        lab = build_labels(io, mod)
        for lf in lab.labeled_frames:
            lf.instances = [io.PredictedInstance(np.asarray(i.numpy()), i.skeleton,
                                                 point_scores=np.ones(len(i.numpy())),
                                                 score=0.5) for i in lf.instances]
        labels[name] = lab
    # Both write the same paths (labels_path is stored), one after the other.
    got = panalysis.save_analysis_h5_files(labels["p"], tmp_path / "out.predictions.slp")
    for path in got:
        shutil.move(path, tmp_path / f"port.{path.name}")
    want = janalysis.save_analysis_h5_files(labels["j"], tmp_path / "out.predictions.slp")
    assert got == want and len(got) == 2
    for w in want:
        _assert_same_h5(tmp_path / f"port.{w.name}", w)
    for mod in (panalysis, janalysis):
        with pytest.raises(ValueError, match="video_index 5 out of range"):
            mod.save_analysis_h5_files(labels["p" if mod is panalysis else "j"],
                                       tmp_path / "x.slp", video_index=5)
