"""Port parity: remote inputs, the top-level API, ``PAFScorer.from_config``
/ ``.predict``, ``make_confmaps`` and the heads' ``loss_function``,
against the JAX package on the CPU.

Remote inputs: ``fetch_remote_data`` of both packages through the same
patched ``urllib.request.urlopen`` (the temp file's suffix and bytes, the
request's URL and headers; a failed request leaves no file), ``file://``
in place, the cloud schemes' ``ValueError``. Then ``run.predict`` and the
command line's ``predict`` from URLs of a loopback ``http.server`` on
``127.0.0.1`` (nothing leaves the machine; proxies are bypassed) serving an
MJPG clip and a ``.slp``, and from ``file://``: the port's ``Labels`` equal
the local path's exactly, and the JAX package's from the same URL to
``tests/test_torch_run_video.py``'s tolerances. A subprocess shows that a
download is removed when the interpreter exits.

``PAFScorer.predict`` is held against the JAX scorer's with its device half
jitted, the production form (``tests/test_torch_paf.py`` says why):
instance counts exact, floats to 1e-5. ``make_confmaps`` to 1e-6 with
missing (NaN) points.
"""

import http.server
import inspect
import json
import os
import subprocess
import sys
import tempfile
import threading
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace as ns
from unittest.mock import patch
from urllib.parse import quote

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleap_nn_tpu
import sleap_nn_tpu_torch
from sleap_nn_tpu import inference as jinference
from sleap_nn_tpu.inference import paf_grouping as jpg
from sleap_nn_tpu.inference import run as jrun
from sleap_nn_tpu.models import heads as jheads
from sleap_nn_tpu.ops import confmaps as jcm
from sleap_nn_tpu_torch import cli as pcli
from sleap_nn_tpu_torch import inference as pinference
from sleap_nn_tpu_torch.inference import paf_grouping as tpg
from sleap_nn_tpu_torch.inference import run as prun
from sleap_nn_tpu_torch.inference.predictor import Predictor
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.io import video as pvideo
from sleap_nn_tpu_torch.models import heads as pheads
from sleap_nn_tpu_torch.ops import confmaps as pcm
from tests.test_torch_model_dir import (  # noqa: F401  (dirs: a fixture)
    KW,
    FrameVideo,
    _assert_same,
    _assert_same_labels,
    _paths,
    dirs,
)
from tests.test_torch_run_video import assert_same_labels, write_clip
from tests.test_torch_topdown import blob_frames
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
N_FRAMES = 6
PROXY_VARS = ("http_proxy", "https_proxy", "all_proxy", "HTTP_PROXY", "HTTPS_PROXY",
              "ALL_PROXY")


@pytest.fixture
def no_proxy(monkeypatch):
    """A loopback request goes straight to the loopback server."""
    for var in PROXY_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("no_proxy", "*")
    monkeypatch.setenv("NO_PROXY", "*")


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """A ``ThreadingHTTPServer`` on ``127.0.0.1`` serving a clip of blob
    frames and a ``.slp`` of some of them; each request's headers are kept."""
    root = tmp_path_factory.mktemp("served")
    frames = blob_frames(N_FRAMES, seed=9)
    clip = write_clip(root / "clip.avi", frames)
    video = pvideo.Video.from_filename(clip)
    skel = pio.Skeleton(["n0", "n1", "n2"])
    pts = np.array([[20.0, 20.0], [24.0, 24.0], [28.0, 28.0]])
    pio.Labels([pio.LabeledFrame(video, i, [pio.Instance(pts, skel)]) for i in (0, 2, 3, 5)],
               videos=[video]).save(str(root / "source.slp"))
    seen = []

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, directory=str(root), **kwargs)

        def do_GET(self):
            seen.append((self.path, {k.lower(): v for k, v in self.headers.items()}))
            super().do_GET()

        def log_message(self, *args):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield ns(root=root, clip=clip, slp=str(root / "source.slp"), seen=seen,
                 url=f"http://127.0.0.1:{httpd.server_port}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()


def _downloads(tmp):
    return sorted(p.name for p in Path(tmp).iterdir())


# -- fetch_remote_data ------------------------------------------------------------


@pytest.mark.parametrize("name", ["a.slp", "with space.pkg.slp"])
def test_fetch_file_url_resolves_in_place(tmp_path, name):
    path = tmp_path / name
    path.write_bytes(b"x")
    url = "file://" + quote(str(path))
    assert prun.fetch_remote_data(url) == jrun.fetch_remote_data(url) == str(path)


@pytest.mark.parametrize("url", ["s3://bucket/key.slp", "gs://bucket/a.mp4",
                                 "ftp://host/a.slp"])
def test_fetch_cloud_scheme_raises_like_jax(url):
    with pytest.raises(ValueError) as want:
        jrun.fetch_remote_data(url)
    with pytest.raises(ValueError, match=repr(url.split(":")[0])) as got:
        prun.fetch_remote_data(url)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("url,suffix", [
    ("https://example.test/videos/clip%201.pkg.slp?sig=abc", ".pkg.slp"),
    ("http://example.test/a/b.mp4", ".mp4"),
    ("https://example.test/noext", ""),
    ("https://example.test/", ""),
])
def test_fetch_http_downloads_like_jax(monkeypatch, tmp_path, url, suffix):
    """Both packages through the same patched ``urlopen``: the same URL,
    headers and timeout on the request, the same suffix and bytes."""
    import io

    seen = []

    def urlopen(req, timeout=None):
        seen.append((req.full_url, sorted(req.header_items()), timeout))
        return io.BytesIO(b"payload-bytes" * 1000)

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    headers = {"Authorization": "Bearer tok", "X-Other": "1"}
    got = prun.fetch_remote_data(url, headers=headers, timeout=5.0)
    want = jrun.fetch_remote_data(url, headers=headers, timeout=5.0)
    assert seen[0] == seen[1] and seen[0][0] == url and seen[0][2] == 5.0
    assert ("Authorization", "Bearer tok") in seen[0][1]
    assert Path(got).name.startswith("sleap_nn_tpu_torch_remote_")
    assert Path(got).parent == Path(want).parent == tmp_path
    assert "".join(Path(got).suffixes) == "".join(Path(want).suffixes) == suffix
    assert Path(got).read_bytes() == Path(want).read_bytes() == b"payload-bytes" * 1000
    # stream_mode "stream" downloads first too.
    again = prun.fetch_remote_data(url, stream_mode="stream")
    assert Path(again).read_bytes() == Path(got).read_bytes() and again != got


class _Breaks:
    """A response whose second read fails, as a dropped connection's does."""

    def __init__(self):
        self.reads = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def read(self, n=-1):
        self.reads += 1
        if self.reads > 1:
            raise ConnectionResetError("connection dropped")
        return b"partial"


@pytest.mark.parametrize("failure", ["404", "timeout", "mid_copy"])
def test_failed_request_leaves_no_file(monkeypatch, tmp_path, failure):
    def urlopen(req, timeout=None):
        if failure == "404":
            raise urllib.error.HTTPError(req.full_url, 404, "Not Found", {}, None)
        if failure == "timeout":
            raise urllib.error.URLError(TimeoutError("timed out"))
        return _Breaks()

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    error = ConnectionResetError if failure == "mid_copy" else urllib.error.URLError
    for fetch in (prun.fetch_remote_data, jrun.fetch_remote_data):
        with pytest.raises(error):
            fetch("http://example.test/clip.avi", headers={"A": "b"})
    assert _downloads(tmp_path) == []


def test_download_is_removed_at_exit(server, no_proxy, tmp_path):
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    code = ("import sys; from pathlib import Path; "
            "from sleap_nn_tpu_torch.inference.run import fetch_remote_data; "
            "p = fetch_remote_data(sys.argv[1], headers={'X-Exit': '1'}); "
            "print(p, Path(p).stat().st_size)")
    env = {**os.environ, "TMPDIR": str(tmp), "PYTHONPATH": str(ROOT), "no_proxy": "*"}
    out = subprocess.run([sys.executable, "-c", code, f"{server.url}/clip.avi"], env=env,
                         capture_output=True, text=True, timeout=300, check=True).stdout.split()
    assert Path(out[0]).parent == tmp and out[0].endswith(".avi")
    assert int(out[1]) == Path(server.clip).stat().st_size
    assert ("/clip.avi", "1") in [(p, h.get("x-exit")) for p, h in server.seen]
    assert _downloads(tmp) == []


# -- run.predict and the command line from URLs -------------------------------------


@pytest.mark.parametrize("source", ["http_clip", "http_slp", "file_clip", "file_slp"])
def test_predict_from_a_url_matches_local_and_jax(dirs, server, no_proxy, source):  # noqa: F811
    scheme, kind = source.split("_")
    local = server.clip if kind == "clip" else server.slp
    url = (f"{server.url}/{Path(local).name}" if scheme == "http"
           else "file://" + quote(local))
    paths = _paths(dirs, "topdown")
    kw = dict(batch_size=4, headers={"X-Test": source}, **KW["topdown"])
    n_seen = len(server.seen)
    got = prun.predict(url, paths, device="cpu", **kw)
    if scheme == "http":
        assert [(p, h.get("x-test")) for p, h in server.seen[n_seen:]] == \
            [(f"/{Path(local).name}", source)]
    else:
        assert len(server.seen) == n_seen
    local_labels = prun.predict(local, paths, device="cpu", **kw)
    _assert_same_labels(got, local_labels, atol=0)
    assert [lf.frame_idx for lf in got] == ([0, 2, 3, 5] if kind == "slp"
                                            else list(range(N_FRAMES)))
    assert sum(len(lf) for lf in got) >= N_FRAMES // 2
    want = jinference.predict(url, paths, **kw)
    assert_same_labels(got, want)
    # The run's source is the downloaded (or resolved) file, as in JAX; only
    # the temp file's random name differs.
    src_got, src_want = Path(got.provenance["source_file"]), Path(want.provenance["source_file"])
    if scheme == "file":
        assert src_got == src_want == Path(local)
    else:
        assert src_got.parent == src_want.parent == Path(tempfile.gettempdir())
        assert src_got.suffixes == src_want.suffixes == [Path(local).suffix]
        assert src_got.name.startswith("sleap_nn_tpu_torch_remote_")
    assert [Path(v.filename).suffix for v in got.videos] == \
        [Path(v.filename).suffix for v in want.videos]
    if kind == "slp":  # the .slp's video is the clip it names
        assert [v.filename for v in got.videos] == [v.filename for v in want.videos] == \
            [server.clip]
    assert got.provenance["frame_selection"] == want.provenance["frame_selection"]
    assert got.provenance["model_type"] == want.provenance["model_type"]


def test_cli_predicts_from_a_url(dirs, server, no_proxy, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.chdir(tmp_path)
    argv = ["predict", "-i", f"{server.url}/clip.avi", "-m", str(dirs["single_instance"].cond),
            "--headers", '{"A": "b"}', "--device", "cpu", "--batch-size", "4"]
    n_seen = len(server.seen)
    assert pcli.main(argv) == 0
    assert server.seen[n_seen][1].get("a") == "b"
    from sleap_nn_tpu_torch.io.slp import load_slp

    got = load_slp(tmp_path / "clip.predictions.slp")
    argv_local = argv[:2] + [server.clip] + argv[3:]
    assert pcli.main(argv_local + ["-o", "local.slp"]) == 0
    want = load_slp(tmp_path / "local.slp")
    _assert_same_labels(got, want, atol=0)
    assert sum(len(lf) for lf in got) >= N_FRAMES // 2
    # --stream-mode stream downloads first too.
    assert pcli.main(argv + ["--stream-mode", "stream", "-o", "s.slp"]) == 0
    _assert_same_labels(load_slp(tmp_path / "s.slp"), want, atol=0)


# -- the top-level API --------------------------------------------------------------


def test_top_level_names_are_jax_names():
    assert sleap_nn_tpu_torch.__all__ == sleap_nn_tpu.__all__
    for name in sleap_nn_tpu_torch.__all__:
        assert hasattr(sleap_nn_tpu_torch, name), name
    assert pinference.__all__ == jinference.__all__


def test_predict_and_predictor_resolve_to_inference():
    assert sleap_nn_tpu_torch.predict is pinference.predict is prun.predict
    assert sleap_nn_tpu_torch.Predictor is pinference.Predictor is Predictor
    assert inspect.signature(sleap_nn_tpu_torch.load_models).parameters.keys() == \
        inspect.signature(sleap_nn_tpu.load_models).parameters.keys()


def test_load_models_wraps_from_model_paths():
    sentinel = object()
    with patch("sleap_nn_tpu_torch.inference.Predictor.from_model_paths",
               return_value=sentinel) as fmp:
        result = sleap_nn_tpu_torch.load_models(["/m1", "/m2"], batch_size=8)
    assert result is sentinel
    fmp.assert_called_once_with(["/m1", "/m2"], batch_size=8)


def test_load_models_builds_the_predictor_of_from_model_paths(dirs):  # noqa: F811
    paths = _paths(dirs, "bottomup")
    frames = FrameVideo(blob_frames(N_FRAMES, seed=9))
    got = sleap_nn_tpu_torch.load_models(paths, batch_size=4, device="cpu", **KW["bottomup"])
    want = Predictor.from_model_paths(paths, batch_size=4, device="cpu", **KW["bottomup"])
    assert type(got.layer) is type(want.layer) and got.model_type == want.model_type
    _assert_same(got.predict(frames, make_labels=False), want.predict(frames, make_labels=False))
    with patch.object(torch.cuda, "is_available", lambda: False), \
            pytest.raises(RuntimeError, match="CUDA"):
        sleap_nn_tpu_torch.load_models(paths)  # the card unless asked


def test_unknown_attribute_raises():
    with pytest.raises(AttributeError, match="sleap_nn_tpu_torch"):
        sleap_nn_tpu_torch.totally_made_up_name  # noqa: B018


def test_version_is_a_string():
    assert isinstance(sleap_nn_tpu_torch.__version__, str)
    assert sleap_nn_tpu_torch.__version__ == sleap_nn_tpu.__version__


def test_import_is_cheap_and_rank_reads_local_rank():
    """``import sleap_nn_tpu_torch`` imports neither torch nor jax; ``RANK``
    is ``LOCAL_RANK``, and ``process_rank()`` without a process group."""
    code = ("import sys, json, sleap_nn_tpu_torch as m; "
            "print(json.dumps([m.RANK, m.process_rank(), "
            "sorted({'torch', 'jax', 'numpy', 'sleap_nn_tpu'} & set(sys.modules))]))")
    for env_rank, want in ((None, 0), ("3", 3)):
        env = {k: v for k, v in os.environ.items() if k != "LOCAL_RANK"}
        env["PYTHONPATH"] = str(ROOT)
        if env_rank is not None:
            env["LOCAL_RANK"] = env_rank
        out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=120, check=True)
        assert json.loads(out.stdout) == [want, want, []]


def test_process_rank_is_the_group_rank(monkeypatch):
    assert sleap_nn_tpu_torch.process_rank() == sleap_nn_tpu_torch.RANK
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 5)
    assert sleap_nn_tpu_torch.process_rank() == 5


# -- PAFScorer.from_config and .predict ----------------------------------------------


def _leaf(edges=(("n0", "n1"), ("n1", "n2"), ("n0", "n3"), ("n3", "n4")), stride=4):
    return {"part_names": ["n0", "n1", "n2", "n3", "n4"], "edges": [list(e) for e in edges],
            "output_stride": stride, "sigma": 15.0}


@pytest.mark.parametrize("knobs", [{}, {"max_edge_length_ratio": 0.5, "dist_penalty_weight": 2.0,
                                        "n_points": 5, "min_instance_peaks": 0.5,
                                        "min_line_scores": -0.5, "k_per_node": 4}])
@pytest.mark.parametrize("stride", [2, 4])
def test_paf_scorer_from_config_matches_jax(knobs, stride):
    got = tpg.PAFScorer.from_config(_leaf(stride=stride), **knobs)
    want = jpg.PAFScorer.from_config(_leaf(stride=stride), **knobs)
    for field in ("part_names", "edges", "pafs_stride", "max_edge_length_ratio",
                  "dist_penalty_weight", "n_points", "min_instance_peaks", "min_line_scores",
                  "k_per_node", "edge_inds", "n_nodes", "n_edges", "sorted_edge_inds"):
        assert getattr(got, field) == getattr(want, field), field
    assert inspect.signature(tpg.PAFScorer.from_config).parameters.keys() == \
        inspect.signature(jpg.PAFScorer.from_config).parameters.keys()


def _paf_batch(seed, b=3, hp=24, wp=28, stride=4, n_inst=3, n_nodes=5, clutter=4):
    """Instances laid along the edges with PAFs that point along them, plus
    clutter peaks and invalid slots: flat peaks as ``find_local_peaks`` gives."""
    rng = np.random.default_rng(seed)
    leaf = _leaf(stride=stride)
    names = leaf["part_names"]
    edges = [(names.index(s), names.index(d)) for s, d in leaf["edges"]]
    pafs = rng.normal(0, 0.1, (b, hp, wp, 2 * len(edges))).astype(np.float32)
    peaks, vals, chans = [], [], []
    for i in range(b):
        p, v, c = [], [], []
        for _ in range(n_inst):
            pts = rng.uniform(8, min(hp, wp) * stride - 8, (n_nodes, 2)).astype(np.float32)
            for e, (s, d) in enumerate(edges):
                disp = pts[d] - pts[s]
                unit = disp / max(np.linalg.norm(disp), 1e-6)
                for t in np.linspace(0, 1, 12):
                    x, y = ((pts[s] + t * disp) / stride).astype(int)
                    pafs[i, min(y, hp - 1), min(x, wp - 1), 2 * e:2 * e + 2] = unit
            p.extend(pts)
            v.extend(rng.uniform(0.3, 1.0, n_nodes))
            c.extend(range(n_nodes))
        for _ in range(clutter):
            p.append(rng.uniform(0, min(hp, wp) * stride, 2))
            v.append(rng.uniform(0.1, 0.3))
            c.append(int(rng.integers(n_nodes)))
        order = np.argsort(-np.asarray(v), kind="stable")
        peaks.append(np.asarray(p, np.float32)[order])
        vals.append(np.asarray(v, np.float32)[order])
        chans.append(np.asarray(c, np.int32)[order])
    peaks, vals, chans = map(np.stack, (peaks, vals, chans))
    valid = np.ones(chans.shape, bool)
    valid[-1, -3:] = False  # padded slots
    peaks[-1, -3:] = np.nan
    chans[-1, -3:] = -1
    return leaf, pafs, peaks, vals, chans, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed,stride,knobs", [(0, 4, {}), (1, 2, {"min_line_scores": -0.5}),
                                               (2, 4, {"k_per_node": 2,
                                                       "min_instance_peaks": 2})])
def test_paf_scorer_predict_matches_jax(seed, stride, knobs, dtype):
    leaf, pafs, peaks, vals, chans, valid = _paf_batch(seed, stride=stride)
    ts = tpg.PAFScorer.from_config(leaf, **knobs)
    js = jpg.PAFScorer.from_config(leaf, **knobs)
    js.score_on_device = jax.jit(js.score_on_device)  # the production form
    pafs_t = torch.from_numpy(pafs).to(dtype)
    got = ts.predict(pafs_t, torch.from_numpy(peaks), torch.from_numpy(vals),
                     torch.from_numpy(chans), torch.from_numpy(valid))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = js.predict(jnp.asarray(pafs, jdt), jnp.asarray(peaks), jnp.asarray(vals),
                      jnp.asarray(chans), jnp.asarray(valid))
    assert isinstance(got, list) and len(got) == len(want) == pafs.shape[0]
    n_inst = 0
    for g, w in zip(got, want):
        assert isinstance(g, tuple) and len(g) == len(w) == 3
        for a, c in zip(g, w):
            assert a.shape == c.shape and a.dtype == c.dtype
            np.testing.assert_array_equal(np.isnan(a), np.isnan(c))
            np.testing.assert_allclose(a, c, rtol=0, atol=1e-5)
        n_inst += len(g[0])
    assert n_inst >= pafs.shape[0]
    # The same as the scorer's two halves by hand.
    gp, gv, _, sc = ts.score_on_device(pafs_t, torch.from_numpy(peaks), torch.from_numpy(vals),
                                       torch.from_numpy(chans), torch.from_numpy(valid))
    by_hand = [ts.group_sample(gp[i].numpy(), gv[i].float().numpy(), sc[i].float().numpy())
               for i in range(gp.shape[0])]
    for g, h in zip(got, by_hand):
        for a, c in zip(g, h):
            np.testing.assert_array_equal(a, c)


# -- make_confmaps ---------------------------------------------------------------------


@pytest.mark.parametrize("lead", [(), (3,), (2, 4)])
@pytest.mark.parametrize("sigma", [1.5, 5.0])
def test_make_confmaps_matches_jax_with_missing_points(lead, sigma):
    rng = np.random.default_rng(len(lead) + int(sigma))
    n_nodes, h, w = 4, 24, 20
    pts = rng.uniform(-4, 28, (*lead, n_nodes, 2)).astype(np.float32)
    flat = pts.reshape(-1, n_nodes, 2)
    flat[0, 1] = np.nan  # a missing node
    flat[-1, 2, 1] = np.nan  # one coordinate missing
    xv = (np.arange(w, dtype=np.float32) * 2)
    yv = (np.arange(h, dtype=np.float32) * 2)
    got = pcm.make_confmaps(torch.from_numpy(pts), torch.from_numpy(xv), torch.from_numpy(yv),
                            sigma).numpy()
    want = np.asarray(jcm.make_confmaps(jnp.asarray(pts), jnp.asarray(xv), jnp.asarray(yv),
                                        sigma))
    assert got.shape == want.shape == (*lead, h, w, n_nodes) and got.dtype == np.float32
    assert not np.isnan(got).any()
    g = got.reshape(-1, h, w, n_nodes)
    assert (g[0, ..., 1] == 0).all() and (g[-1, ..., 2] == 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # generate_confmaps renders through it, on the stride's grid.
    gen = pcm.generate_confmaps(torch.from_numpy(pts), (2 * h, 2 * w), sigma=sigma / 2,
                                output_stride=2).numpy()
    np.testing.assert_array_equal(gen, got)


# -- the heads' loss_function ------------------------------------------------------------

JAX_HEADS = sorted(name for name, cls in vars(jheads).items()
                   if isinstance(cls, type) and issubclass(cls, jheads.Head)
                   and name != "OffsetRefinementHead")  # JAX never builds it


@pytest.mark.parametrize("name", JAX_HEADS)
def test_every_head_reports_jax_loss_function(name):
    got, want = getattr(pheads, name)(), getattr(jheads, name)()
    assert got.loss_function == want.loss_function
    assert (got.name, got.activation) == (want.name, want.activation)


def test_head_types_cover_jax():
    assert "ClassVectorsHead" in JAX_HEADS and "Head" in JAX_HEADS
    assert pheads.ClassVectorsHead().loss_function == "categorical_crossentropy"
    assert pheads.MultiInstanceConfmapsHead().loss_function == "mse"
