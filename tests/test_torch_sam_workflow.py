"""The port's SAM mask-review workflow (``sleap_nn_tpu_torch/inference/sam``)
against the JAX package's (``sleap_nn_tpu/inference/sam``) on the CPU.

Both packages run the same seeded tiny SAM (``tests/test_torch_sam_model``'s
arch and weights): ``JaxSamBackend.masks`` in float32 and bfloat16,
``run_sam_segmentation`` (prompt modes, frames, disjointify, the ``.slp``
and the overlay it writes), ``run.predict(mask_backend=...)``, the ``sam``
command and ``predict --mask-backend`` from a local snapshot dir. The
port's entry points default to the card: the tests ask for the CPU with
``device="cpu"``, or, for the command line (which has no device option, as
in JAX), by wrapping ``get_mask_backend`` so that it passes ``"cpu"``.

Tolerances. float32: low-res logits and IoU scores 1e-4 absolute; a final
mask may differ from JAX's only at pixels whose upscaled port logit lies
within 1e-4 of 0 (none did at these seeds). bfloat16 (both packages cast
weights and image, the softmax stays float32; JAX promotes the grid
positions to float32 where the port keeps bf16): logits 0.25 and IoU 0.05
absolute, masks differing only where the upscaled port logit is within
0.25 of 0. Candidate picks, prompts and saved masks are exact.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import sleap_nn_tpu.inference.sam as jsam_pkg
from sleap_nn_tpu import cli as jcli
from sleap_nn_tpu.inference.run import predict as jax_predict
from sleap_nn_tpu.inference.sam import backends as jbk
from sleap_nn_tpu.inference.sam import prompts as jprompts
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.io.slp import load_slp as jax_load_slp
from sleap_nn_tpu.models import sam_jax as jsam
from sleap_nn_tpu_torch import cli as pcli
from sleap_nn_tpu_torch.inference import run as prun
from sleap_nn_tpu_torch.inference import sam as psam_pkg
from sleap_nn_tpu_torch.inference.sam import backends as pbk
from sleap_nn_tpu_torch.inference.sam import prompts as pprompts
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.io.slp import load_slp, save_slp
from sleap_nn_tpu_torch.models import sam_jax as psam
from tests.test_torch_sam_model import TINY_HF, seeded_state
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

TOL = {False: 1e-4, True: 0.25}
IOU_TOL = {False: 1e-4, True: 0.05}


@pytest.fixture(scope="module")
def tiny():
    arch = psam.SamArch.from_hf_config(TINY_HF)
    state = seeded_state(arch, seed=1)
    return arch, jsam.SamArch.from_hf_config(TINY_HF), state, jsam.convert_sam_state_dict(state)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory, tiny):
    """A local HF snapshot dir: config.json + model.safetensors."""
    from safetensors.numpy import save_file
    from transformers import SamConfig

    d = tmp_path_factory.mktemp("snap")
    (d / "config.json").write_text(json.dumps(SamConfig(**TINY_HF).to_dict()))
    state = {k: v for k, v in tiny[2].items() if k not in psam.TIED_KEYS}
    save_file(state, str(d / "model.safetensors"))
    return d


def backends(tiny, use_bf16=False, clahe=True):
    arch, jarch, state, jparams = tiny
    return (pbk.JaxSamBackend(state, arch, clahe=clahe, use_bf16=use_bf16, device="cpu"),
            jbk.JaxSamBackend(jparams, jarch, clahe=clahe, use_bf16=use_bf16))


def prompt(mod, points=None, box=None, reject=(0.0, 0.0, 20.0, 24.0)):
    return mod.SamPrompt(
        point_coords=None if points is None else np.asarray(points, np.float32),
        point_labels=None if points is None else np.ones(len(points), np.int32),
        box=None if box is None else np.asarray(box, np.float32),
        reject_box=np.asarray(reject, np.float32), mode="pose" if points is not None else "box")


PROMPT_SETS = {
    "points": [dict(points=[[5.0, 6.0]]), dict(points=[[12.0, 18.0], [3.0, 3.0], [7.0, 9.0]]),
               dict(points=[[15.0, 10.0]])],
    "boxes": [dict(box=[2.0, 2.0, 15.0, 20.0]), dict(box=[6.0, 1.0, 19.0, 12.0])],
    # A box beside point-only prompts: those take their reject box.
    "mixed": [dict(box=[2.0, 2.0, 18.0, 16.0]), dict(points=[[10.0, 10.0]]),
              dict(points=[[4.0, 20.0], [8.0, 16.0]], reject=(0.0, 10.0, 12.0, 24.0))],
    "one": [dict(points=[[9.0, 11.0]], box=[1.0, 3.0, 17.0, 22.0])],
}


def captured(backend, port):
    """Wrap the backend's batched decode; returns the list it appends
    (low-res logits (P, 3, m, m), IoU (P, 3)) to."""
    seen = []
    if port:
        real = backend._decode

        def dec(*a, **k):
            out = real(*a, **k)
            seen.append(out)
            return out

        backend._decode = dec
    else:
        real_fn = backend._decode_fn

        def fn_for(*key):
            fn = real_fn(*key)

            def run(*a):
                low, iou = fn(*a)
                seen.append((np.asarray(low, np.float32)[0], np.asarray(iou, np.float32)[0]))
                return low, iou

            return run

        backend._decode_fn = fn_for
    return seen


def upscaled(low, arch, frame_hw, scale):
    import cv2

    nh, nw = (int(frame_hw[0] * scale + 0.5), int(frame_hw[1] * scale + 0.5))
    up = cv2.resize(low, (arch.image_size, arch.image_size), interpolation=cv2.INTER_LINEAR)
    return cv2.resize(up[:nh, :nw], (frame_hw[1], frame_hw[0]), interpolation=cv2.INTER_LINEAR)


@pytest.mark.parametrize("use_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(PROMPT_SETS))
def test_backend_masks_match_jax(tiny, name, use_bf16):
    arch = tiny[0]
    port, jax_b = backends(tiny, use_bf16)
    got_low, want_low = captured(port, True), captured(jax_b, False)
    img = np.random.default_rng(len(name)).uniform(0, 255, (24, 20)).astype(np.uint8)
    got_m, got_s = port.masks(img, [prompt(pprompts, **p) for p in PROMPT_SETS[name]])
    want_m, want_s = jax_b.masks(img, [prompt(jprompts, **p) for p in PROMPT_SETS[name]])
    (gl, gi), (wl, wi) = got_low[0], want_low[0]
    assert gl.shape == wl.shape and gi.shape == wi.shape  # the same buckets
    np.testing.assert_allclose(gl, wl, rtol=0, atol=TOL[use_bf16])
    np.testing.assert_allclose(gi, wi, rtol=0, atol=IOU_TOL[use_bf16])
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=IOU_TOL[use_bf16])
    scale = arch.image_size / 24
    for i, (g, w) in enumerate(zip(got_m, want_m)):
        assert g.shape == (24, 20) and g.dtype == bool
        picked = [c for c in range(3) if np.isclose(gi[i, c], got_s[i], atol=0)]
        full = upscaled(gl[i, picked[0]], arch, (24, 20), scale)
        assert np.all(np.abs(full[g != w]) <= TOL[use_bf16]), (i, int((g != w).sum()))
        if not use_bf16:
            assert np.array_equal(g, w)


def test_backend_pads_prompts_and_points_to_buckets(tiny):
    port, _ = backends(tiny)
    assert [port._bucket(n) for n in range(1, 10)] == \
        [jbk.JaxSamBackend._bucket(n) for n in range(1, 10)] == [1, 2, 4, 4, 8, 8, 8, 8, 16]
    shapes = []
    real = port._decode

    def dec(emb, pts, labs, boxes, n_points, with_box):
        shapes.append((pts.shape, labs.copy(), boxes.shape, n_points, with_box))
        return real(emb, pts, labs, boxes, n_points, with_box)

    port._decode = dec
    img = np.zeros((16, 16), np.uint8)
    port.masks(img, [prompt(pprompts, points=[[4.0, 4.0]] * k) for k in (1, 3, 2)])
    port.masks(img, [prompt(pprompts, box=[1.0, 1.0, 9.0, 9.0])])
    (p1, l1, b1, n1, w1), (p2, _, _, n2, w2) = shapes
    assert (p1, b1, n1, w1) == ((1, 4, 4, 2), (1, 4, 4), 4, False)
    assert (l1 == -10).sum() == 16 - 6 and (l1[0, 3] == -10).all()
    assert (p2, n2, w2) == ((1, 1, 1, 2), 0, True)
    assert port.masks(img, []) == ([], [])


def test_backend_runs_on_the_card_unless_asked(tiny, snapshot, monkeypatch, tmp_path):
    arch, _, state, _ = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pbk.JaxSamBackend(state, arch)
    with pytest.raises(RuntimeError, match="CUDA"):
        psam_pkg.get_mask_backend("sam_jax", sam_model_id=str(snapshot))
    src = pose_labels(pio)
    with pytest.raises(RuntimeError, match="CUDA"):
        prun.predict(src, [], mask_backend="sam_jax", sam_model_id=str(snapshot))
    save_slp(tmp_path / "p.slp", src, embed=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        pcli.main(["sam", "-i", str(tmp_path / "p.slp"), "--mask-backend", "sam_jax",
                   "--sam-model-id", str(snapshot)])


def test_from_pretrained_reads_local_snapshots_only(tiny, snapshot, monkeypatch, tmp_path):
    port = pbk.JaxSamBackend.from_pretrained(str(snapshot), device="cpu", clahe=False)
    want = jbk.JaxSamBackend.from_pretrained(str(snapshot), clahe=False)
    assert port.arch.__dict__ == want.arch.__dict__
    img = np.random.default_rng(3).uniform(0, 255, (24, 20)).astype(np.uint8)
    got = port.masks(img, [prompt(pprompts, points=[[6.0, 7.0]])])
    exp = want.masks(img, [prompt(jprompts, points=[[6.0, 7.0]])])
    assert np.array_equal(got[0][0], exp[0][0])
    np.testing.assert_allclose(got[1], exp[1], rtol=0, atol=1e-4)
    # An id in the local HF cache (under HOME); an absent one raises naming
    # it, and nothing is fetched.
    monkeypatch.setenv("HOME", str(tmp_path))
    snap = tmp_path / ".cache/huggingface/hub/models--org--tiny-sam/snapshots/abc123"
    snap.mkdir(parents=True)
    for f in ("config.json", "model.safetensors"):
        (snap / f).write_bytes((snapshot / f).read_bytes())
    cached = pbk.JaxSamBackend.from_pretrained("org/tiny-sam", device="cpu", clahe=False)
    assert np.array_equal(cached.masks(img, [prompt(pprompts, points=[[6.0, 7.0]])])[0][0],
                          got[0][0])
    with pytest.raises(FileNotFoundError, match="facebook/sam-vit-huge.*downloads nothing"):
        psam_pkg.get_mask_backend("sam_jax", device="cpu")
    (tmp_path / "notsam").mkdir()
    (tmp_path / "notsam" / "config.json").write_text("{}")
    from safetensors.numpy import save_file

    save_file({"x": np.zeros(2, np.float32)}, str(tmp_path / "notsam" / "model.safetensors"))
    for pkg in (pbk, jbk):
        with pytest.raises(ValueError, match="missing SAM keys"):
            pkg.JaxSamBackend.from_pretrained(str(tmp_path / "notsam"))


def test_other_loaders_refuse_as_jax_does(tmp_path, monkeypatch):
    """``sam``, ``sam_legacy`` and ``sam3``: the JAX package's checks in its
    order, then its ImportError, without importing their packages."""
    for mod in ("transformers", "segment_anything"):
        monkeypatch.setitem(sys.modules, mod, None)
    ckpt = tmp_path / "sam_vit_b_01ec64.pth"
    ckpt.write_bytes(b"")
    for name, kw, error, match in (
            ("sam", {}, ImportError, "mask_backend='sam' needs `transformers`"),
            ("sam_legacy", {}, ValueError, "needs a LOCAL `segment-anything` checkpoint"),
            ("sam_legacy", {"sam_model_id": str(ckpt)}, ImportError,
             "needs the `segment-anything` package"),
            ("sam3", {}, ImportError, "mask_backend='sam3' requires a transformers release"),
            (None, {}, ValueError, "has no default"),
            ("dino", {}, ValueError, "Unknown mask_backend")):
        for pkg in (psam_pkg, jsam_pkg):
            with pytest.raises(error, match=match):
                pkg.get_mask_backend(name, device="cpu", **kw)
    assert psam_pkg.MASK_BACKENDS == jsam_pkg.MASK_BACKENDS
    assert set(psam_pkg.__all__) == set(jsam_pkg.__all__)


class FakeHFProcessor:
    """SamProcessor's call, ``.to`` and ``image_processor.post_process_masks``."""

    def __init__(self, cands):
        self.cands, self.calls = cands, []
        self.image_processor = self

    def __call__(self, rgb, return_tensors="pt", **kw):
        self.calls.append({k: v for k, v in kw.items()})
        out = {"original_sizes": torch.tensor([rgb.shape[:2]]),
               "reshaped_input_sizes": torch.tensor([rgb.shape[:2]])}
        return type("Inputs", (dict,), {"to": lambda self, device: self})(out)

    def post_process_masks(self, masks, original, reshaped):
        return [torch.from_numpy(self.cands[len(self.calls) - 1])[None]]


class FakeHFModel:
    def __init__(self, scores):
        self.scores, self.n = scores, 0

    def __call__(self, multimask_output=True, **inputs):
        self.n += 1
        scores = torch.tensor(self.scores[self.n - 1])[None, None]
        return type("Out", (), {"pred_masks": torch.zeros(1), "iou_scores": scores})()


class FakePredictor:
    def __init__(self, cands, scores):
        self.cands, self.scores, self.calls = cands, scores, []

    def set_image(self, rgb):
        self.image = rgb

    def predict(self, **kw):
        self.calls.append(kw)
        i = len(self.calls) - 1
        return self.cands[i], self.scores[i], None


def test_injected_backends_match_jax():
    """HFSamBackend, SamLegacyBackend and Sam3Backend on injected fakes:
    the same picks, scores, clean-up and calls in both packages."""
    from tests.inference.test_sam3_backend import _FakeModel, _FakeProcessor, _speckly_mask

    rng = np.random.default_rng(0)
    h, w = 64, 80
    cands = rng.random((3, 3, h, w)) > np.array([0.3, 0.9, 0.99])[None, :, None, None]
    scores = rng.random((3, 3)).astype(np.float32)
    img = rng.integers(0, 255, (h, w), dtype=np.uint8)
    pts = [dict(points=[[10.0, 12.0], [20.0, 30.0]], reject=(0, 0, 40, 50)),
           dict(box=[5.0, 5.0, 60.0, 50.0], reject=(5, 5, 60, 50)),
           dict(points=[[70.0, 40.0]], reject=(50, 20, 79, 63))]
    out = {}
    for name, mod, pkg in (("port", pprompts, pbk), ("jax", jprompts, jbk)):
        ps = [prompt(mod, **p) for p in pts]
        hf = pkg.HFSamBackend(FakeHFModel(scores), FakeHFProcessor(cands), device="cpu")
        legacy = pkg.SamLegacyBackend(FakePredictor(cands, scores))
        speck = np.stack([[_speckly_mask((30, 30)), np.ones((h, w), bool), cands[i, 2]]
                          for i in range(3)])
        sam3 = pkg.Sam3Backend(_FakeModel(speck, scores), _FakeProcessor(speck), device="cpu")
        out[name] = [(b.masks(img, ps), getattr(b, "processor", getattr(b, "predictor", None)))
                     for b in (hf, legacy, sam3)]
    for (got, gp), (want, wp) in zip(out["port"], out["jax"]):
        assert got[1] == want[1]
        assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
        assert json.dumps(gp.calls, default=str) == json.dumps(wp.calls, default=str)


# -- run_sam_segmentation, run.predict and the command line -----------------------


class ArrayVideo:
    """An in-memory video for both packages' labels models."""

    filename = "frames.mp4"

    def __init__(self, frames):
        self.frames = frames
        self.shape = frames.shape

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return self.frames[i]

    def to_backend_json(self):
        return {"backend": {"filename": self.filename}}


def pose_labels(io, n_frames=4):
    """Frames of 40x36 with 0-3 tracked predicted instances of 3 nodes (one
    frame empty, one instance with no visible node, one with a NaN node)."""
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 255, (n_frames, 40, 36, 1), dtype=np.uint8)
    skel = io.Skeleton(["a", "b", "c"], edges=[("a", "b"), ("b", "c")])
    tracks = [io.Track(name=f"t{i}") for i in range(3)]
    video = ArrayVideo(frames)
    lfs = []
    for f in range(n_frames):
        insts = []
        for i in range(f % 4):
            pts = rng.uniform(4, 30, (3, 2))
            if (f, i) == (2, 1):
                pts[1] = np.nan
            if (f, i) == (3, 2):
                pts[:] = np.nan
            insts.append(io.PredictedInstance.from_numpy(
                points=pts, skeleton=skel, point_scores=np.ones(3), score=0.9, track=tracks[i]))
        lfs.append(io.LabeledFrame(video=video, frame_idx=f, instances=insts))
    return io.Labels(labeled_frames=lfs, videos=[video], skeletons=[skel], tracks=tracks)


def assert_same_mask_labels(got, want):
    assert [lf.frame_idx for lf in got] == [lf.frame_idx for lf in want]
    for g, w in zip(got, want):
        assert len(g.instances) == len(w.instances)
        for gi, wi in zip(g.instances, w.instances):
            np.testing.assert_array_equal(gi.numpy(), wi.numpy())
        assert len(g.masks) == len(w.masks)
        for gm, wm in zip(g.masks, w.masks):
            assert np.array_equal(gm.mask, wm.mask)
            assert gm.score == pytest.approx(wm.score, abs=1e-4)
            assert getattr(gm.track, "name", None) == getattr(wm.track, "name", None)


@pytest.mark.parametrize("mode,kw", [
    ("pose", {}),
    ("centroid", {"anchor_ind": 1}),
    ("box", {"disjointify_masks": True}),
    ("pose", {"frames": [1, 3], "clean_empty_frames": True, "disjointify_masks": True}),
])
def test_run_sam_segmentation_matches_jax(tiny, tmp_path, mode, kw):
    port_b, jax_b = backends(tiny)
    got = psam_pkg.run_sam_segmentation(
        pose_labels(pio), "sam_jax", prompt_mode=mode, backend=port_b,
        output_path=tmp_path / "port.slp", overlay_path=tmp_path / "port.png", embed=True, **kw)
    want = jsam_pkg.run_sam_segmentation(
        pose_labels(jio), "sam_jax", prompt_mode=mode, backend=jax_b,
        output_path=tmp_path / "jax.slp", overlay_path=tmp_path / "jax.png", embed=True, **kw)
    assert_same_mask_labels(got, want)
    n_prompted = sum(1 for lf in got for i in lf.instances if np.isfinite(i.numpy()).any())
    assert sum(len(lf.masks) for lf in got) == n_prompted > 0
    # The .slp reads back with equal masks, in either package.
    assert_same_mask_labels(load_slp(tmp_path / "port.slp"), got)
    assert_same_mask_labels(jax_load_slp(str(tmp_path / "port.slp")), want)
    import cv2

    assert np.array_equal(cv2.imread(str(tmp_path / "port.png")),
                          cv2.imread(str(tmp_path / "jax.png")))


def test_run_predict_short_circuits_to_sam(tiny, snapshot, tmp_path):
    src = tmp_path / "poses.slp"
    save_slp(src, pose_labels(pio), embed=True)
    got = prun.predict(str(src), [], mask_backend="sam_jax", sam_model_id=str(snapshot),
                       device="cpu", sam_prompt_mode="box", sam_disjointify_masks=True,
                       sam_overlay_path=tmp_path / "o.png", output_path=tmp_path / "p.slp",
                       frames=[1, 2])
    want = jax_predict(str(src), [], mask_backend="sam_jax", sam_model_id=str(snapshot),
                       sam_prompt_mode="box", sam_disjointify_masks=True,
                       output_path=tmp_path / "j.slp", frames=[1, 2])
    assert_same_mask_labels(got, want)
    assert (tmp_path / "o.png").exists()
    assert_same_mask_labels(load_slp(tmp_path / "p.slp"), want)
    for fn, kwargs in ((prun.predict, {"device": "cpu"}), (jax_predict, {})):
        with pytest.raises(ValueError, match="cannot be combined with model_paths"):
            fn(str(src), ["some_dir"], mask_backend="sam_jax", **kwargs)


@pytest.fixture
def on_cpu(monkeypatch):
    """The command line has no device option for SAM (as in JAX): its
    backend factory is wrapped to build on the CPU."""
    real = psam_pkg.get_mask_backend
    monkeypatch.setattr(psam_pkg, "get_mask_backend",
                        lambda name, **kw: real(name, **{**kw, "device": "cpu"}))


def test_sam_command_matches_jax(snapshot, tmp_path, capsys, on_cpu):
    src = tmp_path / "poses.slp"
    save_slp(src, pose_labels(pio), embed=True)
    tail = ["--mask-backend", "sam_jax", "--sam-model-id", str(snapshot), "--prompt-mode",
            "centroid", "--anchor-ind", "0", "--disjointify", "--frames", "1-3"]
    want = CliRunner().invoke(jcli.cli, ["sam", "-i", str(src), "-o", str(tmp_path / "j.slp"),
                                         "--overlay-path", str(tmp_path / "j.png")] + tail)
    assert want.exit_code == 0, want.output
    capsys.readouterr()
    assert pcli.main(["sam", "-i", str(src), "--overlay-path", str(tmp_path / "p.png")]
                     + tail) == 0
    out = tmp_path / "poses.masks.slp"  # the default: <input>.masks.slp
    assert capsys.readouterr().out == want.output.replace(str(tmp_path / "j.slp"), str(out))
    got, exp = load_slp(out), jax_load_slp(str(tmp_path / "j.slp"))
    assert_same_mask_labels(got, exp)
    assert sum(len(lf.masks) for lf in got) > 0 and (tmp_path / "p.png").exists()


def test_predict_mask_backend_on_the_command_line(snapshot, tmp_path, capsys, on_cpu):
    src = tmp_path / "poses.slp"
    save_slp(src, pose_labels(pio), embed=True)
    argv = ["predict", "-i", str(src), "--mask-backend", "sam_jax", "--sam-checkpoint",
            str(snapshot), "--sam-prompt-mode", "box", "--device", "cpu"]
    want = CliRunner().invoke(jcli.cli, argv + ["-o", str(tmp_path / "j.slp")])
    assert want.exit_code == 0, want.output
    capsys.readouterr()
    assert pcli.main(argv + ["-o", str(tmp_path / "p.slp")]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        want.output.strip().splitlines()[-1].replace("j.slp", "p.slp")
    assert_same_mask_labels(load_slp(tmp_path / "p.slp"), jax_load_slp(str(tmp_path / "j.slp")))


@pytest.mark.parametrize("seed", range(6))
def test_prompt_builders_match_jax(seed):
    """Every mode's prompt, and the product rule's fallbacks, equal exactly."""
    rng = np.random.default_rng(seed)
    kpts = rng.uniform(-5, 70, (5, 2)).astype(np.float32)
    kpts[rng.random(5) < 0.4] = np.nan
    centroid = None if seed % 3 == 0 else rng.uniform(0, 60, 2)
    hw = (48, 64)
    for mode in jprompts.PROMPT_MODES + ("nope",):
        for keypoints in (kpts, None, np.full((3, 2), np.nan)):
            out = []
            for mod in (pprompts, jprompts):
                try:
                    p = mod.prompt_for_instance(mode, hw, keypoints=keypoints, centroid=centroid,
                                                margin_min=5.0 + seed)
                    out.append(("ok", {k: None if v is None else np.asarray(v).tolist()
                                       for k, v in vars(p).items()}))
                except ValueError as e:
                    out.append(("error", str(e)))
            assert out[0] == out[1], (mode, keypoints)
    vis = pprompts.visible_keypoints(kpts)
    np.testing.assert_array_equal(vis, jprompts.visible_keypoints(kpts))
    if len(vis):
        np.testing.assert_array_equal(pprompts.keypoint_box(vis, hw),
                                      jprompts.keypoint_box(vis, hw))
