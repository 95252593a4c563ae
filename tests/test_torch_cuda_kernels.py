"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (the decision is
made inside the fixture, never at import). On a machine with an NVIDIA
GPU and nvcc:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py -q

Tolerances: the NMS score map exactly; the fused conv in f32 to 1e-4 of
the output's largest magnitude (sums in another order) and in bf16 to one
bf16 ulp at that magnitude (a mid value within an f32 rounding error of a
bf16 tie may round the other way in the two versions); the PAF line
scores to 1e-5 absolute (the mean is summed in another order; line points
and subscripts are computed alike), with -inf and NaN placement exact; the
multi-instance confmaps to 1e-6 absolute (outputs <= 1; ``expf`` and
ATen's ``exp`` may differ by ulps), and in the cull cases with zeros placed
exactly. NaN in the fused conv's input: NaN placement exact, the tolerance
on the rest. The public functions given layouts the kernels refuse (views,
misaligned starts) copy them first: the PAF scores equal the dense call's
bit for bit, the maps the plain version's to 1e-6. Bottom-up
``Predictor.predict`` on the card groups in the C++ library (``native/``),
inline and in two spawn workers alike, and gives the instances, in their
order, that the library gives on the fetched scores.
"""

import types

import numpy as np
import pytest
import torch

from sleap_nn_tpu_torch.ops.fused_conv import KERNEL, _plain_double_conv, fused_double_conv3x3
from sleap_nn_tpu_torch.inference.paf_grouping import line_fractions
from sleap_nn_tpu_torch.ops.grid import make_grid_vectors
from sleap_nn_tpu_torch.ops.kernels import (
    MULTI_CONFMAPS,
    NMS_SCORES,
    PAF_LINE_SCORES,
    _launch_multi_confmaps,
    _plain_multi_confmaps,
    _plain_nms_scores,
    _plain_paf_line_scores,
    confmap_cull_counts,
    multi_confmaps,
    nms_scores,
    paf_line_scores,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["relu", "identity"])
@pytest.mark.parametrize(
    "shape,c_mid,c_out,nan",
    [((1, 7, 9, 1), 4, 3, False), ((2, 13, 21, 5), 24, 24, False),
     ((1, 9, 17, 303), 121, 121, False), ((3, 33, 40, 17), 7, 5, False),
     # medium_rf's odd-channel blocks (dec3, dec2, enc4), H and W no multiple of a tile
     ((2, 37, 45, 90), 36, 36, False), ((1, 29, 35, 135), 54, 54, False),
     ((2, 19, 23, 81), 121, 121, False),
     ((1, 13, 11, 128), 256, 256, False),  # large_rf enc3
     ((2, 21, 27, 24), 36, 36, True), ((1, 30, 35, 1), 24, 24, True)],
)
def test_fused_conv_kernel_matches_plain(cuda, shape, c_mid, c_out, nan, activation, dtype):
    rng = np.random.default_rng(sum(shape))
    c_in = shape[-1]
    x = rng.standard_normal(shape, dtype=np.float32)
    if nan:  # one NaN pixel in the interior and one on the border
        x[0, 5, 7, 0] = x[-1, -1, 3, -1] = np.nan
    x = torch.from_numpy(x).to(cuda, dtype)
    w1 = torch.from_numpy(rng.standard_normal((3, 3, c_in, c_mid), dtype=np.float32)
                          / np.sqrt(9 * c_in)).to(cuda)
    w2 = torch.from_numpy(rng.standard_normal((3, 3, c_mid, c_out), dtype=np.float32)
                          / np.sqrt(9 * c_mid)).to(cuda)
    b1 = torch.from_numpy(rng.standard_normal(c_mid, dtype=np.float32) * 0.1).to(cuda)
    b2 = torch.from_numpy(rng.standard_normal(c_out, dtype=np.float32) * 0.1).to(cuda)
    before = KERNEL.launches
    got = fused_double_conv3x3(x, w1, b1, w2, b2, activation)
    want = _plain_double_conv(x, w1, b1, w2, b2, activation)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert got.dtype == dtype and got.shape == (*shape[:3], c_out)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(want).any() == nan
    fin = ~torch.isnan(want)
    top = want[fin].float().abs().max().item()
    tol = 2.0 ** (np.floor(np.log2(top)) - 7) if dtype == torch.bfloat16 else 1e-4 * top
    assert (got[fin].float() - want[fin].float()).abs().max().item() <= tol


def test_fused_conv_kernel_takes_unaligned_x(cuda):
    rng = np.random.default_rng(7)
    flat = torch.from_numpy(rng.standard_normal(1 + 2 * 9 * 11 * 3, dtype=np.float32))
    x = flat.to(cuda, torch.bfloat16)[1:].view(2, 9, 11, 3)  # 2 bytes past an aligned start
    w1 = torch.from_numpy(rng.standard_normal((3, 3, 3, 8), dtype=np.float32) * 0.3).to(cuda)
    w2 = torch.from_numpy(rng.standard_normal((3, 3, 8, 5), dtype=np.float32) * 0.3).to(cuda)
    got = fused_double_conv3x3(x, w1, None, w2, None)
    want = _plain_double_conv(x, w1, None, w2, None)
    top = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 2.0 ** (np.floor(np.log2(top)) - 7)


def test_fused_conv_repacks_a_changed_weight(cuda):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 4), dtype=np.float32)).to(cuda)
    conv1, conv2 = torch.nn.Conv2d(4, 6, 3).to(cuda), torch.nn.Conv2d(6, 5, 3).to(cuda)
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            args = (conv1.weight.permute(2, 3, 1, 0), conv1.bias,
                    conv2.weight.permute(2, 3, 1, 0), conv2.bias)
            first = fused_double_conv3x3(xd, *args)
            conv1.weight.mul_(-1.0)  # in place: the same storage, a new version
            conv2.bias.add_(1.0)
            second = fused_double_conv3x3(xd, *args)
            want = _plain_double_conv(xd, *args)
            torch.cuda.synchronize()
            assert not torch.equal(first, second)
            top = want.float().abs().max().item()
            tol = 2.0 ** (np.floor(np.log2(top)) - 7) if dtype == torch.bfloat16 else 1e-4 * top
            assert (second.float() - want.float()).abs().max().item() <= tol


# The up blocks of both top-down UNets at medium_rf width (filters 24, rate
# 1.5, max stride 32): (low map's side, its channels, the skip's, c_mid),
# the centroid model's on 1024^2 frames and the instance model's on 160^2
# crops.
UP_BLOCKS_1024 = [(32, 182, 121, 121), (64, 121, 81, 81), (128, 81, 54, 54),
                  (256, 54, 36, 36), (512, 36, 24, 24)]
UP_BLOCKS_160 = [(5, 182, 121, 121), (10, 121, 81, 81), (20, 81, 54, 54), (40, 54, 36, 36),
                 (80, 36, 24, 24)]


@pytest.mark.parametrize(
    "b,hl,wl,c_l,c_s,c_mid,nan",
    [(b, s, s, c_l, c_s, c_mid, False) for b in (8, 1)
     for s, c_l, c_s, c_mid in UP_BLOCKS_1024 + UP_BLOCKS_160]
    # odd sizes: tile edges that split the 2 x 2 parents, one-pixel maps, NaN
    + [(2, 13, 19, 54, 36, 36, False), (1, 37, 45, 9, 5, 7, False), (3, 7, 3, 81, 54, 54, False),
       (1, 1, 9, 17, 3, 8, False), (2, 11, 14, 36, 24, 24, True)],
)
def test_fused_conv_two_source_form_matches_upsample_and_concat(cuda, b, hl, wl, c_l, c_s,
                                                                 c_mid, nan):
    """Kernel 1 given a decoder block's skip and low-resolution input equals
    kernel 1 on today's ``bilinear_upsample`` + ``cat`` of them, to one bf16
    ulp of the output's largest magnitude (the blend is PyTorch's
    arithmetic; prints how many outputs differ at all)."""
    from sleap_nn_tpu_torch.models.encoder_decoder import bilinear_upsample

    gen = torch.Generator(device=cuda).manual_seed(hl * 1000 + c_l * 10 + b)
    low = torch.randn(b, hl, wl, c_l, generator=gen, device=cuda).relu_().to(torch.bfloat16)
    skip = torch.randn(b, 2 * hl, 2 * wl, c_s, generator=gen, device=cuda).relu_().to(
        torch.bfloat16)
    if nan:  # one NaN on the low map's border, one in the skip
        low[0, 0, 5, 1] = skip[-1, 7, 3, 0] = float("nan")
    c_in = c_s + c_l
    w1 = torch.randn(3, 3, c_in, c_mid, generator=gen, device=cuda) / np.sqrt(9 * c_in)
    w2 = torch.randn(3, 3, c_mid, c_mid, generator=gen, device=cuda) / np.sqrt(9 * c_mid)
    b1 = torch.randn(c_mid, generator=gen, device=cuda) * 0.1
    b2 = torch.randn(c_mid, generator=gen, device=cuda) * 0.1
    before = KERNEL.launches
    got = fused_double_conv3x3(skip, w1, b1, w2, b2, upsample=low)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    want = fused_double_conv3x3(torch.cat([skip, bilinear_upsample(low)], dim=-1), w1, b1, w2, b2)
    assert got.shape == want.shape == (b, 2 * hl, 2 * wl, c_mid)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(want).any() == nan
    fin = ~torch.isnan(want)
    diff = (got[fin].float() - want[fin].float()).abs()
    top = want[fin].float().abs().max().item()
    print(f"two_source b={b} low={hl}x{wl}x{c_l} skip={c_s} -> {c_mid}: "
          f"{int((diff > 0).sum())} of {diff.numel()} differ, max {diff.max().item():.3g} "
          f"(top {top:.3g})")
    assert diff.max().item() <= 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("case,fused", [("bf16", True), ("f32", False), ("grad", True),
                                        ("not_2x", False), ("tracing", False)])
def test_decoder_block_falls_back_to_upsample_and_concat_on_the_card(cuda, case, fused,
                                                                       monkeypatch):
    """A fused up block with a skip twice its input's size hands both to
    the wrapper, and kernel 1 builds their concat in bf16 only, with export
    off (``decoder.fused_upsample`` 1); a non-2x skip (in the block), f32
    and export (in the wrapper) upsample and concatenate first, as before
    (0). With autograd on, kernel 1 refuses either way, as before."""
    from sleap_nn_tpu_torch import profiling
    from sleap_nn_tpu_torch.models import encoder_decoder as ed
    from sleap_nn_tpu_torch.ops import library

    dtype = torch.float32 if case == "f32" else torch.bfloat16
    block = ed.SimpleUpsamplingBlock(54, 36, 36, use_fused=True).to(cuda, dtype)
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2, 20, 22, 54, generator=gen, device=cuda).to(dtype)
    size = (41, 44) if case == "not_2x" else (40, 44)
    feature = torch.randn(2, *size, 36, generator=gen, device=cuda).to(dtype)
    calls, counts = [], []
    real = ed.fused_double_conv3x3
    monkeypatch.setattr(ed, "fused_double_conv3x3",
                        lambda *a, **k: calls.append(k.get("upsample")) or real(*a, **k))
    monkeypatch.setattr(profiling, "count", lambda name, value, key=None: counts.append(
        value) if name == "decoder.fused_upsample" else None)
    if case == "tracing":
        monkeypatch.setattr(library, "tracing_active", lambda: True)
    if case == "grad":
        with pytest.raises(RuntimeError, match="no backward"):
            block(x, feature)
    else:
        with torch.no_grad():
            got = block(x, feature)
        assert counts == [int(fused)]
    assert [low is not None for low in calls] == [case != "not_2x"]
    if case == "grad":
        return
    with torch.no_grad():
        cat = torch.cat([feature, ed.resize_bilinear(ed.bilinear_upsample(x), *size)], dim=-1)
        want = real(cat.contiguous(), ed.hwio(block.blocks["dec_refine_conv0"].weight),
                    block.blocks["dec_refine_conv0"].bias,
                    ed.hwio(block.blocks["dec_refine_conv1"].weight),
                    block.blocks["dec_refine_conv1"].bias)
    torch.cuda.synchronize()
    if fused:
        top = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= 2.0 ** (
            np.floor(np.log2(top)) - 7)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", [3, 5])
@pytest.mark.parametrize("shape", [(2, 37, 45, 3), (2, 29, 101, 15), (1, 3, 1100, 1)])
def test_nms_kernel_matches_plain_exactly(cuda, shape, kernel, dtype):
    # W * C of the last two: 1515 and 1100, no multiple of a block's 1024-element span.
    cms = torch.from_numpy(np.random.default_rng(kernel).random(shape, dtype=np.float32))
    cms[0, 1, 5, 0] = cms[-1, -1, -1, -1] = float("nan")
    cms[0, 2, 80 % shape[2], -1] = 2.0  # a peak near a span boundary
    cms = cms.to(cuda, dtype)
    before = NMS_SCORES.launches
    got = nms_scores(cms, 0.3, kernel)
    assert NMS_SCORES.launches == before + 1
    assert torch.equal(got, _plain_nms_scores(cms, 0.3, kernel))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_mid,c_out", [(1, 24, 24), (24, 36, 36)])
def test_fused_conv_kernel_at_a_tile_chunk(cuda, c_in, c_mid, c_out, dtype):
    """Tiled predict: a chunk of 16 tiles of 512x512 through medium_rf's
    first two blocks."""
    rng = np.random.default_rng(c_in)
    x = torch.from_numpy(rng.random((16, 512, 512, c_in), dtype=np.float32)).to(cuda, dtype)
    w1 = torch.from_numpy(rng.standard_normal((3, 3, c_in, c_mid), dtype=np.float32)
                          / np.sqrt(9 * c_in)).to(cuda)
    w2 = torch.from_numpy(rng.standard_normal((3, 3, c_mid, c_out), dtype=np.float32)
                          / np.sqrt(9 * c_mid)).to(cuda)
    b1 = torch.zeros(c_mid, device=cuda)
    b2 = torch.zeros(c_out, device=cuda)
    got = fused_double_conv3x3(x, w1, b1, w2, b2)
    want = _plain_double_conv(x, w1, b1, w2, b2)
    top = want.float().abs().max().item()
    tol = 2.0 ** (np.floor(np.log2(top)) - 7) if dtype == torch.bfloat16 else 1e-4 * top
    assert got.shape == (16, 512, 512, c_out)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nms_kernel_at_a_merged_canvas(cuda, dtype):
    """Tiled predict in local mode: the merged (2, 1024, 1024, 1) canvases."""
    cms = torch.from_numpy(np.random.default_rng(24).random((2, 1024, 1024, 1),
                                                            dtype=np.float32)).to(cuda, dtype)
    before = NMS_SCORES.launches
    got = nms_scores(cms, 0.2, 3)
    assert NMS_SCORES.launches == before + 1
    assert torch.equal(got, _plain_nms_scores(cms, 0.2, 3))


def test_nms_kernel_matches_plain_at_bottomup_channels(cuda):
    cms = torch.from_numpy(np.random.default_rng(15).random((2, 64, 48, 15), dtype=np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        x = cms.to(cuda, dtype)
        assert torch.equal(nms_scores(x, 0.2), _plain_nms_scores(x, 0.2))


def _paf_inputs(seed, b, hp, wp, n_nodes, k, n_edges, stride, device):
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n_nodes, n_edges), rng.integers(0, n_nodes, n_edges)],
                     axis=1).astype(np.int32)
    pafs = rng.standard_normal((b, hp, wp, 2 * n_edges), dtype=np.float32)
    grid = rng.integers(-2, 2 * max(hp, wp) + 2, (b, n_nodes, k, 2)) * (stride / 2)
    cont = rng.uniform(-3 * stride, (max(hp, wp) + 3) * stride, (b, n_nodes, k, 2))
    peaks = np.where(rng.random((b, n_nodes, k, 1)) < 0.5, grid, cont).astype(np.float32)
    mask = rng.random((b, n_nodes, k)) < 0.8
    peaks[rng.random((b, n_nodes, k)) < 0.1] = np.nan  # NaN under an open mask too
    peaks[0, 0, 0, 1] = np.nan  # y alone NaN: the reference's arithmetic gives NaN
    mask[0, 0, 0] = True
    return [torch.from_numpy(a).to(device) for a in (pafs, peaks, mask, edges)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,hp,wp,n_nodes,k,n_edges,n_points,stride",
    [(1, 5, 7, 2, 1, 1, 10, 4), (2, 33, 17, 5, 6, 7, 7, 2), (3, 64, 80, 15, 20, 14, 10, 4),
     (1, 40, 40, 4, 9, 3, 1, 8),
     # K = 40: 1600 pairs, beyond one block's 512 threads; P = 40 and 33: more than
     # two unrolled chunks of 16 line points; stride 3
     (2, 48, 40, 6, 40, 5, 10, 4), (2, 30, 30, 5, 7, 4, 40, 4), (2, 33, 29, 5, 8, 4, 10, 3),
     (1, 20, 24, 4, 6, 3, 33, 3), (1, 16, 16, 3, 1, 2, 1, 3)],
)
def test_paf_line_scores_kernel_matches_plain(cuda, b, hp, wp, n_nodes, k, n_edges,
                                              n_points, stride, dtype):
    pafs, peaks, mask, edges = _paf_inputs(b + k, b, hp, wp, n_nodes, k, n_edges, stride, cuda)
    args = (pafs.to(dtype), peaks, mask, edges, line_fractions(n_points, cuda), stride,
            0.25 * max(hp, wp, 2 * n_edges) * stride, 1.0)
    before = PAF_LINE_SCORES.launches
    got = paf_line_scores(*args)
    want = _plain_paf_line_scores(*args)
    torch.cuda.synchronize()
    assert PAF_LINE_SCORES.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, n_edges, k, k)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "b,n_inst,n_nodes,h,w,stride,sigma",
    [(4, 6, 1, 1024, 1024, 2, 5.0), (4, 6, 15, 512, 512, 2, 2.5), (3, 1, 2, 37, 53, 1, 1.5),
     (2, 9, 3, 96, 64, 4, 4.0),
     (4, 6, 1, 512, 512, 2, 5.0)],  # tiled centroid training: 512 tiles -> (4, 256, 256, 1)
)
def test_multi_confmaps_kernel_matches_plain(cuda, b, n_inst, n_nodes, h, w, stride, sigma):
    rng = np.random.default_rng(n_inst * n_nodes)
    pts = rng.uniform(-8, max(h, w) + 8, (b, n_inst, n_nodes, 2)).astype(np.float32)
    pts[rng.random((b, n_inst, n_nodes)) < 0.2] = np.nan  # NaN nodes
    pts[0, -1] = np.nan  # a padding instance
    pts = torch.from_numpy(pts).to(cuda)
    xv, yv = make_grid_vectors(h, w, stride, device=cuda)
    before = MULTI_CONFMAPS.launches
    got = multi_confmaps(pts, xv, yv, sigma * stride)
    want = _plain_multi_confmaps(pts, xv, yv, sigma * stride)
    torch.cuda.synchronize()
    assert MULTI_CONFMAPS.launches == before + 1
    assert got.shape == (b, len(yv), len(xv), n_nodes) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert got.max().item() > 0.5


def _confmap_case(case):
    """(points, xv, yv, sigma) of one cull case, numpy."""
    rng = np.random.default_rng(len(case))
    b, n_inst, n_nodes, h, w, stride, sigma = 2, 5, 3, 70, 45, 2, 2.5
    if case == "ragged":
        h, w = 37, 61  # no multiple of a tile
    if case == "odd_width_15_nodes":
        n_nodes, h, w = 15, 19, 51  # row spans of 51 * 15 floats, unaligned
    xv = np.arange(0, w * stride, stride, dtype=np.float32)
    yv = np.arange(0, h * stride, stride, dtype=np.float32)
    pts = rng.uniform(-8, max(h, w) * stride + 8, (b, n_inst, n_nodes, 2)).astype(np.float32)
    pts[rng.random((b, n_inst, n_nodes)) < 0.2] = np.nan
    if case == "far":
        pts[:, :3] += np.float32(4000.0)
        pts[0, 3, 0] = [-1e30, 5.0]
        pts[1, 3, 1] = [np.inf, 5.0]
    if case == "all_nan":
        pts[0] = np.nan  # one image of the batch has no point at all
    if case == "tiny_sigma":
        sigma = 1e-3
        pts[..., 0] = rng.choice(xv, pts.shape[:3])  # on the grid: some terms are exactly 1
        pts[..., 1] = rng.choice(yv, pts.shape[:3])
    if case == "huge_sigma":
        sigma = 1e4
    if case == "descending_xv":
        xv = xv[::-1].copy()
    if case == "shuffled_xv":
        xv, yv = rng.permutation(xv), rng.permutation(yv)
    return pts, xv, yv, sigma * stride


@pytest.mark.parametrize("case", ["far", "all_nan", "tiny_sigma", "huge_sigma", "descending_xv",
                                  "shuffled_xv", "ragged", "odd_width_15_nodes"])
def test_multi_confmaps_kernel_cull_cases(cuda, case):
    """The culled kernel against its plain version: zeros placed exactly
    (0 wherever the plain version is 0, > 0 wherever it is >= 1e-30), the
    rest to 1e-6."""
    pts, xv, yv, sigma = (torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray) else a
                          for a in _confmap_case(case))
    before = MULTI_CONFMAPS.launches
    got = multi_confmaps(pts, xv, yv, sigma)
    want = _plain_multi_confmaps(pts, xv, yv, sigma)
    torch.cuda.synchronize()
    assert MULTI_CONFMAPS.launches == before + 1
    assert got.shape == want.shape == (pts.shape[0], len(yv), len(xv), pts.shape[2])
    assert (got[want == 0] == 0).all()
    assert (got[want >= 1e-30] > 0).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert (want > 0.5).any()
    if case == "all_nan":
        assert (got[0] == 0).all()
    # The kernel's own count of what its cull kept equals the host model's.
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    out = torch.empty_like(got)
    _launch_multi_confmaps(pts, xv, yv, out, sigma, stats)
    assert torch.equal(out, got)
    assert tuple(stats.tolist()) == confmap_cull_counts(pts, xv, yv, sigma)[:2]


def test_paf_head_output_is_read_in_place(cuda):
    """The PAF head's NHWC output on the card is a dense map, so
    ``score_paf_lines_dense``'s ``.contiguous()`` copies nothing."""
    from types import SimpleNamespace as ns

    from sleap_nn_tpu_torch.config.model_config import UNetConfig
    from sleap_nn_tpu_torch.inference.backends import TorchBackend
    from sleap_nn_tpu_torch.models.model import Model

    cfg = UNetConfig(in_channels=1, filters=8, filters_rate=1.5, max_stride=16, output_stride=2)
    heads = ns(confmaps=ns(part_names=["a", "b", "c"], sigma=2.5, output_stride=2,
                           loss_weight=None),
               pafs=ns(edges=[["a", "b"], ["b", "c"]], sigma=15.0, output_stride=4,
                       loss_weight=None))
    model = Model.from_config("unet", cfg, heads, "bottomup")
    x = torch.rand(2, 64, 64, 1, device=cuda)
    for use_bf16 in (True, False):
        backend = TorchBackend(model, None, use_bf16=use_bf16, output_dtype=None, device=cuda)
        with torch.inference_mode():
            pafs = backend(x)["PartAffinityFieldsHead"]
        assert pafs.shape == (2, 16, 16, 4) and pafs.is_contiguous()


def test_fused_conv_refuses_autograd(cuda):
    x = torch.rand(1, 8, 8, 2, device=cuda)
    w = torch.rand(3, 3, 2, 2, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_double_conv3x3(x, w, None, w, None)
    with torch.no_grad():
        assert fused_double_conv3x3(x, w, None, w, None).shape == (1, 8, 8, 2)


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(1, 4, 4, 2, device=cuda, dtype=torch.float16)
    w = torch.zeros(3, 3, 2, 2, device=cuda)
    with pytest.raises(TypeError):
        fused_double_conv3x3(x, w, None, w, None)
    with pytest.raises(ValueError, match="contiguous"):
        fused_double_conv3x3(x.float().transpose(1, 2), w, None, w, None)
    with pytest.raises(TypeError):
        nms_scores(torch.zeros(1, 4, 4, 1, device=cuda, dtype=torch.float16), 0.2)
    with pytest.raises(ValueError, match="3 to 9"):
        nms_scores(torch.zeros(1, 4, 4, 1, device=cuda), 0.2, kernel=11)
    pafs, peaks, mask, edges = _paf_inputs(0, 1, 8, 8, 2, 3, 1, 4, cuda)
    t = line_fractions(10, cuda)
    with pytest.raises(TypeError):
        paf_line_scores(pafs.half(), peaks, mask, edges, t, 4, 8.0, 1.0)
    with pytest.raises(TypeError, match="grouped_mask"):
        paf_line_scores(pafs, peaks, mask.float(), edges, t, 4, 8.0, 1.0)
    with pytest.raises(ValueError, match="edge_inds"):
        paf_line_scores(pafs, peaks, mask, edges.cpu(), t, 4, 8.0, 1.0)
    shifted = torch.zeros(peaks.numel() + 1, device=cuda)[1:].view(peaks.shape)
    shifted.copy_(peaks)  # contiguous, but 4 bytes past an (x, y) pair's alignment
    with pytest.raises(ValueError, match="grouped_peaks must be aligned"):
        paf_line_scores(pafs, shifted, mask, edges, t, 4, 8.0, 1.0)
    xv, yv = make_grid_vectors(8, 8, 1, device=cuda)
    with pytest.raises(TypeError):
        multi_confmaps(torch.zeros(1, 1, 1, 2, device=cuda, dtype=torch.float64), xv, yv, 1.0)
    with pytest.raises(ValueError, match="xv"):
        multi_confmaps(torch.zeros(1, 1, 1, 2, device=cuda), xv.cpu(), yv, 1.0)


def _off_by(x: torch.Tensor, elements: int = 1) -> torch.Tensor:
    """A contiguous copy of ``x`` whose data starts ``elements`` elements past
    an aligned allocation."""
    flat = torch.zeros(x.numel() + elements, dtype=x.dtype, device=x.device)[elements:]
    return flat.view(x.shape).copy_(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_score_paf_lines_dense_copies_the_layouts_the_kernel_refuses(cuda, dtype):
    """Views the JAX function takes: non-contiguous peaks and mask, peaks 4
    bytes off 8-byte alignment, and PAFs off channel-pair alignment. Each
    gives the dense call's scores bit for bit, and the kernel's wrapper
    still refuses it when called directly."""
    from sleap_nn_tpu_torch.inference.paf_grouping import score_paf_lines_dense

    pafs, peaks, mask, edges = _paf_inputs(11, 2, 24, 20, 4, 6, 3, 4, cuda)
    pafs = pafs.to(dtype)
    t = line_fractions(10, cuda)
    kw = dict(n_line_points=10, pafs_stride=4)
    dense = score_paf_lines_dense(pafs, peaks, mask, edges, **kw)
    max_len = 0.25 * max(24, 20, 2 * 3) * 4
    want = _plain_paf_line_scores(pafs, peaks, mask, edges, t, 4, max_len, 1.0)
    fin = torch.isfinite(want)
    torch.testing.assert_close(dense[fin], want[fin], rtol=0, atol=1e-5)
    strided = lambda x: x.transpose(1, 2).contiguous().transpose(1, 2)  # noqa: E731
    views = {
        "non-contiguous peaks and mask": (pafs, strided(peaks), strided(mask)),
        "peaks off 8-byte alignment": (pafs, _off_by(peaks), mask),
        "pafs off channel-pair alignment": (_off_by(pafs), peaks, mask),
    }
    for name, (p, g, m) in views.items():
        assert not (g.is_contiguous() and m.is_contiguous() and g.data_ptr() % 8 == 0
                    and p.data_ptr() % (2 * p.element_size()) == 0), name
        before = PAF_LINE_SCORES.launches
        got = score_paf_lines_dense(p, g, m, edges, **kw)
        torch.cuda.synchronize()
        assert PAF_LINE_SCORES.launches == before + 1, name
        assert torch.equal(got.nan_to_num(), dense.nan_to_num()), name
        assert torch.equal(got.isnan(), dense.isnan()), name
        with pytest.raises(ValueError, match="contiguous|aligned"):
            paf_line_scores(p, g, m, edges, t, 4, max_len, 1.0)


def test_make_multi_confmaps_copies_a_node_slice(cuda):
    """A node slice ``pts[..., :5, :]`` and a strided grid, with and without
    leading axes: the maps of the dense copy, held against the plain
    version; the kernel's wrapper still refuses the slice."""
    from sleap_nn_tpu_torch.ops.confmaps import make_multi_confmaps

    rng = np.random.default_rng(12)
    pts = rng.uniform(-4, 140, (2, 3, 4, 8, 2)).astype(np.float32)
    pts[rng.random((2, 3, 4, 8)) < 0.2] = np.nan
    pts = torch.from_numpy(pts).to(cuda)
    xv_all, yv = make_grid_vectors(96, 2 * 136, 2, device=cuda)
    xv = xv_all[::2]  # a strided grid: 0, 4, 8, ...
    for lead in (True, False):
        sl = (pts if lead else pts[0])[..., :5, :]
        assert not sl.is_contiguous() and not xv.is_contiguous()
        before = MULTI_CONFMAPS.launches
        got = make_multi_confmaps(sl, xv, yv, 5.0)
        torch.cuda.synchronize()
        assert MULTI_CONFMAPS.launches == before + 1
        want = _plain_multi_confmaps(sl.reshape(-1, 4, 5, 2).contiguous(), xv.contiguous(), yv,
                                     5.0)
        assert got.shape == (*sl.shape[:-3], 48, 68, 5)
        torch.testing.assert_close(got.reshape(want.shape), want, rtol=0, atol=1e-6)
        assert want.max().item() > 0.5
    with pytest.raises(ValueError, match="contiguous"):
        multi_confmaps(pts[0][..., :5, :], xv.contiguous(), yv, 5.0)


def _bottomup_layer(device):
    """A narrow bottom-up model (the trainer's Xavier init, zero biases) on
    64x64 blob frames (4 nodes, 3 edges), its confmap head moved onto
    [0, 1] per channel."""
    from sleap_nn_tpu_torch.config.model_config import UNetConfig
    from sleap_nn_tpu_torch.inference import layers as tl
    from sleap_nn_tpu_torch.inference.backends import TorchBackend
    from sleap_nn_tpu_torch.inference.paf_grouping import PAFScorer
    from sleap_nn_tpu_torch.models.model import Model
    from sleap_nn_tpu_torch.training.model_trainer import xavier_init_params

    ns = types.SimpleNamespace
    names, edges = ["n0", "n1", "n2", "n3"], [("n0", "n1"), ("n1", "n2"), ("n0", "n3")]
    heads = ns(confmaps=ns(part_names=names, sigma=2.5, output_stride=2, loss_weight=None),
               pafs=ns(edges=[list(e) for e in edges], sigma=15.0, output_stride=4,
                       loss_weight=None))
    cfg = UNetConfig(in_channels=1, filters=8, filters_rate=1.5, max_stride=8, output_stride=2)
    model = xavier_init_params(Model.from_config("unet", cfg, heads, "bottomup"),
                               torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:64, :64]
    frames = np.zeros((8, 64, 64, 1), np.float32)
    for i in range(8):
        for cy, cx in rng.uniform(10, 54, (3, 2)):
            frames[i, ..., 0] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
    frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    with torch.no_grad():
        maps = model(torch.from_numpy(frames / np.float32(255)))["MultiInstanceConfmapsHead"]
        top, bottom = maps.amax(dim=(0, 1, 2)), maps.amin(dim=(0, 1, 2))
        conv = next(layer["MultiInstanceConfmapsHead"][0] for layer in model.head_layers
                    if "MultiInstanceConfmapsHead" in layer)
        conv.weight.div_((top - bottom)[:, None, None, None])
        conv.bias.copy_(-bottom / (top - bottom))
    post = tl.PostprocessConfig(peak_threshold=0.2, max_peaks=40, max_instances=None,
                                min_line_scores=-0.5)
    layer = tl.BottomUpLayer(
        TorchBackend(model, model.state_dict(), fused_convs=True, device=device),
        tl.PreprocessConfig(ensure_grayscale=True, max_stride=8), post,
        paf_scorer=PAFScorer(names, edges, pafs_stride=4, min_line_scores=-0.5, k_per_node=6),
        cm_output_stride=2, device=device)
    return layer, frames


@pytest.mark.parametrize("paf_workers", [0, 2])
def test_bottomup_predict_groups_natively_on_the_card(cuda, paf_workers):
    from sleap_nn_tpu_torch import native
    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.inference.providers import VideoProvider
    from sleap_nn_tpu_torch.inference.streaming import group_batch_host

    assert native.get_lib() is not None, native.build_log
    layer, frames = _bottomup_layer(cuda)

    class Frames:
        shape = frames.shape

        def __len__(self):
            return len(frames)

        def get_frame(self, idx, fmt=None):
            return frames[idx]

    pred = Predictor(layer, "bottomup", batch_size=4, device=str(cuda), paf_workers=paf_workers)
    got = pred.predict(provider=VideoProvider(Frames(), batch_size=4), make_labels=False)
    assert len(got) == 2 and all(out["valid"].all() for out in got)
    n_inst = 0
    for i, out in enumerate(got):
        # The library's grouping of the same batch's fetched scores, inline.
        want = group_batch_host(layer.device_to_payload(layer.predict_async(
            frames[4 * i:4 * i + 4])), layer.paf_scorer, None)
        for key in ("pred_keypoints", "pred_peak_values", "pred_instance_scores"):
            assert len(out[key]) == len(want[key]) == 4
            for g, w in zip(out[key], want[key]):
                np.testing.assert_array_equal(g, w, err_msg=key)  # in the same order
        n_inst += sum(len(k) for k in out["pred_keypoints"])
    assert n_inst >= 8


def _medium_rf_topdown(device, frame=256, crop=64):
    """A bf16 top-down layer of two medium_rf UNets (filters 24, rate 1.5,
    max stride 32, output stride 1; 15 nodes, 6 instances), He-normal
    convs with zero biases and heads of gain 0.1 and bias 0.5, so that the
    maps vary about 0.5; noise frames of ``frame``^2."""
    from sleap_nn_tpu_torch.config.model_config import UNetConfig
    from sleap_nn_tpu_torch.inference import layers as tl
    from sleap_nn_tpu_torch.inference.backends import TorchBackend
    from sleap_nn_tpu_torch.models.model import Model

    ns = types.SimpleNamespace
    cfg = UNetConfig(in_channels=1, filters=24, filters_rate=1.5, max_stride=32, output_stride=1)
    gen = torch.Generator().manual_seed(0)
    models = []
    for model_type, heads in (
            ("centroid", ns(confmaps=ns(anchor_part=None, sigma=5.0, output_stride=1,
                                        loss_weight=None))),
            ("centered_instance", ns(confmaps=ns(part_names=[f"n{i}" for i in range(15)],
                                                 anchor_part=None, sigma=5.0, output_stride=1,
                                                 loss_weight=None)))):
        model = Model.from_config("unet", cfg, heads, model_type)
        with torch.no_grad():
            for conv in model.backbone.modules():
                if isinstance(conv, torch.nn.Conv2d):
                    conv.weight.normal_(generator=gen).mul_((2.0 / conv.weight[0].numel()) ** 0.5)
                    conv.bias.zero_()
            for layer in model.head_layers:
                for head in layer.values():
                    head[0].weight.normal_(generator=gen).mul_(0.1 * head[0].in_channels ** -0.5)
                    head[0].bias.fill_(0.5)
        models.append(model)
    pre = tl.PreprocessConfig(ensure_grayscale=True, max_stride=32)
    kw = dict(use_bf16=True, fused_convs=True, output_dtype=None, device=device)
    layer = tl.TopDownLayer(
        tl.CentroidLayer(TorchBackend(models[0], None, **kw), pre,
                         tl.PostprocessConfig(peak_threshold=0.2, max_instances=6),
                         output_stride=1, device=device),
        tl.CenteredInstanceLayer(TorchBackend(models[1], None, **kw), pre,
                                 tl.PostprocessConfig(peak_threshold=0.2), output_stride=1,
                                 device=device),
        max_instances=6, crop_size=crop, device=device)
    frames = np.random.default_rng(1).integers(0, 256, (8, frame, frame, 1), dtype=np.uint8)
    return layer, frames


def test_topdown_fused_upsample_matches_the_unfused_sequence(cuda):
    """The medium_rf top-down layer with its up blocks' fused upsample
    against the same layer forced onto upsample + concat + kernel 1 (the
    fallback): the UNets' maps, the peaks and their values to
    ``tests/test_torch_topdown.py``'s 1e-4, validity and counts exactly."""
    from sleap_nn_tpu_torch.models.encoder_decoder import SimpleUpsamplingBlock

    layer, frames = _medium_rf_topdown(cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    crops = torch.rand(48, layer.crop_size, layer.crop_size, 1, generator=gen, device=cuda)
    x = torch.from_numpy(frames).to(cuda) / 255
    backends = (layer.centroid_layer.backend, layer.instance_layer.backend)

    def run():
        maps = [next(iter(backend(v).values())) for backend, v in zip(backends, (x, crops))]
        out = layer.predict(frames)
        torch.cuda.synchronize()
        return maps, out

    got_maps, got = run()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(SimpleUpsamplingBlock, "_fuses_upsample", lambda *a: False)
        want_maps, want = run()
    for g, w in zip(got_maps, want_maps):
        print(f"topdown maps {tuple(w.shape)}: {int((g != w).sum())} of {w.numel()} differ")
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=1e-4)
    assert set(got) == set(want)
    assert want["instance_valid"].sum() >= 8
    for k, w in want.items():
        g = got[k]
        w, g = (w.cpu().numpy(), g.cpu().numpy()) if torch.is_tensor(w) else (w, g)
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=k)


def test_topdown_batch_fuses_every_up_block(cuda):
    """One top-down batch: ``decoder.fused_upsample`` reads 1 for each of
    the 10 up blocks (5 a UNet), and kernel 1 launches once a double-conv
    block (5 encoder and 5 decoder blocks a UNet), as when the blocks
    upsampled and concatenated first (the counter read through a patched
    ``profiling.count``, so no profiler session opens)."""
    from sleap_nn_tpu_torch import profiling
    from sleap_nn_tpu_torch.models.encoder_decoder import SimpleUpsamplingBlock

    layer, frames = _medium_rf_topdown(cuda)
    layer.predict(frames)  # warm: the build, the weights' packing
    torch.cuda.synchronize()
    launches = []
    for force_fallback in (False, True):
        before, counts = KERNEL.launches, []
        with pytest.MonkeyPatch.context() as m:
            m.setattr(profiling, "count", lambda name, value, key=None: counts.append(
                value) if name == "decoder.fused_upsample" else None)
            if force_fallback:
                m.setattr(SimpleUpsamplingBlock, "_fuses_upsample", lambda *a: False)
            layer.predict(frames)
            torch.cuda.synchronize()
        assert counts == [0 if force_fallback else 1] * 10
        launches.append(KERNEL.launches - before)
    assert launches == [20, 20]


# -- the registered operators (ops/library.py) that exported programs call --------


def _op_args(op, dtype, dev, rng):
    """Inputs of each operator at the export paths' shapes (batch 4)."""
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa
    if op == "fused_double_conv3x3":
        return (t(4, 256, 256, 24).to(dtype), t(3, 3, 24, 36) * 0.1, t(36),
                t(3, 3, 36, 36) * 0.1, t(36), "relu")
    if op == "nms_scores":
        return (t(4, 512, 512, 15).to(dtype), 0.2, 3)
    peaks = torch.from_numpy(rng.uniform(0, 1024, (4, 15, 20, 2)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.random((4, 15, 20)) < 0.7).to(dev)
    edges = torch.tensor([[i, i + 1] for i in range(14)], dtype=torch.int32, device=dev)
    return (t(4, 256, 256, 28).to(dtype), peaks, mask, edges,
            line_fractions(10, device=dev), 4.0, 256.0, 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["fused_double_conv3x3", "nms_scores", "paf_line_scores"])
def test_registered_operator_equals_the_kernel_wrapper(cuda, op, dtype):
    from sleap_nn_tpu_torch.ops import kernels, library

    wrapper = {"fused_double_conv3x3": fused_double_conv3x3, "nms_scores": kernels.nms_scores,
               "paf_line_scores": kernels.paf_line_scores}[op]
    kernel = {"fused_double_conv3x3": KERNEL, "nms_scores": NMS_SCORES,
              "paf_line_scores": PAF_LINE_SCORES}[op]
    args = _op_args(op, dtype, cuda, np.random.default_rng(0))
    with torch.inference_mode():
        want = wrapper(*args)
        before = kernel.launches
        got = library.OPS[op](*args)
        torch.cuda.synchronize()
    assert kernel.launches == before + 1  # the operator launched the kernel
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


class _Frames:
    """An in-memory video of blob frames (the labels model's and the
    predictor's interface)."""

    def __init__(self, frames):
        self.frames, self.shape, self.filename = frames, frames.shape, "frames.mp4"

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx):
        return self.frames[idx]

    def get_frame(self, idx, fmt=None):
        return self.frames[idx]


def _blob_frames(n, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:64, :64]
    out = np.zeros((n, 64, 64, 1), np.float32)
    for i in range(n):
        for _ in range(2):
            cy, cx = rng.uniform(12, 52, 2)
            out[i, ..., 0] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def test_exported_program_launches_the_kernels_where_it_is_loaded(cuda, tmp_path):
    """A narrow bottom-up model exported on the CPU runs on the card when
    loaded there: its graph's tensors move, kernels 1, 2 and 3 launch,
    and its outputs are those of the program exported on the card and of
    the untraced wrapper there, bit for bit."""
    from sleap_nn_tpu_torch.config import TrainingJobConfig
    from sleap_nn_tpu_torch.export import export_model, load_exported_model
    from sleap_nn_tpu_torch.export.exporter import _build_wrapper
    from sleap_nn_tpu_torch.inference.loaders import load_model
    from sleap_nn_tpu_torch.io import model as pio
    from sleap_nn_tpu_torch.training import ModelTrainer

    rng = np.random.default_rng(2)
    video = _Frames(_blob_frames(8, seed=2))
    skel = pio.Skeleton(["n0", "n1", "n2"], edges=[(0, 1), (1, 2)])
    labels = pio.Labels([pio.LabeledFrame(video, f, [
        pio.Instance(rng.uniform(12, 52, 2) + rng.normal(0, 4, (3, 2)), skel)
        for _ in range(2)]) for f in range(8)])
    cfg = TrainingJobConfig.from_dict({
        "data_config": {"validation_fraction": 0.25, "use_augmentations_train": False},
        "model_config": {
            "backbone_config": {"unet": {"filters": 8, "filters_rate": 1.5, "max_stride": 8,
                                         "output_stride": 2}},
            "head_configs": {"bottomup": {"confmaps": {"sigma": 2.5, "output_stride": 2},
                                          "pafs": {"sigma": 15.0, "output_stride": 4}}}},
        "trainer_config": {"max_epochs": 1, "train_steps_per_epoch": 1, "save_ckpt": True,
                           "ckpt_dir": str(tmp_path), "run_name": "bottomup",
                           "enable_progress_bar": False, "train_data_loader": {"batch_size": 2},
                           "val_data_loader": {"batch_size": 2}}})
    trainer = ModelTrainer.get_model_trainer_from_config(cfg, [labels], device="cpu")
    trainer.train()
    cpu_dir = export_model(trainer.ckpt_dir, output_dir=tmp_path / "cpu", device="cpu",
                           peak_threshold=-1e9)
    card_dir = export_model(trainer.ckpt_dir, output_dir=tmp_path / "card", device="cuda",
                            peak_threshold=-1e9)
    x = _blob_frames(4, seed=3)
    moved, _ = load_exported_model(cpu_dir, device="cuda")
    native, _ = load_exported_model(card_dir, device="cuda")
    kernels = (KERNEL, NMS_SCORES, PAF_LINE_SCORES)
    counts = {k.name: k.launches for k in kernels}
    got = moved(x)
    torch.cuda.synchronize()
    assert {k.name: k.launches - counts[k.name] for k in kernels} == {
        "fused_double_conv3x3": 5, "nms_scores": 1, "paf_line_scores": 1}
    program, _, _ = _build_wrapper(load_model(trainer.ckpt_dir), -1e9, 4, 200, device="cuda")
    with torch.inference_mode():
        eager = program(torch.from_numpy(x).cuda())
    for want in (native(x), eager):
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].device.type == "cuda"
            assert torch.equal(torch.isnan(got[k]), torch.isnan(v)), k
            assert torch.equal(torch.nan_to_num(got[k]), torch.nan_to_num(v)), k


def test_every_kernel_runs_on_every_card(cuda):
    """Each kernel on each card the process sees, the last first, against
    its plain version on that card: what a launch sets on a device (kernel
    1's raised shared-memory limit) must be set on each, not once for the
    first (data-parallel predict puts a replica on every card)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(11)
    for i in reversed(range(n)):
        dev = torch.device("cuda", i)
        x = torch.from_numpy(rng.standard_normal((2, 37, 45, 90), dtype=np.float32))
        w1 = rng.standard_normal((3, 3, 90, 36), dtype=np.float32) / np.sqrt(9 * 90)
        w2 = rng.standard_normal((3, 3, 36, 36), dtype=np.float32) / np.sqrt(9 * 36)
        b1, b2 = (rng.standard_normal(36, dtype=np.float32) * 0.1 for _ in range(2))
        conv = [x.to(dev, torch.bfloat16)] + [torch.from_numpy(a).to(dev)
                                              for a in (w1, b1, w2, b2)]
        got, want = fused_double_conv3x3(*conv), _plain_double_conv(*conv)
        top = want.float().abs().max().item()
        assert got.device == dev
        assert (got.float() - want.float()).abs().max().item() <= 2.0 ** (np.floor(np.log2(top))
                                                                          - 7)
        cms = torch.from_numpy(rng.random((2, 64, 64, 3), dtype=np.float32)).to(dev)
        assert torch.equal(nms_scores(cms, 0.2), _plain_nms_scores(cms, 0.2))
        pafs, peaks, mask, edges = _paf_inputs(i, 2, 64, 80, 15, 20, 14, 4, dev)
        args = (pafs.to(torch.bfloat16), peaks, mask, edges, line_fractions(10, dev), 4,
                80.0, 1.0)
        got, want = paf_line_scores(*args), _plain_paf_line_scores(*args)
        fin = torch.isfinite(want)
        assert torch.equal(torch.isneginf(got), torch.isneginf(want))
        torch.testing.assert_close(got[fin], want[fin], rtol=0, atol=1e-5)
        pts = torch.from_numpy(rng.uniform(0, 512, (4, 6, 15, 2)).astype(np.float32)).to(dev)
        xv, yv = make_grid_vectors(256, 256, 2, device=dev)
        torch.testing.assert_close(multi_confmaps(pts, xv, yv, 5.0),
                                   _plain_multi_confmaps(pts, xv, yv, 5.0), rtol=0, atol=1e-6)


def test_the_predict_path_never_waits_for_the_card(cuda):
    """Local and global peaks, the integral refinement and the crop gather
    enqueue their work without a host sync (``set_sync_debug_mode``
    raises on one): a sync in a layer's ``predict_async`` serializes the
    replicas of data-parallel predict. ``crop_bboxes`` once copied
    host-made tensors to the card, which waits for the stream."""
    from sleap_nn_tpu_torch.ops.crops import crop_bboxes, make_centered_bboxes
    from sleap_nn_tpu_torch.ops.peaks import find_global_peaks, find_local_peaks

    rng = np.random.default_rng(5)
    cms = torch.from_numpy(rng.random((2, 64, 64, 3), dtype=np.float32)).to(cuda,
                                                                              torch.bfloat16)
    images = torch.from_numpy(rng.random((2, 128, 128, 1), dtype=np.float32)).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        points, vals, channels, valid = find_local_peaks(cms, 0.2, "integral", 5, max_peaks=20)
        find_global_peaks(cms, 0.2, "integral", 5)
        bboxes = make_centered_bboxes(points.reshape(-1, 2) * 2, 32, 32)  # NaN: empty crops
        sample_inds = torch.arange(2, device=cuda).repeat_interleave(20)
        crops = crop_bboxes(images, bboxes, sample_inds, 32, 32)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert crops.shape == (40, 32, 32, 1)


def test_a_trace_holds_the_last_kernels_of_its_block(cuda, tmp_path):
    """``profiling.trace`` ends after the block's queued work: a block that
    ends with kernels still queued behind a long one (no sync, as a
    training's last epoch-end viz) has every launch in its trace."""
    import json

    from sleap_nn_tpu_torch.profiling import trace, trace_files

    big = torch.randn(8192, 8192, device=cuda)
    cms = torch.rand(8, 512, 512, 1, device=cuda)
    torch.cuda.synchronize()
    with trace(tmp_path, cuda):
        for _ in range(4):
            big = big @ big / 8192.0  # a few ms each, queued ahead of the kernels
        for _ in range(5):
            nms_scores(cms, 0.2)
    (path,) = trace_files(tmp_path)
    events = json.loads(path.read_text())["traceEvents"]
    launched = [ev for ev in events if ev.get("cat") == "kernel"
                and "nms_scores_kernel" in ev["name"]]
    assert len(launched) == 5


# The card machine's host clock (``time.time_ns()``) against CUPTI's
# device timestamps, as Kineto places them: in 90 trials on an H100 a host
# span around a launch and its synchronize() began 145 us or more before
# the kernel and ended 8.6 us or more after it, so no skew showed; a
# span may miss the kernel by this many us.
SPAN_SKEW_US = 50.0


def test_spans_time_the_card_under_a_device_only_profiler(cuda):
    """Under a profiler that records the device alone the port's spans are
    on: a ``device`` span's card time is a CUDA-event timing of its block,
    and a host span around a launch and its ``synchronize()`` encloses the
    kernel's device interval (to the clocks' skew)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sleap_nn_tpu_torch import profiling

    a = torch.randn(4096, 4096, device=cuda)
    torch.mm(a, a)
    torch.cuda.synchronize()
    profiling.clear()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert profiling.recording()
        for _ in range(3):  # the stream busy, so that neither timing counts a launch
            torch.mm(a, a)
        with profiling.span("timed", device=cuda):
            start.record()
            torch.mm(a, a)
            end.record()
        torch.cuda.synchronize()
        with profiling.span("host"):
            torch.mm(a, a)
            torch.cuda.synchronize()
    spans = {s.name: s for s in profiling.spans()}
    profiling.clear()
    assert spans["timed"].device_ms == pytest.approx(start.elapsed_time(end), rel=0.02, abs=0.02)
    assert spans["host"].device_ms is None
    t0 = prof.profiler.kineto_results.trace_start_ns()
    kernels = sorted((ev for ev in prof.events() if ev.device_type == DeviceType.CUDA),
                     key=lambda ev: ev.time_range.start)
    assert len(kernels) >= 2
    last = kernels[-1].time_range
    host = spans["host"]
    assert (host.start_ns - t0) / 1e3 - SPAN_SKEW_US <= last.start
    assert last.end <= (host.end_ns - t0) / 1e3 + SPAN_SKEW_US

