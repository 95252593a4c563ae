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
bit for bit, the maps the plain version's to 1e-6.
"""

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
     (2, 9, 3, 96, 64, 4, 4.0)],
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
