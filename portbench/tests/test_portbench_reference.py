"""The plain reference against itself, on its invariants, at tiny sizes."""

import math

import pytest
import torch

from portbench.reference import peaks, topdown, train, unet
from portbench.tests.test_portbench_counts import small_unet_state


def gaussian_map(h, w, centres, sigma=1.5):
    yy, xx = torch.meshgrid(torch.arange(h).float(), torch.arange(w).float(), indexing="ij")
    m = torch.zeros(h, w)
    for cx, cy, a in centres:
        m = torch.maximum(m, a * torch.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sigma ** 2)))
    return m


def test_local_peaks_find_planted_peaks_highest_first():
    m = gaussian_map(20, 24, [(5, 4, 0.9), (17, 12, 0.6), (10, 15, 0.3)])
    xy, vals, ch, valid = peaks.top_local_peaks(m[None, :, :, None], 0.2, 4)
    assert valid.tolist() == [[True, True, True, False]]
    assert xy[0, :3].tolist() == [[5, 4], [17, 12], [10, 15]]
    assert vals[0, :3].tolist() == pytest.approx([0.9, 0.6, 0.3])


def test_refinement_of_a_symmetric_peak_stays_and_follows_a_shift():
    m = gaussian_map(16, 16, [(8, 8, 1.0)])
    assert peaks.refine(m[None], torch.tensor([[8, 8]])).tolist() == [[8.0, 8.0]]
    shifted = gaussian_map(16, 16, [(8.3, 7.8, 1.0)])
    got = peaks.refine(shifted[None], torch.tensor([[8, 8]]))[0]
    assert got[0] > 8.0 and got[1] < 8.0
    on_one = peaks.refine(shifted[None], torch.tensor([[8, 8]]), rows=torch.tensor([0]))
    assert on_one[0].tolist() == got.tolist()


def test_nearest_cell_recovers_the_refined_cell():
    m = gaussian_map(16, 16, [(6.3, 9.2, 1.0), (12, 3, 0.8)])
    cells = torch.tensor([[6, 9], [12, 3]])
    p = peaks.refine(torch.stack([m, m]), cells)
    got, dist = peaks.nearest_cell(torch.stack([m, m]), p)
    assert got.tolist() == cells.tolist() and float(dist.max()) < 1e-6


def test_unet_rows_are_independent():
    torch.manual_seed(0)
    s = {k: torch.randn(v.shape) * 0.3 for k, v in small_unet_state().items()}
    x = torch.rand(3, 16, 16, 1)
    both = unet.forward(s, x, {"CentroidConfmapsHead": 2})["CentroidConfmapsHead"]
    one = unet.forward(s, x[1:2], {"CentroidConfmapsHead": 2})["CentroidConfmapsHead"]
    assert both.shape == (3, 8, 8, 1)
    assert torch.allclose(both[1:2], one, atol=1e-6)


def test_crops_sit_at_the_centroid_with_zeros_outside():
    x = torch.arange(100.0).reshape(1, 10, 10, 1)
    corners = topdown.crop_corners(torch.tensor([[4.4, 5.6], [0.0, 0.0]]), 4)
    assert corners.tolist() == [[2, 4], [-2, -2]]
    crops = topdown.gather_crops(x.expand(2, 10, 10, 1), torch.tensor([0, 1]), corners, 4)
    assert crops[0, 0, 0, 0] == x[0, 4, 2, 0] and crops[1, :2].abs().sum() == 0
    assert crops[1, 2, 2, 0] == x[0, 0, 0, 0]


def test_confmaps_peak_at_the_points_and_pafs_follow_the_edges():
    pts = torch.tensor([[[[8.0, 8.0], [24.0, 8.0]], [[float("nan")] * 2] * 2]])  # (1, 2, 2, 2)
    cm = train.confmaps(pts, (32, 32), sigma=2.0, stride=2)
    assert cm.shape == (1, 16, 16, 2) and cm[0, 4, 4, 0] == 1.0 and cm[0, 4, 12, 1] == 1.0
    pafs = train.pafs(pts, (32, 32), [(0, 1)], sigma=2.0, stride=4)
    assert pafs.shape == (1, 8, 8, 2)
    assert pafs[0, 2, 4].tolist() == pytest.approx([1.0, 0.0])


def test_an_identity_affine_changes_nothing():
    gen = torch.Generator().manual_seed(3)
    geo = dict(rotation_min=-15.0, rotation_max=15.0, rotation_p=0.0, scale_min=0.9,
               scale_max=1.1, scale_p=0.0, translate_width=0.0, translate_height=0.0,
               translate_p=None, affine_p=0.0)
    m = train.draw_affine(gen, 2, 8, 8, geo)
    assert torch.equal(m, torch.eye(3).expand(2, 3, 3))
    x = torch.rand(2, 8, 8, 1)
    assert torch.allclose(train.warp(x, m), x)
    p = torch.rand(2, 3, 2) * 8
    assert torch.allclose(train.map_points(p, m), p)


def test_a_rotation_maps_points_with_the_image():
    gen = torch.Generator().manual_seed(5)
    geo = dict(rotation_min=90.0, rotation_max=90.0, rotation_p=1.0, scale_min=1.0,
               scale_max=1.0, scale_p=0.0, translate_width=0.0, translate_height=0.0,
               translate_p=None, affine_p=0.0)
    m = train.draw_affine(gen, 1, 9, 9, geo)
    x = torch.zeros(1, 9, 9, 1)
    x[0, 2, 6, 0] = 1.0  # (x, y) = (6, 2)
    y = train.warp(x, m)
    q = train.map_points(torch.tensor([[[6.0, 2.0]]]), m)[0, 0]
    assert y[0, int(round(float(q[1]))), int(round(float(q[0]))), 0] == pytest.approx(1.0, abs=1e-5)


def test_adams_first_step_moves_each_weight_by_the_rate():
    torch.manual_seed(1)
    s = {k.replace("CentroidConfmapsHead", train.CM_HEAD): torch.randn(v.shape) * 0.3
         for k, v in small_unet_state().items()}
    s[f"head_layers.0.{train.PAF_HEAD}.0.weight"] = torch.randn(2, 8, 1, 1) * 0.3
    s[f"head_layers.0.{train.PAF_HEAD}.0.bias"] = torch.zeros(2)
    cfg = {"bottomup": {"confmaps": {"sigma": 2.0, "output_stride": 2},
                        "pafs": {"sigma": 4.0, "output_stride": 2}}, "edges": [[0, 1]]}
    batch = {"frames": torch.randint(0, 255, (2, 16, 16, 1), dtype=torch.uint8),
             "points": torch.rand(2, 1, 2, 2) * 10 + 3, "mask": torch.ones(2)}
    geo = dict(rotation_min=0.0, rotation_max=0.0, rotation_p=0.0, scale_min=1.0, scale_max=1.0,
               scale_p=0.0, translate_width=0.0, translate_height=0.0, translate_p=None,
               affine_p=0.0)
    losses, first, after = train.steps(cfg, s, [batch], 0, geo, 1e-3)
    assert math.isfinite(losses[0])
    for k, g in first.items():
        moved = (after[k] - s[k]).abs()
        big = g.abs() > 1e-6
        assert torch.allclose(moved[big], torch.full_like(moved[big], 1e-3), rtol=1e-3)
    out, _ = train.judge({"losses": losses, "first": first, "after": after}, losses, first, after, s)
    assert out["loss_gap"] == out["grad_gap"] == out["change_gap"] == 0.0
