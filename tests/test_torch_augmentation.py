"""Port parity: augmentation (``data/augmentation.py``) against the JAX package.

The two packages draw different random numbers by design (``jax.random``
keys against a ``torch.Generator``). So the apply halves are fed the very
values that the JAX function draws from its key (recomputed here with the
JAX function's own key splits), or numpy-made matrices, and must give the
JAX function's output: points and pixel sums to 1e-5 absolute (bilinear
taps summed in another order; images in [0, 1]), masks and flags exactly.
The sample halves are checked against their stated ranges and
probabilities on 10,000 draws (4 standard errors of a binomial).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.data import augmentation as ja
from sleap_nn_tpu_torch.data import augmentation as pa
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

ATOL = 1e-5


def _img(b=3, h=20, w=28, c=1, seed=0):
    return np.random.default_rng(seed).random((b, h, w, c), dtype=np.float32)


def _inst(b=3, n_inst=2, n_nodes=4, h=20, w=28, seed=1):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(0, w, (b, n_inst, n_nodes)),
                    rng.uniform(0, h, (b, n_inst, n_nodes))], -1).astype(np.float32)
    pts[0, 0, 1] = np.nan
    pts[1, 1] = np.nan
    return pts


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# --- apply halves against the JAX functions -------------------------------


def _jax_affine_values(key, b, h, w, rotation_min=-15.0, rotation_max=15.0, rotation_p=None,
                       scale_min=0.9, scale_max=1.1, scale_p=None, translate_width=0.0,
                       translate_height=0.0, translate_p=None, affine_p=0.0):
    """The values ``_affine_matrices`` draws from ``key``, as the port's sample half returns them."""
    k_rot, k_scale, k_tx, k_ty, k_prot, k_pscale, k_ptrans, k_paff = jax.random.split(key, 8)
    u = jax.random.uniform
    angle = u(k_rot, (b,), minval=rotation_min, maxval=rotation_max) * (jnp.pi / 180.0)
    scale = u(k_scale, (b,), minval=scale_min, maxval=scale_max)
    tx = u(k_tx, (b,), minval=-translate_width, maxval=translate_width) * w
    ty = u(k_ty, (b,), minval=-translate_height, maxval=translate_height) * h
    bundled = u(k_paff, (b,)) < affine_p
    rot_on = u(k_prot, (b,)) < rotation_p if rotation_p is not None else bundled
    scale_on = u(k_pscale, (b,)) < scale_p if scale_p is not None else bundled
    trans_on = u(k_ptrans, (b,)) < translate_p if translate_p is not None else bundled
    return {"angle": _t(jnp.where(rot_on, angle, 0.0)), "scale": _t(jnp.where(scale_on, scale, 1.0)),
            "tx": _t(jnp.where(trans_on, tx, 0.0)), "ty": _t(jnp.where(trans_on, ty, 0.0))}


@pytest.mark.parametrize("kw", [
    dict(rotation_p=1.0, scale_p=1.0),
    dict(rotation_p=0.5, scale_p=None, translate_width=0.2, translate_height=0.1, translate_p=0.7),
    dict(rotation_min=-180.0, rotation_max=180.0, affine_p=0.6, translate_width=0.1)])
def test_affine_matrices_match(kw):
    key = jax.random.PRNGKey(3)
    want = ja._affine_matrices(key, 8, 20, 28, **{**dict(
        rotation_min=-15.0, rotation_max=15.0, rotation_p=None, scale_min=0.9, scale_max=1.1,
        scale_p=None, translate_width=0.0, translate_height=0.0, translate_p=None,
        affine_p=0.0), **kw})
    got = pa.affine_matrices(**_jax_affine_values(key, 8, 20, 28, **kw), height=20, width=28)
    _close(got, want)


def _numpy_mats(b, h, w, seed):
    """Random rotations (up to 40 degrees), scales and shifts about the centre."""
    rng = np.random.default_rng(seed)
    ang = np.deg2rad(rng.uniform(-40, 40, b))
    s = rng.uniform(0.7, 1.3, b)
    t = rng.uniform(-4, 4, (b, 2))
    cx, cy = (w - 1) / 2, (h - 1) / 2
    mats = np.zeros((b, 3, 3), np.float32)
    mats[:, 0, 0], mats[:, 0, 1] = s * np.cos(ang), -s * np.sin(ang)
    mats[:, 1, 0], mats[:, 1, 1] = s * np.sin(ang), s * np.cos(ang)
    mats[:, 0, 2] = cx + t[:, 0] - (mats[:, 0, 0] * cx + mats[:, 0, 1] * cy)
    mats[:, 1, 2] = cy + t[:, 1] - (mats[:, 1, 0] * cx + mats[:, 1, 1] * cy)
    mats[:, 2, 2] = 1
    return mats


@pytest.mark.parametrize("seed", [0, 1])
def test_transform_points_match(seed):
    mats, pts = _numpy_mats(3, 20, 28, seed), _inst(seed=seed)
    _close(pa.transform_points(_t(pts), _t(mats)), ja.transform_points(pts, mats))


@pytest.mark.parametrize("c,h,w,seed", [(1, 20, 28, 0), (3, 17, 17, 1), (2, 32, 12, 2)])
def test_warp_image_matches_including_borders(c, h, w, seed):
    img, mats = _img(4, h, w, c, seed), _numpy_mats(4, h, w, seed)
    mats[0] = np.eye(3)  # identity
    mats[1, :2, 2] += [0.5, -0.25]  # sub-pixel shift: edges blend toward black
    want = np.asarray(ja.warp_image(jnp.asarray(img), jnp.asarray(mats)))
    got = pa.warp_image(_t(img), _t(mats))
    _close(got, want)
    np.testing.assert_allclose(got[0].numpy(), img[0], rtol=0, atol=ATOL)
    assert (want[2:, 0] == 0).any() or (want[2:, :, 0] == 0).any()  # black border corners


@pytest.mark.parametrize("flip_p,symmetric", [(0.5, [(0, 3)]), (1.0, None), (0.0, [(1, 2)])])
def test_flip_matches(flip_p, symmetric):
    key = jax.random.PRNGKey(5)
    img, pts = _img(6), _inst(6)
    want_img, want_pts, _ = ja.apply_flip_augmentation(
        key, jnp.asarray(img), jnp.asarray(pts), symmetric_inds=symmetric, flip_p=flip_p)
    do = _t(jax.random.uniform(key, (6,)) < flip_p)
    got_img, got_pts = pa.apply_flip(_t(img), _t(pts), do, symmetric)
    _close(got_img, want_img, atol=0)
    _close(got_pts, want_pts, atol=0)


def test_random_erase_matches():
    key = jax.random.PRNGKey(11)
    b, h, w = 6, 20, 28
    img = _img(b, h, w)
    cfg = (0.05, 0.3, 0.5, 2.0, 0.7)
    want = ja.apply_random_erase(key, jnp.asarray(img), *cfg)
    k_area, k_ratio, k_x, k_y, k_p = jax.random.split(key, 5)
    area = jax.random.uniform(k_area, (b,), minval=cfg[0], maxval=cfg[1]) * h * w
    ratio = jax.random.uniform(k_ratio, (b,), minval=cfg[2], maxval=cfg[3])
    eh, ew = jnp.sqrt(area * ratio), jnp.sqrt(area / ratio)
    boxes = {"eh": _t(eh), "ew": _t(ew),
             "y0": _t(jax.random.uniform(k_y, (b,), maxval=1.0) * (h - eh)),
             "x0": _t(jax.random.uniform(k_x, (b,), maxval=1.0) * (w - ew)),
             "on": _t(jax.random.uniform(k_p, (b,)) < cfg[4])}
    got = pa.apply_random_erase(_t(img), boxes)
    _close(got, want, atol=0)
    assert (got == 0).any()


def test_mixup_matches():
    key = jax.random.PRNGKey(2)
    img, pts = _img(5), _inst(5)
    want, _ = ja.apply_geometric_augmentation(key, jnp.asarray(img), jnp.asarray(pts),
                                              mixup_p=0.6, mixup_lambda_min=0.1,
                                              mixup_lambda_max=0.4)
    k_mix = jax.random.split(key, 4)[3]
    lam = jax.random.uniform(k_mix, (5, 1, 1, 1), minval=0.1, maxval=0.4)
    on = jax.random.uniform(jax.random.fold_in(k_mix, 1), (5, 1, 1, 1)) < 0.6
    _close(pa.apply_mixup(_t(img), _t(lam * on)), want)


def test_geometric_chain_matches():
    """Flip, affine, erase and mixup under one key, fed to the port's apply halves."""
    key = jax.random.PRNGKey(9)
    b, h, w = 6, 20, 28
    img, pts = _img(b, h, w), _inst(b, h=h, w=w)
    kw = dict(rotation_p=1.0, scale_p=1.0, translate_width=0.1, translate_p=0.5,
              erase_p=0.5, erase_scale_min=0.02, erase_scale_max=0.1, mixup_p=0.5, flip_p=0.5)
    want_img, want_pts = ja.apply_geometric_augmentation(
        key, jnp.asarray(img), jnp.asarray(pts), symmetric_inds=[(0, 1)], **kw)
    k_flip, k_aff, k_erase, k_mix = jax.random.split(key, 4)
    g_img, g_pts = pa.apply_flip(_t(img), _t(pts), _t(jax.random.uniform(k_flip, (b,)) < 0.5),
                                 [(0, 1)])
    mats = pa.affine_matrices(**_jax_affine_values(
        k_aff, b, h, w, rotation_p=1.0, scale_p=1.0, translate_width=0.1, translate_p=0.5),
        height=h, width=w)
    g_img, g_pts = pa.warp_image(g_img, mats), pa.transform_points(g_pts, mats)
    k_area, k_ratio, k_x, k_y, k_p = jax.random.split(k_erase, 5)
    area = jax.random.uniform(k_area, (b,), minval=0.02, maxval=0.1) * h * w
    eh = ew = jnp.sqrt(area)
    g_img = pa.apply_random_erase(g_img, {
        "eh": _t(eh), "ew": _t(ew), "on": _t(jax.random.uniform(k_p, (b,)) < 0.5),
        "y0": _t(jax.random.uniform(k_y, (b,), maxval=1.0) * (h - eh)),
        "x0": _t(jax.random.uniform(k_x, (b,), maxval=1.0) * (w - ew))})
    lam = jax.random.uniform(k_mix, (b, 1, 1, 1), minval=0.01, maxval=0.05)
    on = jax.random.uniform(jax.random.fold_in(k_mix, 1), (b, 1, 1, 1)) < 0.5
    g_img = pa.apply_mixup(g_img, _t(lam * on))
    _close(g_img, want_img)
    _close(g_pts, want_pts)


def test_intensity_matches():
    key = jax.random.PRNGKey(4)
    img = _img(6, c=3)
    kw = dict(uniform_noise_p=0.5, gaussian_noise_p=0.5, contrast_p=0.5, brightness_p=0.5,
              gaussian_noise_mean=0.01, gaussian_noise_std=0.05, uniform_noise_max=0.1)
    want = ja.apply_intensity_augmentation(key, jnp.asarray(img), **kw)
    keys = jax.random.split(key, 8)
    u = jax.random.uniform
    per = (6, 1, 1, 1)
    values = {
        "uniform_noise": _t(u(keys[0], img.shape, minval=0.0, maxval=0.1)),
        "uniform_on": _t((u(keys[1], per) < 0.5).astype(jnp.float32)),
        "gaussian_noise": _t(0.01 + 0.05 * jax.random.normal(keys[2], img.shape)),
        "gaussian_on": _t((u(keys[3], per) < 0.5).astype(jnp.float32)),
        "contrast_factor": _t(u(keys[4], per, minval=0.9, maxval=1.1)),
        "contrast_on": _t(u(keys[5], per) < 0.5),
        "brightness_factor": _t(u(keys[6], per, minval=0.9, maxval=1.1)),
        "brightness_on": _t(u(keys[7], per) < 0.5),
    }
    _close(pa.apply_intensity(_t(img), values), want)


# --- sample halves: ranges and probabilities ------------------------------

N = 10_000


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _rate_ok(flags, p):
    return abs(flags.float().mean().item() - p) <= 4 * np.sqrt(p * (1 - p) / N) + 1e-9


def test_sample_affine_ranges_and_probabilities():
    v = pa.sample_affine(_gen(), N, 100, 200, rotation_min=-20, rotation_max=10, rotation_p=0.3,
                         scale_min=0.8, scale_max=1.2, scale_p=None, translate_width=0.1,
                         translate_height=0.2, translate_p=0.9, affine_p=0.6)
    rot_on, scale_on, trans_on = v["angle"] != 0, v["scale"] != 1, v["tx"] != 0
    assert _rate_ok(rot_on, 0.3) and _rate_ok(scale_on, 0.6) and _rate_ok(trans_on, 0.9)
    deg = torch.rad2deg(v["angle"][rot_on])
    assert deg.min() >= -20 - 1e-4 and deg.max() <= 10 + 1e-4 and deg.mean().abs() > 2
    s = v["scale"][scale_on]
    assert s.min() >= 0.8 and s.max() <= 1.2
    assert v["tx"].abs().max() <= 20 and v["ty"].abs().max() <= 20
    assert (v["ty"][trans_on].abs() > 10).any()  # reaches past the width's range
    # Defaults: rotation and scale follow the bundled affine_p.
    d = pa.sample_affine(_gen(1), N, 10, 10, affine_p=0.25)
    assert torch.equal(d["angle"] != 0, d["scale"] != 1) and _rate_ok(d["angle"] != 0, 0.25)


def test_sample_flip_erase_mixup():
    assert _rate_ok(pa.sample_flip(_gen(), N, 0.35), 0.35)
    boxes = pa.sample_random_erase(_gen(2), N, 100, 60, 0.01, 0.04, 0.5, 2.0, 0.2)
    area = boxes["eh"] * boxes["ew"]
    assert area.min() >= 0.01 * 6000 - 1e-2 and area.max() <= 0.04 * 6000 + 1e-2
    ratio = boxes["eh"] / boxes["ew"]
    assert ratio.min() >= 0.5 - 1e-5 and ratio.max() <= 2.0 + 1e-5
    assert (boxes["y0"] >= 0).all() and (boxes["y0"] + boxes["eh"] <= 100 + 1e-4).all()
    assert (boxes["x0"] >= 0).all() and (boxes["x0"] + boxes["ew"] <= 60 + 1e-4).all()
    assert _rate_ok(boxes["on"], 0.2)
    lam = pa.sample_mixup(_gen(3), N, 0.1, 0.3, 0.4).flatten()
    assert _rate_ok(lam > 0, 0.4) and lam[lam > 0].min() >= 0.1 and lam.max() <= 0.3


def test_sample_intensity():
    v = pa.sample_intensity(_gen(4), (N, 2, 3, 1), uniform_noise_min=0.01,
                            uniform_noise_max=0.05, uniform_noise_p=0.3, gaussian_noise_mean=0.1,
                            gaussian_noise_std=0.2, gaussian_noise_p=0.6, contrast_p=0.1,
                            brightness_min=0.5, brightness_max=0.7, brightness_p=0.9)
    un = v["uniform_noise"]
    assert un.min() >= 0.01 and un.max() <= 0.05 and abs(un.mean().item() - 0.03) < 1e-3
    gn = v["gaussian_noise"]
    assert abs(gn.mean().item() - 0.1) < 0.01 and abs(gn.std().item() - 0.2) < 0.01
    assert _rate_ok(v["uniform_on"] > 0, 0.3) and _rate_ok(v["gaussian_on"] > 0, 0.6)
    assert _rate_ok(v["contrast_on"], 0.1) and _rate_ok(v["brightness_on"], 0.9)
    bf = v["brightness_factor"]
    assert bf.min() >= 0.5 and bf.max() <= 0.7
    assert set(pa.sample_intensity(_gen(), (2, 2, 2, 1), contrast_p=0.5)) == {
        "contrast_factor", "contrast_on"}


def test_geometric_chain_keeps_shapes_and_nan():
    img, pts = _t(_img(4)), _t(_inst(4))
    out_img, out_pts = pa.apply_geometric_augmentation(
        _gen(), img, pts, rotation_p=1.0, scale_p=1.0, flip_p=0.5, erase_p=0.5, mixup_p=0.5,
        symmetric_inds=[(0, 1)])
    assert out_img.shape == img.shape and out_pts.shape == pts.shape
    assert torch.isnan(out_pts[1, 1]).all()
    assert not torch.equal(out_img, img)
    again = pa.apply_geometric_augmentation(_gen(), img, pts, rotation_p=1.0, scale_p=1.0,
                                            flip_p=0.5, erase_p=0.5, mixup_p=0.5,
                                            symmetric_inds=[(0, 1)])
    assert torch.equal(again[0], out_img)  # one seed, one draw


# --- masks: nearest warp, flip and the chain ------------------------------

MASK_DTYPES = {"uint8": (np.uint8, torch.uint8), "bool": (np.bool_, torch.bool),
               "float32": (np.float32, torch.float32)}
# The JAX warp jitted once per shape and dtype (eager map_coordinates
# compiles op by op); the same function.
_ja_warp = jax.jit(ja.warp_image, static_argnames="order")


def _masks(b, h, w, m, dtype, seed=0):
    """``(B, H, W, M)`` masks: random 0/1 (random [0, 1) values for
    float32), every border pixel on so that the border's rounding shows."""
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        out = rng.random((b, h, w, m), dtype=np.float32)
    else:
        out = (rng.random((b, h, w, m)) < 0.5).astype(MASK_DTYPES[dtype][0])
    out[:, [0, -1]] = 1
    out[:, :, [0, -1]] = 1
    return out


def _shift_scale_rot(h, w):
    """Matrices whose source coordinates are exact in f32: the identity,
    integer and half-pixel shifts (ties at every pixel, rounding to -1 and
    to W at the borders), scale 2 (ties at every other pixel) and 0.5
    about the centre, and rotations by +-90 degrees about the centre."""
    cx, cy = (w - 1) / 2, (h - 1) / 2
    mats = np.tile(np.eye(3, dtype=np.float32), (8, 1, 1))
    mats[1, :2, 2] = [3, -2]
    mats[2, :2, 2] = [0.5, 0]
    mats[3, :2, 2] = [-0.5, 0.5]
    for i, s in ((4, 2.0), (5, 0.5)):
        mats[i, :2, :2] = np.eye(2) * s
        mats[i, :2, 2] = [cx - s * cx, cy - s * cy]
    for i, sgn in ((6, 1), (7, -1)):  # x' = cx - sgn (y - cy), y' = cy + sgn (x - cx)
        mats[i, :2, :2] = [[0, -sgn], [sgn, 0]]
        mats[i, :2, 2] = [cx + sgn * cy, cy - sgn * cx]
    return mats


@pytest.mark.parametrize("dtype", sorted(MASK_DTYPES))
def test_warp_nearest_matches_jax_exactly(dtype):
    h, w = 15, 21  # odd: W - 0.5 rounds to W - 1 under ties-to-even, to W away from zero
    mats, masks = _shift_scale_rot(h, w), _masks(8, h, w, 3, dtype)
    want = np.asarray(_ja_warp(jnp.asarray(masks), jnp.asarray(mats), order=0))
    got = pa.warp_image(_t(masks), _t(mats), order=0)
    assert got.dtype == MASK_DTYPES[dtype][1] and want.dtype == masks.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0].numpy(), masks[0])  # identity
    np.testing.assert_array_equal(got[1, :-2, 3:].numpy(), masks[1, 2:, :-3])  # (3, -2)
    # +0.5: column 0's source -0.5 rounds to -1 (outside); -0.5: column
    # W - 1's source W - 0.5 rounds to W (outside). Ties to even would keep both.
    assert not got[2, :, 0].any() and not got[3, :, -1].any()
    np.testing.assert_array_equal(got[2, :, 1:].numpy(), masks[2, :, 1:])  # x - 0.5 -> x
    assert got[6].any() and got[7].any()


def test_half_pixel_shift_rounds_half_away_from_zero():
    """Columns 2-4 moved +0.5 px: JAX keeps columns 2-4, where a
    ties-to-even rounding (``grid_sample``'s nearest) gives 2-5."""
    mask = np.zeros((1, 8, 8, 1), np.uint8)
    mask[0, :, 2:5] = 1
    mats = np.eye(3, dtype=np.float32)[None].copy()
    mats[0, 0, 2] = 0.5
    want = np.asarray(_ja_warp(jnp.asarray(mask), jnp.asarray(mats), order=0))
    got = pa.warp_image(_t(mask), _t(mats), order=0).numpy()
    np.testing.assert_array_equal(want[0, 0, :, 0], [0, 0, 1, 1, 1, 0, 0, 0])
    np.testing.assert_array_equal(got, want)


# Random matrices: pixels whose f64 source coordinate lies within TIE_TOL
# of a half-integer may round apart (f32 coordinates an ulp apart); at
# most MAX_TIES such pixels a case, and masks equal everywhere else.
TIE_TOL, MAX_TIES = 1e-5, 4


@pytest.mark.parametrize("h,w,seed", [(32, 32, 0), (24, 30, 1), (17, 29, 2)])
def test_warp_nearest_random_matrices_differ_only_at_ties(h, w, seed):
    mats, masks = _numpy_mats(6, h, w, seed), _masks(6, h, w, 2, "uint8", seed)
    want = np.asarray(_ja_warp(jnp.asarray(masks), jnp.asarray(mats), order=0))
    got = pa.warp_image(_t(masks), _t(mats), order=0).numpy()
    inv = np.linalg.inv(mats.astype(np.float64))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    ties = np.zeros((6, h, w), bool)
    for r in range(2):
        src = inv[:, r, 0, None, None] * xx + inv[:, r, 1, None, None] * yy + inv[:, r, 2, None,
                                                                                  None]
        ties |= np.abs(src - np.floor(src) - 0.5) < TIE_TOL
    assert ties.sum() <= MAX_TIES
    differ = (got != want).any(-1)
    assert not (differ & ~ties).any()
    assert (want != masks).any() and want.any()  # the warp moved something, kept something


def test_flip_with_masks_matches_jax(monkeypatch):
    key, b = jax.random.PRNGKey(5), 6
    img, pts, masks = _img(b), _inst(b), _masks(b, 20, 28, 2, "uint8")
    want = ja.apply_flip_augmentation(key, jnp.asarray(img), jnp.asarray(pts),
                                      symmetric_inds=[(0, 3)], flip_p=0.5,
                                      masks=jnp.asarray(masks))
    do = _t(jax.random.uniform(key, (b,)) < 0.5)
    assert 0 < int(do.sum()) < b
    got = pa.apply_flip(_t(img), _t(pts), do, [(0, 3)], masks=_t(masks))
    monkeypatch.setattr(pa, "sample_flip", lambda g, batch, p: do[:batch])
    chained = pa.apply_flip_augmentation(_gen(), _t(img), _t(pts), [(0, 3)], 0.5, _t(masks))
    for out in (got, chained):
        assert len(out) == 3 and out[2].dtype == torch.uint8
        for g, w_ in zip(out, want):
            _close(g, w_, atol=0)
    assert len(pa.apply_flip(_t(img), _t(pts), do, [(0, 3)])) == 2
    no_masks = pa.apply_flip_augmentation(_gen(), _t(img), _t(pts), [(0, 3)], 0.5)
    assert no_masks[2] is None and torch.equal(no_masks[0], chained[0])


def _jax_drawn(monkeypatch, key, b, h, w, kw):
    """Patch the port's samplers to return what JAX's chain draws from ``key``."""
    k_flip, k_aff, k_erase, k_mix = jax.random.split(key, 4)
    aff_kw = {k: kw[k] for k in ("rotation_p", "scale_p", "translate_width", "translate_p")
              if k in kw}
    values = {"flip": _t(jax.random.uniform(k_flip, (b,)) < kw.get("flip_p", 0.0)),
              "affine": _jax_affine_values(k_aff, b, h, w, **aff_kw)}
    k_area, k_ratio, k_x, k_y, k_p = jax.random.split(k_erase, 5)
    area = jax.random.uniform(k_area, (b,), minval=kw["erase_scale_min"],
                              maxval=kw["erase_scale_max"]) * h * w
    eh = ew = jnp.sqrt(area)
    values["erase"] = {"eh": _t(eh), "ew": _t(ew),
                       "on": _t(jax.random.uniform(k_p, (b,)) < kw["erase_p"]),
                       "y0": _t(jax.random.uniform(k_y, (b,), maxval=1.0) * (h - eh)),
                       "x0": _t(jax.random.uniform(k_x, (b,), maxval=1.0) * (w - ew))}
    lam = jax.random.uniform(k_mix, (b, 1, 1, 1), minval=0.01, maxval=0.05)
    values["mixup"] = _t(lam * (jax.random.uniform(jax.random.fold_in(k_mix, 1),
                                                   (b, 1, 1, 1)) < kw["mixup_p"]))
    monkeypatch.setattr(pa, "sample_flip", lambda g, batch, p: values["flip"])
    monkeypatch.setattr(pa, "sample_affine", lambda g, batch, *a: values["affine"])
    monkeypatch.setattr(pa, "sample_random_erase", lambda g, batch, *a: values["erase"])
    monkeypatch.setattr(pa, "sample_mixup", lambda g, batch, *a: values["mixup"])


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_geometric_chain_with_masks_matches_jax(monkeypatch, dtype):
    """The port's chain on JAX's drawn values: images and points to ATOL,
    masks exactly, in their dtype; erase and mixup leave the masks alone."""
    key, b, h, w = jax.random.PRNGKey(9), 6, 20, 28
    img, pts = _img(b, h, w), _inst(b, h=h, w=w)
    masks = (_masks(b, h, w, 3, "uint8") if dtype == "uint8"
             else (_masks(b, h, w, 3, "float32") > 0.5).astype(np.float32))
    kw = dict(rotation_p=1.0, scale_p=1.0, translate_width=0.1, translate_p=0.5, erase_p=0.5,
              erase_scale_min=0.02, erase_scale_max=0.1, mixup_p=0.5, flip_p=0.5)
    want = ja.apply_geometric_augmentation(key, jnp.asarray(img), jnp.asarray(pts),
                                           symmetric_inds=[(0, 1)], masks=jnp.asarray(masks),
                                           **kw)
    _jax_drawn(monkeypatch, key, b, h, w, kw)
    got = pa.apply_geometric_augmentation(_gen(), _t(img), _t(pts), symmetric_inds=[(0, 1)],
                                          masks=_t(masks), **kw)
    assert len(got) == 3 and got[2].dtype == MASK_DTYPES[dtype][1]
    _close(got[0], want[0])
    _close(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert set(np.unique(got[2].numpy())) == {0, 1}
    plain = pa.apply_geometric_augmentation(_gen(), _t(img), _t(pts), symmetric_inds=[(0, 1)],
                                            **kw)
    assert len(plain) == 2  # masks=None: the 2-tuple, the same image and points bit for bit
    assert torch.equal(plain[0], got[0]) and torch.equal(plain[1].nan_to_num(),
                                                         got[1].nan_to_num())


def test_flip_cotransforms_masks():
    """JAX's ``test_flip_cotransforms_masks`` on the port."""
    img = torch.zeros(1, 32, 32, 1)
    img[0, 12, 8] = 1.0
    mask = torch.zeros(1, 32, 32, 1)
    mask[0, :, :16] = 1.0
    _, _, out_mask = pa.apply_flip_augmentation(_gen(), img, torch.zeros(1, 1, 2), flip_p=1.0,
                                                masks=mask)
    assert float(out_mask[0, 0, 0, 0]) == 0.0
    assert float(out_mask[0, 0, 31, 0]) == 1.0


def test_masks_follow_affine_warp():
    """JAX's ``test_masks_follow_affine_warp`` on the port."""
    img = torch.zeros(1, 32, 32, 1)
    img[0, 12, 8] = 1.0
    mask = torch.zeros(1, 32, 32, 1)
    mask[0, 10:20, 10:20] = 1.0
    out = pa.apply_geometric_augmentation(_gen(), img, torch.zeros(1, 1, 2), rotation_min=90.0,
                                          rotation_max=90.0, affine_p=1.0, masks=mask)
    assert len(out) == 3
    m = out[2].numpy()
    assert set(np.unique(m)) <= {0.0, 1.0}  # stays binary (nearest warp)
    assert 50 <= m.sum() <= 150  # area roughly preserved under rotation


def test_rows_of_a_global_batch_keep_their_masks():
    """A rank's rows of the global batch, masks included, are the single
    process's rows."""
    b = 6
    img, pts, masks = _t(_img(b)), _t(_inst(b)), _t(_masks(b, 20, 28, 2, "uint8"))
    kw = dict(rotation_p=1.0, scale_p=0.5, translate_width=0.1, translate_p=0.5, flip_p=0.5,
              erase_p=0.5, symmetric_inds=[(0, 1)])
    whole = pa.apply_geometric_augmentation(_gen(7), img, pts, masks=masks, **kw)
    for rows in (torch.tensor([0, 1, 2]), torch.tensor([3, 5])):
        part = pa.apply_geometric_augmentation(_gen(7), img[rows], pts[rows], masks=masks[rows],
                                               rows=rows, global_batch=b, **kw)
        for p, w_ in zip(part, whole):
            assert torch.equal(p.nan_to_num(), w_[rows].nan_to_num())
        flipped = pa.apply_flip_augmentation(_gen(7), img[rows], pts[rows], flip_p=0.5,
                                             masks=masks[rows], rows=rows, global_batch=b)
        one = pa.apply_flip_augmentation(_gen(7), img, pts, flip_p=0.5, masks=masks)
        for p, w_ in zip(flipped, one):
            assert torch.equal(p.nan_to_num(), w_[rows].nan_to_num())
