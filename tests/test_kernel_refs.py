"""The stages that once had hand-written kernels, against plain NumPy
references, on randomized and adversarial inputs.

Stages: window extraction and the multi-level window pack, the epipolar
ZMNCC line search, feature alignment, the coarse photometric tracker and the
motion-only pose LM.  Inputs include clipped anchors, empty masks, border
windows, zero-length epipolar lines and hopeless initialisations.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hso_tpu.cameras import PinholeCamera
from hso_tpu.image.pyramid import build_frame_pyramids
from hso_tpu.math import se3np
from hso_tpu.ops.gatherless import bilinear_grid, clip_anchor, extract_windows
from hso_tpu.utils.synthetic import PlaneScene


@pytest.fixture(scope="module")
def scene():
    cam = PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)
    return PlaneScene(cam, z0=2.0, extent=2.5, seed=3)


@pytest.fixture(scope="module")
def pyr(scene):
    return build_frame_pyramids(
        jnp.asarray(scene.render()), n_pyr_levels=3, n_total_levels=5)["pyr"]


def _slices(img, au, av, win):
    img = np.asarray(img)
    return np.stack([img[v:v + win, u:u + win]
                     for u, v in zip(np.asarray(au), np.asarray(av))])


# ---------------------------------------------------------------- windows


@pytest.mark.parametrize("win", [24, 40, 44])
def test_extract_windows_clipped_anchors(pyr, win):
    img = pyr[0]
    h, w = img.shape
    rs = np.random.RandomState(win)
    # centres beyond every border, clipped like every caller clips them
    cu = np.concatenate([[-9.0, w + 9.0, -9.0, w + 9.0], rs.uniform(-5, w + 5, 60)])
    cv = np.concatenate([[-9.0, -9.0, h + 9.0, h + 9.0], rs.uniform(-5, h + 5, 60)])
    au, av = clip_anchor(jnp.asarray(cu), jnp.asarray(cv), win, 0, h, w)
    assert {0, w - win} <= set(np.asarray(au).tolist())
    out = np.asarray(extract_windows(img, au, av, win))
    np.testing.assert_array_equal(out, _slices(img, au, av, win))


def test_extract_windows_image_smaller_than_window():
    img = np.arange(15 * 20, dtype=np.float32).reshape(15, 20)  # 240x320 / 16
    win = 24
    au, av = clip_anchor(jnp.asarray([3.0, 18.0]), jnp.asarray([1.0, 14.0]),
                         win, 7, 15, 20)
    out = np.asarray(extract_windows(jnp.asarray(img), au, av, win))
    # window pixel (r, c) is image pixel (av + r, au + c), zero outside
    pad = np.zeros((win + 15, win + 20), np.float32)
    pad[win:, win:] = img
    ref = np.stack([pad[win + b:2 * win + b, win + a:2 * win + a]
                    for a, b in zip(np.asarray(au), np.asarray(av))])
    np.testing.assert_array_equal(out, ref)
    assert (np.asarray(av) < 0).all() and (np.asarray(au) < 0).all()


def test_pack_level_windows_matches_slicing(pyr):
    from hso_tpu.ops.epipolar import pack_level_windows

    win, n_levels, s = 48, 3, 70
    rs = np.random.RandomState(1)
    level = rs.randint(0, n_levels, s).astype(np.int32)
    cu = np.array([rs.uniform(-5, pyr[l].shape[1] + 5) for l in level], np.float32)
    cv = np.array([rs.uniform(-5, pyr[l].shape[0] + 5) for l in level], np.float32)
    wins, (au, av), (hs, ws) = pack_level_windows(
        pyr, jnp.asarray(level), jnp.asarray(cu), jnp.asarray(cv), win, n_levels)
    for k in range(s):
        h, w = pyr[level[k]].shape
        a_u, a_v = clip_anchor(cu[k:k + 1], cv[k:k + 1], win, 0, h, w)
        assert (int(au[k]), int(av[k])) == (int(a_u[0]), int(a_v[0]))
        assert (int(hs[k]), int(ws[k])) == (h, w)
        np.testing.assert_array_equal(
            np.asarray(wins[k]), _slices(pyr[level[k]], a_u, a_v, win)[0])


# ---------------------------------------------------------------- epipolar


def _line_problem(pyr, s=48, seed=7):
    from hso_tpu.ops.epipolar import pack_level_windows

    rs = np.random.RandomState(seed)
    level = rs.randint(0, 3, s).astype(np.int32)
    center = np.empty((s, 2), np.float32)
    for k in range(s):
        h, w = pyr[level[k]].shape
        center[k] = [rs.uniform(30, w - 30), rs.uniform(30, h - 30)]
    center[0] = [6.0, 6.0]            # window clipped at the image corner
    theta = rs.uniform(0, 2 * np.pi, s)
    d = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    half = rs.uniform(0.0, 16.0, s).astype(np.float32)
    half[1] = 0.0                     # degenerate: zero-length epl
    valid = np.ones(s, bool)
    valid[2] = False
    windows, anchors, img_hw = pack_level_windows(
        pyr, jnp.asarray(level), jnp.asarray(center[:, 0]),
        jnp.asarray(center[:, 1]), 48, 3)
    # templates: the true 8x8 patches at the centres => a real peak
    ref_patch = bilinear_grid(windows, jnp.asarray(center[:, 0]) - 4.0 - anchors[0],
                              jnp.asarray(center[:, 1]) - 4.0 - anchors[1], 8)
    return dict(windows=windows, anchors=anchors, img_hw=img_hw,
                ref_patch=ref_patch,
                px_far=(center - d * half[:, None]).astype(np.float32),
                px_close=(center + d * half[:, None]).astype(np.float32),
                valid=valid)


def _bruteforce_line_scores(p, n_steps=40):
    """Dense ZMNCC map at every integer patch position (float64 loops),
    sampled bilinearly along each epipolar segment with the search's
    cropping and masking rules.  Returns (scores (S, n_steps), segment
    starts (S, 2), unit directions (S, 2))."""
    from hso_tpu.ops.epipolar import MAX_EPL, MIN_EPL

    win = np.asarray(p["windows"], np.float64)
    tpl = np.asarray(p["ref_patch"], np.float64)
    au, av = (np.asarray(a, np.float64) for a in p["anchors"])
    hs, ws = (np.asarray(a, np.float64) for a in p["img_hw"])
    s, e, _ = win.shape
    cw = e - 8 + 1
    out = np.full((s, n_steps), -np.inf)
    starts, dirs = np.zeros((s, 2)), np.zeros((s, 2))
    for i in range(s):
        t = tpl[i] - tpl[i].mean()
        zm = np.empty((cw, cw))
        for y in range(cw):
            for x in range(cw):
                q = win[i, y:y + 8, x:x + 8]
                q = q - q.mean()
                zm[y, x] = (q * t).sum() / (
                    np.sqrt((q * q).sum() * (t * t).sum()) + 1e-12)
        dv = p["px_close"][i].astype(np.float64) - p["px_far"][i]
        ln = np.linalg.norm(dv)
        du = dv / max(ln, 1e-9)
        length = min(ln, MAX_EPL)
        pad = max(0.0, (MIN_EPL - length) * 0.5)
        start = p["px_far"][i] - du * (1.0 + pad)
        starts[i], dirs[i] = start, du
        n_line = min(int(np.ceil(length + 2.0 * (1.0 + pad))), n_steps - 1)
        for k in range(n_line + 1):
            pu, pv = start + du * k
            su, sv = pu - 4.0 - au[i], pv - 4.0 - av[i]
            if not (0 <= su <= cw - 1 and 0 <= sv <= cw - 1
                    and pu - 4 >= 0 and pu + 4 <= ws[i] - 1
                    and pv - 4 >= 0 and pv + 4 <= hs[i] - 1):
                continue
            x0, y0 = min(int(su), cw - 2), min(int(sv), cw - 2)
            fx, fy = su - x0, sv - y0
            out[i, k] = ((1 - fy) * ((1 - fx) * zm[y0, x0] + fx * zm[y0, x0 + 1])
                         + fy * ((1 - fx) * zm[y0 + 1, x0] + fx * zm[y0 + 1, x0 + 1]))
    return out, starts, dirs


def test_zmncc_line_search_matches_bruteforce(pyr):
    from hso_tpu.ops.epipolar import epipolar_zmncc_search

    p = _line_problem(pyr)
    out = epipolar_zmncc_search(
        p["windows"], p["anchors"], p["img_hw"], p["ref_patch"],
        jnp.asarray(p["px_far"]), jnp.asarray(p["px_close"]),
        jnp.asarray(p["valid"]))
    ref, starts, dirs = _bruteforce_line_scores(p)
    best = ref.max(axis=1)
    sb = np.asarray(out["score_best"])
    finite = np.isfinite(best)
    np.testing.assert_array_equal(np.isfinite(sb), finite)
    np.testing.assert_allclose(sb[finite], best[finite], atol=2e-4)
    # the chosen step scores within rounding of the best (near-ties may
    # break either way in f32)
    k = np.rint(np.sum((np.asarray(out["px_best"]) - starts) * dirs,
                       axis=1)).astype(int)
    rows = np.nonzero(finite)[0]
    assert np.all(ref[rows, k[rows]] >= best[rows] - 2e-4)
    assert finite.sum() > 40
    assert np.asarray(out["ok"]).sum() > 30


def test_zmncc_degenerate_and_invalid_seeds(pyr):
    from hso_tpu.ops.epipolar import MIN_EPL, epipolar_zmncc_search

    p = _line_problem(pyr)
    out = epipolar_zmncc_search(
        p["windows"], p["anchors"], p["img_hw"], p["ref_patch"],
        jnp.asarray(p["px_far"]), jnp.asarray(p["px_close"]),
        jnp.asarray(p["valid"]))
    n_line = np.asarray(out["n_line"])
    # a zero-length segment is padded to MIN_EPL plus one sample each side
    assert n_line[1] == int(np.ceil(MIN_EPL + 2.0))
    assert not bool(out["ok"][2])             # invalid seed never matches
    none = epipolar_zmncc_search(
        p["windows"], p["anchors"], p["img_hw"], p["ref_patch"],
        jnp.asarray(p["px_far"]), jnp.asarray(p["px_close"]),
        jnp.zeros_like(jnp.asarray(p["valid"])))
    assert not np.asarray(none["ok"]).any()


# ---------------------------------------------------------------- align


def _align_problem(pyr, s=64, seed=2):
    """Corners and edgelets on mixed pyramid levels, each with a template
    sampled at a known position and an initial guess off by up to 1.2 px
    (edgelets along their direction only).  Adversarial rows: 0 near the
    border, 1 with its patch outside the image, 2 a dead slot, 3 a hopeless
    30 px initialisation."""
    from hso_tpu.ops.epipolar import pack_level_windows

    rs = np.random.RandomState(seed)
    level = rs.randint(0, 3, s).astype(np.int32)
    px_true = np.empty((s, 2), np.float32)
    for k in range(s):
        h, w = pyr[level[k]].shape
        px_true[k] = [rs.uniform(16, w - 16), rs.uniform(16, h - 16)]
    px_true[0] = [8.2, 8.7]
    px_true[1] = [2.0, 2.0]
    is_edge = rs.rand(s) < 0.3
    theta = rs.uniform(0, 2 * np.pi, s)
    direction = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    valid = np.ones(s, bool)
    valid[2] = False
    offset = rs.uniform(-1.2, 1.2, (s, 2)).astype(np.float32)
    offset[is_edge] = direction[is_edge] * offset[is_edge, :1]
    offset[3] = [30.0, -28.0]
    ref_border = np.empty((s, 10, 10), np.float32)
    for lvl in range(3):
        sel = level == lvl
        h, w = pyr[lvl].shape
        cu, cv = jnp.asarray(px_true[sel, 0]), jnp.asarray(px_true[sel, 1])
        au, av = clip_anchor(cu, cv, 24, 10, h, w)
        wins = extract_windows(pyr[lvl], au, av, 24)
        ref_border[sel] = np.asarray(
            bilinear_grid(wins, cu - 5.0 - au, cv - 5.0 - av, 10))
    px_init = px_true + offset
    windows, anchors, img_hw = pack_level_windows(
        pyr, jnp.asarray(level), jnp.asarray(px_init[:, 0]),
        jnp.asarray(px_init[:, 1]), 24, 3)
    return dict(is_edge=jnp.asarray(is_edge), direction=jnp.asarray(direction),
                ref_border=jnp.asarray(ref_border), px_init=jnp.asarray(px_init),
                valid=jnp.asarray(valid), windows=windows, anchors=anchors,
                img_hw=img_hw, px_true=px_true)


def _align(p, valid):
    from hso_tpu.ops.align import align_mixed, ncc

    rm = align_mixed(p["is_edge"], p["direction"], p["ref_border"],
                     p["px_init"], n_iter=10, valid=valid,
                     windows=p["windows"], anchors=p["anchors"],
                     img_hw=p["img_hw"])
    score = ncc(p["ref_border"][:, 1:9, 1:9], rm["cur_patch"])
    return jax.tree.map(np.asarray, rm), np.asarray(score)


def test_align_match_recovers_offsets(pyr):
    p = _align_problem(pyr)
    rm, score = _align(p, p["valid"])
    conv = rm["converged"]
    assert not conv[[1, 2, 3]].any()          # adversarial rows must fail
    assert conv.sum() > 45                    # the problem is solvable
    err = np.linalg.norm(rm["px"] - p["px_true"], axis=1)
    assert err[conv].max() < 0.1, err[conv]
    assert np.median(err[conv]) < 0.02
    assert score[conv].min() > 0.95


def test_align_match_empty_mask(pyr):
    p = _align_problem(pyr)
    rm, _ = _align(p, jnp.zeros_like(p["valid"]))
    assert not rm["converged"].any()
    np.testing.assert_allclose(rm["px"], np.asarray(p["px_init"]), atol=1e-6)


# ---------------------------------------------------------------- coarse LM


def test_coarse_ic_recovers_known_motion_padded(scene):
    from hso_tpu.track.coarse_tracker import make_coarse_tracker

    T_gt = se3np.exp(np.array([0.04, -0.03, 0.02, 0.01, -0.015, 0.008]))
    ref_pyr = build_frame_pyramids(jnp.asarray(scene.render()),
                                   n_pyr_levels=3, n_total_levels=5)["pyr"]
    cur_pyr = build_frame_pyramids(jnp.asarray(scene.render(T_gt)),
                                   n_pyr_levels=3, n_total_levels=5)["pyr"]
    px, f, dist = scene.grid_features(step=32, border=32)
    n_max = 256                       # padded slots carry dist <= 0
    px_p = np.zeros((n_max, 2), np.float32)
    f_p = np.zeros((n_max, 3), np.float32)
    f_p[:, 2] = 1.0
    d_p = np.full((n_max,), -1.0, np.float32)
    px_p[: len(px)], f_p[: len(px)], d_p[: len(px)] = px, f, dist
    track = make_coarse_tracker(scene.cam, inverse=True)
    out = jax.tree.map(np.asarray, track(ref_pyr, cur_pyr, px_p, f_p, d_p,
                                         se3np.identity().astype(np.float32),
                                         1.0))
    err = se3np.log(se3np.mul(np.asarray(out["T_cur_ref"], np.float64),
                              se3np.inv(T_gt)))
    assert np.linalg.norm(err) < 4e-3, err
    assert abs(float(out["exposure_ratio"]) - 1.0) < 1e-2
    assert 0 < int(out["n_tracked"]) <= len(px)


# ---------------------------------------------------------------- pose LM


def test_pose_lm_recovers_pose_and_strips_outlier():
    from hso_tpu.track.pose_optimizer import optimize_pose

    rs = np.random.RandomState(11)
    n, n_live = 256, 180
    p_world = np.stack([rs.uniform(-2, 2, n), rs.uniform(-1.5, 1.5, n),
                        rs.uniform(1.5, 4.0, n)], -1).astype(np.float32)
    T_true = se3np.exp(np.array([0.05, -0.02, 0.03, 0.01, 0.02, -0.015]))
    p_c = (T_true[:3, :3] @ p_world.T).T + T_true[:3, 3]
    f_obs = p_c / np.linalg.norm(p_c, axis=-1, keepdims=True)
    f_obs += rs.normal(0, 5e-4, f_obs.shape)
    f_obs[n_live - 3, 0] += 0.1        # gross outlier (~40 px at f=400)
    f_obs /= np.linalg.norm(f_obs, axis=-1, keepdims=True)
    theta = rs.uniform(0, 2 * np.pi, n)
    out = jax.tree.map(np.asarray, optimize_pose(
        jnp.asarray(se3np.identity().astype(np.float32)), jnp.asarray(p_world),
        jnp.asarray(f_obs.astype(np.float32)),
        jnp.asarray(rs.randint(0, 3, n).astype(np.int32)),
        jnp.asarray(np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)),
        jnp.asarray(rs.rand(n) < 0.3), jnp.asarray(rs.rand(n) < 0.1),
        jnp.asarray(np.arange(n) < n_live), focal=400.0))
    err = se3np.log(se3np.mul(np.asarray(out["T_f_w"], np.float64),
                              se3np.inv(T_true)))
    assert np.linalg.norm(err) < 6e-3, err
    assert not out["inlier"][n_live - 3]
    assert not out["inlier"][n_live:].any()
    assert out["inlier"][:n_live].mean() > 0.9


def test_pose_lm_empty_mask():
    from hso_tpu.track.pose_optimizer import optimize_pose

    n = 128
    T0 = se3np.identity().astype(np.float32)
    none = jnp.zeros((n,), bool)
    out = jax.tree.map(np.asarray, optimize_pose(
        jnp.asarray(T0), jnp.zeros((n, 3), jnp.float32),
        jnp.asarray(np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32)),
        jnp.zeros((n,), jnp.int32), jnp.zeros((n, 2), jnp.float32),
        none, none, none, focal=400.0))
    np.testing.assert_allclose(out["T_f_w"], T0, atol=1e-6)
    assert int(out["n_inliers"]) == 0
