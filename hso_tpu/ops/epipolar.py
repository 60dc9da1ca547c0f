"""Batched epipolar line stereo via dense ZMNCC correlation maps.

Batched re-design of ``Matcher::doLineStereo`` (HSO's src/matcher.cpp:
802-1049, LSD-SLAM-style): the reference walks each seed's epipolar segment
one pixel at a time, scoring an 8×8 ZMNCC per step (the DepthFilter spreads
this over 4 reduce threads).  Here ALL seeds are processed at once with zero
per-step work:

1. one *level-packed* window per seed covering its (cropped) epipolar
   segment — seeds searching at different pyramid levels share a single
   buffer (three masked window gathers merged), so every downstream op
   runs once, not once per level,
2. zero-mean NCC against the warped reference patch for EVERY patch position
   in the window at once, from three depthwise correlations
   (Σ target, Σ target², Σ ref·target — ``lax.conv`` with per-seed kernels),
3. the dense score map sampled along the epipolar line with two-tap weights;
   best/second-best with the reference's adjacency-aware ambiguity rejection
   (MIN_DISTANCE_ERROR_STEREO = 1.5).

The search range is cropped to the window (EPL ≤ ~36 px at the search level
vs the reference's 100 px cap — uncertain seeds simply take another frame or
two to converge).  Subpixel refinement afterwards is the batched KLT in
ops/align.py, reusing the same windows.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from hso_tpu.ops.gatherless import clip_anchor, extract_windows

PATCH = 8
EW = 40                      #: per-seed search window edge
MAX_EPL = float(EW - PATCH - 4)  #: max epl length representable in a window
MIN_EPL = 2.0
AMBIGUITY_RATIO = 1.5        #: MIN_DISTANCE_ERROR_STEREO (matcher.cpp:796)
_HI = jax.lax.Precision.HIGHEST


def pack_level_windows(pyr, search_level, center_u_l, center_v_l, win: int,
                       n_levels: int):
    """Per-seed windows from per-seed pyramid levels, merged into one buffer.

    ``center_u_l/v_l`` are centres in each seed's OWN level coordinates.
    Returns (windows (S,win,win), (au, av), (h_l, w_l) per-seed image dims).
    """
    s = search_level.shape[0]
    au = jnp.zeros((s,), jnp.int32)
    av = jnp.zeros((s,), jnp.int32)
    hs = jnp.zeros((s,), jnp.int32)
    ws = jnp.zeros((s,), jnp.int32)
    for lvl in range(n_levels):
        h, w = pyr[lvl].shape
        a_u, a_v = clip_anchor(center_u_l, center_v_l, win, 0, h, w)
        sel = search_level == lvl
        au = jnp.where(sel, a_u, au)
        av = jnp.where(sel, a_v, av)
        hs = jnp.where(sel, h, hs)
        ws = jnp.where(sel, w, ws)

    windows = jnp.zeros((s, win, win), jnp.float32)
    for lvl in range(n_levels):
        w_lvl = extract_windows(pyr[lvl], au, av, win)
        sel = search_level == lvl
        windows = jnp.where(sel[:, None, None], w_lvl, windows)
    return windows, (au, av), (hs, ws)


def _depthwise_corr(windows: jnp.ndarray, kernels: jnp.ndarray) -> jnp.ndarray:
    """Per-seed valid correlation: (S, EW, EW) ⊛ (S, kh, kw) → (S, EW-kh+1, ...),
    as one seed-grouped convolution (HIGHEST precision: cuDNN may otherwise
    run it in TF32)."""
    s = windows.shape[0]
    out = jax.lax.conv_general_dilated(
        windows[None],                       # NCHW: (1, S, EW, EW)
        kernels[:, None],                    # OIHW: (S, 1, kh, kw)
        window_strides=(1, 1),
        padding="VALID",
        feature_group_count=s,
        precision=_HI,
    )
    return out[0]


def _box_sums(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """VALID k×k box sum of (S, E, E) → (S, E-k+1, E-k+1) as separable
    shifted adds (2k adds that XLA fuses into one elementwise pass)."""
    e = x.shape[-1]
    out_w = e - k + 1
    acc = x[:, :, 0:out_w]
    for dx in range(1, k):
        acc = acc + x[:, :, dx:dx + out_w]
    acc2 = acc[:, 0:out_w, :]
    for dy in range(1, k):
        acc2 = acc2 + acc[:, dy:dy + out_w, :]
    return acc2


@functools.partial(jax.jit, static_argnames=("n_steps",))
def epipolar_zmncc_search(
    windows,            # (S, EW, EW) level-packed search windows
    anchors,            # (au, av) window anchors in level coords
    img_hw,             # (h_l, w_l) per-seed image dims at the search level
    ref_patch,          # (S, 8, 8) warped + exposure-compensated templates
    px_far,             # (S, 2) epl start (far-depth projection), level coords
    px_close,           # (S, 2) epl end (close-depth projection)
    valid,              # (S,)
    n_steps: int = 40,
):
    """Dense ZMNCC search along each epipolar segment.

    Returns dict(px_best (S,2), score_best, score_second, ok (S,),
    n_line (S,), epl_dir (S,2))."""
    au, av = anchors
    hs, ws = img_hw

    d = px_close - px_far
    epl_len = jnp.linalg.norm(d, axis=-1)
    dir_unit = d / jnp.maximum(epl_len, 1e-9)[:, None]

    # crop long epls toward the far end (matcher.cpp:875-879), pad short ones
    # symmetrically to MIN_EPL (+1 sample each side, :884-898)
    length = jnp.clip(epl_len, 0.0, MAX_EPL)
    pad = jnp.maximum(0.0, (MIN_EPL - length) * 0.5)
    start = px_far - dir_unit * (1.0 + pad)[:, None]
    n_line = jnp.ceil(length + 2.0 * (1.0 + pad)).astype(jnp.int32)
    n_line = jnp.minimum(n_line, n_steps - 1)

    # ---- dense ZMNCC over all patch positions ----
    sum_t = _box_sums(windows, PATCH)
    sum_t2 = _box_sums(windows * windows, PATCH)
    corr = _depthwise_corr(windows, ref_patch)
    area = float(PATCH * PATCH)
    ref_mean = jnp.mean(ref_patch, axis=(1, 2))
    ref_zm = ref_patch - ref_mean[:, None, None]
    ref_den = jnp.sum(ref_zm * ref_zm, axis=(1, 2))
    num = corr - ref_mean[:, None, None] * sum_t
    var_t = jnp.maximum(sum_t2 - sum_t * sum_t / area, 0.0)
    zmncc = num / (jnp.sqrt(ref_den[:, None, None] * var_t) + 1e-12)

    # ---- sample the score map along the line ----
    ks = jnp.arange(n_steps, dtype=jnp.float32)
    pu = start[:, 0:1] + dir_unit[:, 0:1] * ks[None, :]      # (S, K)
    pv = start[:, 1:2] + dir_unit[:, 1:2] * ks[None, :]
    # patch at position p reads rows floor(p)-4+[0,8) with fractional
    # blend — equivalently the score map sampled at p - 4 - anchor
    su = pu - 4.0 - au[:, None].astype(jnp.float32)
    sv = pv - 4.0 - av[:, None].astype(jnp.float32)
    cw = zmncc.shape[-1]
    y = jnp.arange(cw, dtype=jnp.float32)
    wy = jnp.maximum(0.0, 1.0 - jnp.abs(sv[..., None] - y))  # (S, K, CW)
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(su[..., None] - y))
    scores = jnp.einsum("sky,syx,skx->sk", wy, zmncc, wx, precision=_HI)

    hf = hs[:, None].astype(jnp.float32)
    wf = ws[:, None].astype(jnp.float32)
    k_mask = (
        (ks[None, :] <= n_line[:, None].astype(jnp.float32))
        & (su >= 0.0) & (su <= cw - 1.0) & (sv >= 0.0) & (sv <= cw - 1.0)
        # full patch must also be inside the image, not just the window
        & (pu - 4.0 >= 0.0) & (pu + 4.0 <= wf - 1.0)
        & (pv - 4.0 >= 0.0) & (pv + 4.0 <= hf - 1.0)
    )
    scores = jnp.where(k_mask, scores, -jnp.inf)

    k_best = jnp.argmax(scores, axis=-1)
    score_best = jnp.max(scores, axis=-1)
    # second best at loop distance > 1
    far_mask = jnp.abs(ks[None, :]
                       - k_best[:, None].astype(jnp.float32)) > 1.0
    scores_far = jnp.where(far_mask, scores, -jnp.inf)
    score_second = jnp.max(scores_far, axis=-1)

    ambiguous = (score_second > -jnp.inf) & (
        AMBIGUITY_RATIO * score_second > score_best
    )
    ok = valid & jnp.isfinite(score_best) & (score_best > 0.1) & ~ambiguous

    px_best = jnp.stack(
        [
            start[:, 0] + dir_unit[:, 0] * k_best.astype(jnp.float32),
            start[:, 1] + dir_unit[:, 1] * k_best.astype(jnp.float32),
        ],
        axis=-1,
    )
    return {
        "px_best": px_best,
        "score_best": score_best,
        "score_second": score_second,
        "ok": ok,
        "n_line": n_line,
        "epl_dir": dir_unit,
    }


def triangulate_depth(T_cur_ref, f_ref, f_cur):
    """Batched midpoint depth along f_ref (matcher.cpp:242-255
    ``depthFromTriangulation``): solves min ‖[R f_ref, f_cur] λ + t‖.

    Returns (depth, ok)."""
    R = T_cur_ref[..., :3, :3]
    t = T_cur_ref[..., :3, 3]
    a0 = jnp.sum(R * f_ref[:, None, :], axis=-1)
    A = jnp.stack([a0, f_cur], axis=-1)                  # (N, 3, 2)
    AtA = jnp.sum(A[..., :, None] * A[..., None, :], axis=1)
    det = AtA[:, 0, 0] * AtA[:, 1, 1] - AtA[:, 0, 1] * AtA[:, 1, 0]
    ok = jnp.abs(det) > 1e-6
    det_safe = jnp.where(ok, det, 1.0)
    inv = (
        jnp.stack(
            [
                jnp.stack([AtA[:, 1, 1], -AtA[:, 0, 1]], -1),
                jnp.stack([-AtA[:, 1, 0], AtA[:, 0, 0]], -1),
            ],
            -2,
        )
        / det_safe[:, None, None]
    )
    Atb = -jnp.sum(A * t[..., None], axis=1)
    lam = jnp.sum(inv * Atb[:, None, :], axis=-1)
    return jnp.abs(lam[:, 0]), ok
