"""Batched affine patch warping between views.

Batched re-design of ``hso::warp`` (HSO's src/matcher.cpp:46-155):
``getWarpMatrixAffine`` / ``getBestSearchLevel`` / ``warpAffine`` for ALL
match candidates at once.  The warped 10×10 reference patches are sampled
gather-free from per-candidate 32×32 windows via two-tap weight einsums
(:func:`hso_tpu.ops.gatherless.bilinear_scatter_in_windows`).

Candidates may reference different keyframes; callers pass a stacked image
set and a per-candidate reference index — window extraction runs per
reference image with masked candidates and the results are summed (one-hot
over images), keeping everything static-shape.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from hso_tpu.math.linalg_small import det2x2
from hso_tpu.ops.gatherless import (
    bilinear_scatter_in_windows,
    clip_anchor,
    extract_windows,
)

BORD = 10          # bordered patch edge (patch 8 + 1px border)
HALF_BORD = 5


def warp_matrices(cam_ref, cam_cur, px_ref, f_ref, depth_ref, T_cur_ref, level_ref):
    """A_cur_ref (N, 2, 2): local affine px_cur ≈ A · px_ref around the
    feature (matcher.cpp:46-72; finite differences ``halfpatch_size=5`` along
    the ref axes at the feature's pyramid level)."""
    ratio = (1 << level_ref).astype(jnp.float32) if hasattr(level_ref, "dtype") else float(1 << level_ref)
    half = 5.0
    xyz_ref = f_ref * depth_ref[:, None]
    du = jnp.stack([px_ref[:, 0] + half * ratio, px_ref[:, 1]], axis=-1)
    dv = jnp.stack([px_ref[:, 0], px_ref[:, 1] + half * ratio], axis=-1)
    f_du = cam_ref.cam2world(du)
    f_dv = cam_ref.cam2world(dv)
    z = xyz_ref[:, 2:3]
    xyz_du = f_du * (z / f_du[:, 2:3])
    xyz_dv = f_dv * (z / f_dv[:, 2:3])

    def proj(p):
        R = T_cur_ref[..., :3, :3]
        t = T_cur_ref[..., :3, 3]
        return cam_cur.world2cam(jnp.sum(R * p[:, None, :], axis=-1) + t)

    px_cur = proj(xyz_ref)
    col0 = (proj(xyz_du) - px_cur) / half
    col1 = (proj(xyz_dv) - px_cur) / half
    return jnp.stack([col0, col1], axis=-1), px_cur


def best_search_level(A_cur_ref: jnp.ndarray, max_level: int) -> jnp.ndarray:
    """Per-candidate search pyramid level (matcher.cpp:74-85): quarter the
    warp determinant until ≤ 3."""
    D = jnp.abs(det2x2(A_cur_ref))
    level = jnp.zeros(D.shape, jnp.int32)
    for k in range(max_level):
        level = level + (D * (0.25**k) > 3.0).astype(jnp.int32)
    return level


def _box_blur_window(win: jnp.ndarray, k: int) -> jnp.ndarray:
    """k×k box average of (N, W, W) windows, top-left anchored (same size,
    edge-replicated): b[y, x] = mean win[y:y+k, x:x+k] — the filter a pyramid
    level ``log2(k)`` applies before subsampling."""
    w = win.shape[-1]
    p = jnp.pad(win, ((0, 0), (0, k - 1), (0, k - 1)), mode="edge")
    acc = jnp.zeros_like(win)
    for dy in range(k):
        for dx in range(k):
            acc = acc + p[:, dy : dy + w, dx : dx + w]
    return acc / float(k * k)


def warp_from_stored_windows(
    host_win, host_anchor, px_host, host_level, A_ref_cur, search_level,
    max_mip_delta: int = 2,
):
    """Warped 10×10 bordered reference patches sampled from memoized host
    windows (no host-image access).  ``px_host`` are level-0 coords;
    ``host_level`` (N,) the level the window was extracted at.

    When the search runs coarser than the host level (long epipolar ranges,
    strong scale change), the grid points land 2^Δ px apart in the stored
    window — point-sampling the fine texture there aliases against the
    box-filtered current pyramid level and decorrelates the ZMNCC (the
    reference avoids this by always reading the ref *pyramid* at the search
    level, matcher.cpp:87-155).  We emulate that filtering per row: the
    window is box-blurred by 2^Δ (Δ = search − host level, clipped) before
    sampling — a masked select over ``max_mip_delta``+1 precomputed blurs."""
    n = host_win.shape[0]
    g = jnp.arange(BORD, dtype=jnp.float32) - HALF_BORD
    gx, gy = jnp.meshgrid(g, g)
    pts = jnp.stack([gx.reshape(-1), gy.reshape(-1)], axis=0)
    scale_s = (2.0 ** search_level.astype(jnp.float32))[:, None, None]
    src = jnp.sum(A_ref_cur[..., :, :, None] * pts[None, None, :, :], axis=-2) * scale_s
    lvl_scale = 1.0 / (1 << host_level).astype(jnp.float32)
    hu = src[:, 0, :] + (px_host[:, 0] * lvl_scale - host_anchor[:, 0])[:, None]
    hv = src[:, 1, :] + (px_host[:, 1] * lvl_scale - host_anchor[:, 1])[:, None]

    delta = jnp.clip(search_level - host_level, 0, max_mip_delta)
    win_sel = host_win
    for d in range(1, max_mip_delta + 1):
        k = 1 << d
        win_sel = jnp.where(
            (delta == d)[:, None, None], _box_blur_window(host_win, k), win_sel
        )
    # top-left-anchored box of width k has its support centred +(k-1)/2 px
    # from the sample point — the same offset the plain u_l = u_0/2^l level
    # convention used throughout gives the current pyramid, so both sides
    # shift together and the ZMNCC peak stays put.
    return bilinear_scatter_in_windows(win_sel, hu, hv).reshape(n, BORD, BORD)


@functools.partial(jax.jit, static_argnames=("win", "n_levels"))
def memoize_level_windows(pyr, px, level, win: int = 24, n_levels: int = 3):
    """Extract a (win × win) appearance window per row from its own pyramid
    level (the "appearance memoization" primitive: one call at point/seed
    creation or patch-source refresh, then matching never reads this pyramid
    again).  ``px`` is in level-0 coordinates.  Returns (windows (N,win,win),
    anchors (N,2) int32 in level coordinates)."""
    n = px.shape[0]
    out_w = jnp.zeros((n, win, win), jnp.float32)
    out_a = jnp.zeros((n, 2), jnp.int32)
    for lvl in range(n_levels):
        img = pyr[lvl]
        scale = 1.0 / (1 << lvl)
        au, av = clip_anchor(px[:, 0] * scale, px[:, 1] * scale, win, 0, *img.shape)
        w_l = extract_windows(img, au, av, win)
        sel = level == lvl
        out_w = jnp.where(sel[:, None, None], w_l, out_w)
        out_a = jnp.where(sel[:, None], jnp.stack([au, av], -1), out_a)
    return out_w, out_a


@functools.partial(jax.jit, static_argnames=("win", "n_levels"))
def memoize_level_windows_packed(pyr, px, level, win: int = 24,
                                 n_levels: int = 3):
    """memoize_level_windows with windows+anchors flattened into ONE
    (N, win·win+2) buffer — a single device→host transfer."""
    w, a = memoize_level_windows(pyr, px, level, win=win, n_levels=n_levels)
    n = w.shape[0]
    return jnp.concatenate([w.reshape(n, -1), a.astype(jnp.float32)], axis=-1)
