"""Coarse tracker: direct sparse image alignment with joint exposure ratio.

Batched re-design of the reference CoarseTracker
(/root/reference/src/CoarseTracker.cpp): Levenberg-Marquardt over a 7-DoF
state [exposure_ratio; se3] with per-level MAD robust thresholds, DSO
saturation energy, and forward- or inverse-compositional updates chosen per
frame (frame_handler_mono.cpp:184-209).

Design — the whole coarse-to-fine track is ONE jitted device function, and
the LM loop reads only per-feature windows:

1. Per pyramid level, a single *window extraction* pulls a 24×24 window per
   feature around its predicted projection (:mod:`hso_tpu.ops.gatherless`).
2. Every LM evaluation bilinearly samples its G×G patch grid *inside* those
   windows via banded interpolation matmuls — zero gathers per iteration.
   Patch values / gradients at the DSO pattern constellation are picked from
   the grid by static 0/1 selection matmuls; image gradients are central
   differences of the sampled grid, exactly the reference's stencil.
3. The 7×7 Gauss-Newton system is one ``(w·J)ᵀJ`` matmul (the SSE
   ``Accumulator7`` of MatrixAccumulator.h collapses into it), and the
   level's LM loop is a ``lax.while_loop`` with accept/reject in the carry.

The factory is cached per (camera, level range, mode) — all trace-static.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from hso_tpu.math import se3
from hso_tpu.math.linalg_small import solve_spd_small
from hso_tpu.math.robust import masked_mad_sigma, masked_median
from hso_tpu.ops.gatherless import (
    bilinear_grid,
    clip_anchor,
    extract_windows,
    grid_in_window,
)
from hso_tpu.ops.patterns import PATTERNS, PATTERN_PADDING

WIN = 24  # per-feature window size (all levels)
_HI = jax.lax.Precision.HIGHEST


def _jacobian_uv_xi(xyz: jnp.ndarray) -> jnp.ndarray:
    """d(unit-plane uv)/d(xi) under the update convention T ← exp(-step)·T
    (transcribed from frame.h:192-212 ``jacobian_xyz2uv``).
    xyz (N, 3) → (N, 2, 6), tangent ordering [rho, phi]."""
    x, y = xyz[:, 0], xyz[:, 1]
    z = xyz[:, 2]
    zi = 1.0 / jnp.where(jnp.abs(z) < 1e-8, 1e-8, z)
    zi2 = zi * zi
    zero = jnp.zeros_like(x)
    row0 = jnp.stack(
        [-zi, zero, x * zi2, x * y * zi2, -(1.0 + x * x * zi2), y * zi], axis=-1
    )
    row1 = jnp.stack(
        [zero, -zi, y * zi2, 1.0 + y * y * zi2, -x * y * zi2, -x * zi], axis=-1
    )
    return jnp.stack([row0, row1], axis=-2)


@functools.lru_cache(maxsize=64)
def _selection_matrices(pattern_idx: int):
    """Static 0/1 matrices picking pattern values / ±1-shifted values out of
    the flattened G×G patch grid: (P, G*G) each, plus grid size G and centre."""
    pat = PATTERNS[pattern_idx]
    radius = PATTERN_PADDING[pattern_idx]
    g = 2 * radius + 3  # pattern extent + 1px gradient border
    c = radius + 1
    p = len(pat)

    def sel(du, dv):
        m = np.zeros((p, g * g), np.float32)
        for k, (dx, dy) in enumerate(pat):
            m[k, (c + dy + dv) * g + (c + dx + du)] = 1.0
        return m

    return {
        "G": g,
        "center": c,
        "n_pat": p,
        "val": sel(0, 0),
        "xp": sel(1, 0),
        "xm": sel(-1, 0),
        "yp": sel(0, 1),
        "ym": sel(0, -1),
    }


def _pattern_samples(grid_vals: jnp.ndarray, sel, with_grad: bool):
    """grid_vals (N, G, G) → pattern values (N, P) [+ gradients]."""
    n = grid_vals.shape[0]
    flat = grid_vals.reshape(n, -1)

    def pick(key):
        return jnp.dot(flat, jnp.asarray(sel[key]).T, precision=_HI)

    vals = pick("val")
    if not with_grad:
        return vals, None, None
    gx = 0.5 * (pick("xp") - pick("xm"))
    gy = 0.5 * (pick("yp") - pick("ym"))
    return vals, gx, gy


@functools.lru_cache(maxsize=32)
def make_coarse_tracker(
    cam,
    max_level: int = 4,
    min_level: int = 1,
    n_iter: int = 30,
    inverse: bool = False,
    pattern_offset: int = 2,
):
    """Build the jitted tracking function for a fixed camera/level config.

    Returned callable:
      ``track(ref_pyr, cur_pyr, px_ref, f_ref, dist_ref, T_cur_ref, a_init)``
        ref_pyr/cur_pyr : tuples of float32 pyramid images, level 0 first
        px_ref  (N, 2)  : level-0 feature pixels in the ref frame
        f_ref   (N, 3)  : unit bearings
        dist_ref (N,)   : distance along bearing (<= 0 marks an invalid slot)
        T_cur_ref (3,4) : initial relative pose guess
        a_init          : initial exposure ratio (cur_mean / ref_mean)
      → dict(T_cur_ref, exposure_ratio, n_tracked, energy, n_iters)
    """

    def level_step(level, T, a, ref_img, cur_img, px_ref, f_ref, dist_ref):
        sel = _selection_matrices(max_level - level + pattern_offset)
        G, c, n_pat = sel["G"], sel["center"], sel["n_pat"]
        scale = 1.0 / (1 << level)
        fxl = cam.fx * scale
        fyl = cam.fy * scale
        is_top = level == max_level
        border = PATTERN_PADDING[max_level - level + pattern_offset] + 1
        h, w = cur_img.shape
        hr, wr = ref_img.shape
        xyz_ref = f_ref * dist_ref[:, None]

        def project(T_e):
            xyz_cur = se3.apply(T_e, xyz_ref)
            uv0 = cam.world2cam(xyz_cur)
            return xyz_cur, uv0[:, 0] * scale, uv0[:, 1] * scale

        # ---- reference side: windows + patches (+ IC Jacobians), once ----
        u_r = px_ref[:, 0] * scale
        v_r = px_ref[:, 1] * scale
        vis = (
            (dist_ref > 0.0)
            & (jnp.floor(u_r) - border >= 0)
            & (jnp.floor(v_r) - border >= 0)
            & (jnp.floor(u_r) + border < wr)
            & (jnp.floor(v_r) + border < hr)
        )
        au_r, av_r = clip_anchor(u_r, v_r, WIN, G, hr, wr)
        w_ref = extract_windows(ref_img, au_r, av_r, WIN)
        rel_u_r = u_r - c - au_r
        rel_v_r = v_r - c - av_r
        grid_r = bilinear_grid(w_ref, rel_u_r, rel_v_r, G)
        ref_patch, rgx, rgy = _pattern_samples(grid_r, sel, with_grad=inverse)
        if inverse:
            Juv_r = _jacobian_uv_xi(xyz_ref)
            j_ic_raw = (
                rgx[..., None] * (fxl * Juv_r[:, None, 0, :])
                + rgy[..., None] * (fyl * Juv_r[:, None, 1, :])
            )

        # ---- current side: windows anchored at the incoming projection ----
        _, u_c0, v_c0 = project(T)
        au_c, av_c = clip_anchor(u_c0, v_c0, WIN, G, h, w)
        w_cur = extract_windows(cur_img, au_c, av_c, WIN)

        def evaluate(T_e, a_e, huber, cutoff):
            """(E_norm, H, b, n_terms) at state (T_e, a_e) — gather-free."""
            xyz_cur, u, v = project(T_e)
            rel_u = u - c - au_c
            rel_v = v - c - av_c
            valid = (
                vis
                & (xyz_cur[:, 2] > 0.0)
                & grid_in_window(rel_u, rel_v, G, WIN)
                & (jnp.floor(u) - border >= 0)
                & (jnp.floor(v) - border >= 0)
                & (jnp.floor(u) + border < w)
                & (jnp.floor(v) + border < h)
            )
            grid_c = bilinear_grid(w_cur, rel_u, rel_v, G)
            if inverse:
                cur_vals, _, _ = _pattern_samples(grid_c, sel, with_grad=False)
                J_T = a_e * j_ic_raw
            else:
                cur_vals, cgx, cgy = _pattern_samples(grid_c, sel, with_grad=True)
                Juv_c = _jacobian_uv_xi(xyz_cur)
                J_T = (
                    cgx[..., None] * (fxl * Juv_c[:, None, 0, :])
                    + cgy[..., None] * (fyl * Juv_c[:, None, 1, :])
                )

            r = cur_vals - a_e * ref_patch  # (N, P)
            m = valid[:, None] & jnp.ones_like(r, dtype=bool)
            abs_r = jnp.abs(r)
            hw = jnp.where(abs_r < huber, 1.0, huber / jnp.maximum(abs_r, 1e-12))
            if is_top:
                saturated = jnp.zeros_like(m)
                e_terms = hw * r * r
            else:
                saturated = (abs_r > cutoff) & m
                max_energy = 2.0 * huber * cutoff - huber * huber
                e_terms = jnp.where(saturated, max_energy, hw * r * r * (2.0 - hw))

            E = jnp.sum(jnp.where(m, e_terms, 0.0))
            n_terms = jnp.sum(m.astype(jnp.int32))

            wgt = jnp.where(m & ~saturated, hw, 0.0)
            J7 = jnp.concatenate([-ref_patch[..., None], J_T], axis=-1).reshape(-1, 7)
            Jw = J7 * wgt.reshape(-1)[:, None]
            H = jnp.dot(Jw.T, J7, precision=_HI)
            b = -jnp.dot(Jw.T, r.reshape(-1), precision=_HI)
            E_norm = E / jnp.maximum(n_terms, 1).astype(jnp.float32)
            return E_norm, H, b, n_terms

        # ---- robust thresholds from residuals at the initial state ----
        rel_u0 = u_c0 - c - au_c
        rel_v0 = v_c0 - c - av_c
        grid0 = bilinear_grid(w_cur, rel_u0, rel_v0, G)
        cur0, _, _ = _pattern_samples(grid0, sel, with_grad=False)
        valid0 = vis & grid_in_window(rel_u0, rel_v0, G, WIN)
        abs_r0 = jnp.abs(cur0 - a * ref_patch).reshape(-1)
        m0 = jnp.broadcast_to(valid0[:, None], cur0.shape).reshape(-1)
        n0 = jnp.sum(m0.astype(jnp.int32))
        med = masked_median(abs_r0, m0)
        sigma = masked_mad_sigma(abs_r0, m0)
        few = n0 < 30
        huber = jnp.where(few, 5.2, med + sigma)
        cutoff = jnp.where(few, 100.0, jnp.maximum(3.0 * (med + sigma), 10.0))

        # ---- LM loop ----
        E0, H0, b0, nt0 = evaluate(T, a, huber, cutoff)

        def lm_body(carry):
            T_c, a_c, lam, E_c, H_c, b_c, nt_c, it, stop = carry
            Hl = H_c + jnp.diag(jnp.diag(H_c)) * lam
            step = solve_spd_small(Hl, b_c)
            extrap = jnp.where(lam < 1e-3, jnp.sqrt(jnp.sqrt(1e-3 / lam)), 1.0)
            step = step * extrap
            step = jnp.where(jnp.all(jnp.isfinite(step)), step, jnp.zeros_like(step))

            a_new = a_c + step[0]
            dT = se3.exp(-step[1:7])
            T_new = se3.mul(dT, T_c) if not inverse else se3.mul(T_c, dT)

            E_new, H_new, b_new, nt_new = evaluate(T_new, a_new, huber, cutoff)
            accept = E_new < E_c

            T_c = jnp.where(accept, T_new, T_c)
            a_c = jnp.where(accept, a_new, a_c)
            E_c = jnp.where(accept, E_new, E_c)
            H_c = jnp.where(accept, H_new, H_c)
            b_c = jnp.where(accept, b_new, b_c)
            nt_c = jnp.where(accept, nt_new, nt_c)
            lam = jnp.where(accept, lam * 0.5, jnp.maximum(lam * 4.0, 1e-3))
            stop = jnp.linalg.norm(step) <= 1e-4
            return (T_c, a_c, lam, E_c, H_c, b_c, nt_c, it + 1, stop)

        def lm_cond(carry):
            *_, it, stop = carry
            return (it < n_iter) & ~stop

        carry = (T, a, jnp.float32(0.1), E0, H0, b0, nt0, jnp.int32(0), jnp.bool_(False))
        with jax.named_scope("coarse_lm"):
            T, a, _, energy, _, _, n_terms, iters, _ = jax.lax.while_loop(
                lm_cond, lm_body, carry)
        return T, a, energy, n_terms // n_pat, iters

    def track(ref_pyr, cur_pyr, px_ref, f_ref, dist_ref, T_cur_ref, a_init):
        T = jnp.asarray(T_cur_ref, jnp.float32)
        a = jnp.asarray(a_init, jnp.float32)
        px_ref = jnp.asarray(px_ref, jnp.float32)
        f_ref = jnp.asarray(f_ref, jnp.float32)
        dist_ref = jnp.asarray(dist_ref, jnp.float32)
        energy = jnp.zeros((), jnp.float32)
        n_tracked = jnp.zeros((), jnp.int32)
        iters = []
        for level in range(max_level, min_level - 1, -1):
            T, a, energy, n_tracked, it = level_step(
                level, T, a, ref_pyr[level], cur_pyr[level], px_ref, f_ref, dist_ref
            )
            iters.append(it)
        return {
            "T_cur_ref": T,
            "exposure_ratio": a,
            "n_tracked": n_tracked,
            "energy": energy,
            "n_iters": jnp.stack(iters),
        }

    return jax.jit(track)
