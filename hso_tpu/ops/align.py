"""Batched inverse-compositional KLT feature alignment (align2D / align1D).

Batched re-design of HSO's src/feature_alignment.cpp (float overloads,
:164-310 ``align1D`` and :464-608 ``align2D``) and the hand-vectorized
``align2D_SSE2/NEON`` variants: instead of one feature at a time with SSE
lanes across a patch row, we align ALL candidates at once — (N, 8, 8) patch
math, per-candidate 24×24 windows extracted once, every iteration sampling
inside them (ops/gatherless).

Semantics preserved from the reference:
  * 8×8 patches, 10×10 ref patch with border; template gradients by central
    differences on the bordered patch.
  * DSO-style gradient weights w = sqrt(250/(250+|∇T|²)).
  * 3-DoF state [u, v, mean_diff] (align2D) or 2-DoF [step-along-dir,
    mean_diff] (align1D); inverse compositional — H from the template, fixed.
  * H diagonal inflated by 1.001; ≤ n_iter iterations; converge at
    |Δuv| < 0.03 px (2D) / |Δ| < 0.01 px (1D); fail if final chi2 > 1000·64
    or the patch leaves the image.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hso_tpu.math.linalg_small import inv2x2, inv3x3
from hso_tpu.ops.gatherless import bilinear_grid, clip_anchor, extract_windows

PATCH = 8
BORD = PATCH + 2
WIN = 24
_HALF = PATCH // 2


def _run_align_loop(body, init, n_iter: int):
    """Run an alignment iteration body under ``lax.while_loop`` with a
    global early exit once every candidate has converged or died (the
    reference's per-feature iteration loops stop the same way; a fixed
    ``fori_loop`` pays the worst case for the whole batch every frame)."""
    def cond(c):
        return (c[-1] < n_iter) & jnp.any(c[4])

    def wbody(c):
        return body(0, c[:-1]) + (c[-1] + 1,)

    with jax.named_scope("align_lm"):
        out = jax.lax.while_loop(cond, wbody, tuple(init) + (jnp.int32(0),))
    return out[:-1]


def _template_grads(ref_border: jnp.ndarray):
    """(N,10,10) bordered template → interior (N,8,8) value/dx/dy."""
    t = ref_border
    val = t[:, 1:-1, 1:-1]
    dx = 0.5 * (t[:, 1:-1, 2:] - t[:, 1:-1, :-2])
    dy = 0.5 * (t[:, 2:, 1:-1] - t[:, :-2, 1:-1])
    return val, dx, dy


def _extract(cur_img, u0, v0):
    h, w = cur_img.shape
    au, av = clip_anchor(u0, v0, WIN, BORD, h, w)
    return au, av, extract_windows(cur_img, au, av, WIN)


def _sample(windows, au, av, u, v):
    """Sample the 8×8 patch at subpixel centre (u, v): grid point (x, y) maps
    to image coords (u - 4 + x, v - 4 + y)."""
    rel_u = (u - _HALF) - au
    rel_v = (v - _HALF) - av
    return bilinear_grid(windows, rel_u, rel_v, PATCH), rel_u, rel_v


def _in_image(u, v, h, w):
    ur = jnp.floor(u)
    vr = jnp.floor(v)
    return (ur >= _HALF) & (vr >= _HALF) & (ur < w - _HALF) & (vr < h - _HALF)


def _in_window(rel, extent):
    return (rel >= 0.0) & (rel + PATCH - 1 <= extent - 1.0)


def align2d(cur_img, ref_border, px_init, n_iter: int = 10, valid=None,
            windows=None, anchors=None, img_hw=None):
    """Batched align2D.

    cur_img    : (H, W) float32 search image (one pyramid level), or None
                 when prebuilt ``windows`` + ``anchors`` + ``img_hw`` are given
    ref_border : (N, 10, 10) warped+exposure-compensated template w/ border
    px_init    : (N, 2) initial pixel estimates in cur_img coords
    valid      : (N,) bool mask of live candidates

    Returns dict(px, converged, chi2, cur_patch, mean_diff).
    """
    n = ref_border.shape[0]
    h, w = cur_img.shape if cur_img is not None else img_hw
    if valid is None:
        valid = jnp.ones((n,), bool)
    ref, dx, dy = _template_grads(ref_border)
    wgt = jnp.sqrt(250.0 / (250.0 + dx * dx + dy * dy))

    j = jnp.stack([dx, dy, jnp.ones_like(dx)], axis=-1)          # (N,8,8,3)
    H = jnp.sum(j[..., :, None] * j[..., None, :] * wgt[..., None, None],
                axis=(1, 2))
    H = H * (jnp.eye(3) * 1e-3 + 1.0)
    Hinv = inv3x3(H)

    u0 = px_init[:, 0]
    v0 = px_init[:, 1]
    if windows is None:
        au, av, windows = _extract(cur_img, u0, v0)
    else:
        au, av = anchors
    win_n = windows.shape[1]

    def body(_, carry):
        u, v, mean_diff, chi2, active, conv = carry
        patch, rel_u, rel_v = _sample(windows, au, av, u, v)
        inb = _in_image(u, v, h, w) & _in_window(rel_u, win_n) & _in_window(rel_v, win_n)
        active = active & inb & jnp.isfinite(u) & jnp.isfinite(v)

        res = patch - ref + mean_diff[:, None, None]
        jres = -jnp.sum((res * wgt)[..., None] * j, axis=(1, 2))
        new_chi2 = jnp.sum(res * res * wgt, axis=(1, 2))
        upd = jnp.sum(Hinv * jres[:, None, :], axis=-1)

        u = jnp.where(active, u + upd[:, 0], u)
        v = jnp.where(active, v + upd[:, 1], v)
        mean_diff = jnp.where(active, mean_diff + upd[:, 2], mean_diff)
        chi2 = jnp.where(active, new_chi2, chi2)
        small = upd[:, 0] ** 2 + upd[:, 1] ** 2 < 0.03 * 0.03
        conv = conv | (active & small)
        active = active & ~small
        return u, v, mean_diff, chi2, active, conv

    init = (
        u0, v0, jnp.zeros((n,)), jnp.zeros((n,)), valid, jnp.zeros((n,), bool)
    )
    u, v, mean_diff, chi2, _, conv = _run_align_loop(body, init, n_iter)
    conv = conv & (chi2 <= 1000.0 * PATCH * PATCH) & valid
    final_patch, _, _ = _sample(windows, au, av, u, v)
    return {
        "px": jnp.stack([u, v], axis=-1),
        "converged": conv,
        "chi2": chi2,
        "cur_patch": final_patch,
        "mean_diff": mean_diff,
    }


def align1d(cur_img, direction, ref_border, px_init, n_iter: int = 10, valid=None,
            windows=None, anchors=None, img_hw=None):
    """Batched align1D: motion restricted to ``direction`` (N, 2), plus a
    mean-intensity DoF (feature_alignment.cpp:164-310)."""
    n = ref_border.shape[0]
    h, w = cur_img.shape if cur_img is not None else img_hw
    if valid is None:
        valid = jnp.ones((n,), bool)
    ref, dx, dy = _template_grads(ref_border)
    d = direction / jnp.maximum(jnp.linalg.norm(direction, axis=-1, keepdims=True), 1e-9)
    jd = dx * d[:, None, None, 0] + dy * d[:, None, None, 1]     # (N,8,8)
    wgt = jnp.sqrt(250.0 / (250.0 + jd * jd))

    j = jnp.stack([jd, jnp.ones_like(jd)], axis=-1)
    H = jnp.sum(j[..., :, None] * j[..., None, :] * wgt[..., None, None],
                axis=(1, 2))
    H = H * (jnp.eye(2) * 1e-3 + 1.0)
    Hinv = inv2x2(H)
    h_inv = 1.0 / H[:, 0, 0] * PATCH * PATCH

    u0 = px_init[:, 0]
    v0 = px_init[:, 1]
    if windows is None:
        au, av, windows = _extract(cur_img, u0, v0)
    else:
        au, av = anchors
    win_n = windows.shape[1]

    def body(_, carry):
        u, v, mean_diff, chi2, active, conv = carry
        patch, rel_u, rel_v = _sample(windows, au, av, u, v)
        inb = _in_image(u, v, h, w) & _in_window(rel_u, win_n) & _in_window(rel_v, win_n)
        active = active & inb & jnp.isfinite(u) & jnp.isfinite(v)

        res = patch - ref + mean_diff[:, None, None]
        jres = -jnp.sum((res * wgt)[..., None] * j, axis=(1, 2))
        new_chi2 = jnp.sum(res * res * wgt, axis=(1, 2))
        upd = jnp.sum(Hinv * jres[:, None, :], axis=-1)

        u = jnp.where(active, u + upd[:, 0] * d[:, 0], u)
        v = jnp.where(active, v + upd[:, 0] * d[:, 1], v)
        mean_diff = jnp.where(active, mean_diff + upd[:, 1], mean_diff)
        chi2 = jnp.where(active, new_chi2, chi2)
        small = upd[:, 0] ** 2 < 0.01 * 0.01
        conv = conv | (active & small)
        active = active & ~small
        return u, v, mean_diff, chi2, active, conv

    init = (
        u0, v0, jnp.zeros((n,)), jnp.zeros((n,)), valid, jnp.zeros((n,), bool)
    )
    u, v, mean_diff, chi2, _, conv = _run_align_loop(body, init, n_iter)
    conv = conv & (chi2 <= 1000.0 * PATCH * PATCH) & valid
    final_patch, _, _ = _sample(windows, au, av, u, v)
    return {
        "px": jnp.stack([u, v], axis=-1),
        "converged": conv,
        "chi2": chi2,
        "cur_patch": final_patch,
        "mean_diff": mean_diff,
        "h_inv": h_inv,
    }


def align_mixed(is_edge, direction, ref_border, px_init, n_iter: int = 10,
                valid=None, windows=None, anchors=None, img_hw=None):
    """Fused corner/edgelet alignment: ONE LM loop where corner rows take the
    3-DoF [u, v, mean] update and edgelet rows the 2-DoF [step-along-normal,
    mean] update.  The per-iteration patch sampling — the expensive part —
    is shared, so this costs one ``align2d`` instead of an ``align2d`` plus
    an ``align1d`` over the same candidate set (semantics per row identical
    to the split kernels)."""
    n = ref_border.shape[0]
    h, w = img_hw
    if valid is None:
        valid = jnp.ones((n,), bool)
    ref, dx, dy = _template_grads(ref_border)

    # corner system (3-DoF)
    wgt2 = jnp.sqrt(250.0 / (250.0 + dx * dx + dy * dy))
    j3 = jnp.stack([dx, dy, jnp.ones_like(dx)], axis=-1)
    H3 = jnp.sum(j3[..., :, None] * j3[..., None, :] * wgt2[..., None, None],
                 axis=(1, 2))
    H3 = H3 * (jnp.eye(3) * 1e-3 + 1.0)
    Hinv3 = inv3x3(H3)

    # edgelet system (2-DoF along the normal)
    d = direction / jnp.maximum(jnp.linalg.norm(direction, axis=-1, keepdims=True), 1e-9)
    jd = dx * d[:, None, None, 0] + dy * d[:, None, None, 1]
    wgt1 = jnp.sqrt(250.0 / (250.0 + jd * jd))
    j2 = jnp.stack([jd, jnp.ones_like(jd)], axis=-1)
    H2 = jnp.sum(j2[..., :, None] * j2[..., None, :] * wgt1[..., None, None],
                 axis=(1, 2))
    H2 = H2 * (jnp.eye(2) * 1e-3 + 1.0)
    Hinv2 = inv2x2(H2)

    au, av = anchors
    win_n = windows.shape[1]
    wgt = jnp.where(is_edge[:, None, None], wgt1, wgt2)

    def body(_, carry):
        u, v, mean_diff, chi2, active, conv = carry
        patch, rel_u, rel_v = _sample(windows, au, av, u, v)
        inb = _in_image(u, v, h, w) & _in_window(rel_u, win_n) & _in_window(rel_v, win_n)
        active = active & inb & jnp.isfinite(u) & jnp.isfinite(v)

        res = patch - ref + mean_diff[:, None, None]
        new_chi2 = jnp.sum(res * res * wgt, axis=(1, 2))
        jres3 = -jnp.sum((res * wgt2)[..., None] * j3, axis=(1, 2))
        jres2 = -jnp.sum((res * wgt1)[..., None] * j2, axis=(1, 2))
        upd3 = jnp.sum(Hinv3 * jres3[:, None, :], axis=-1)
        upd2 = jnp.sum(Hinv2 * jres2[:, None, :], axis=-1)

        du = jnp.where(is_edge, upd2[:, 0] * d[:, 0], upd3[:, 0])
        dv = jnp.where(is_edge, upd2[:, 0] * d[:, 1], upd3[:, 1])
        dm = jnp.where(is_edge, upd2[:, 1], upd3[:, 2])
        u = jnp.where(active, u + du, u)
        v = jnp.where(active, v + dv, v)
        mean_diff = jnp.where(active, mean_diff + dm, mean_diff)
        chi2 = jnp.where(active, new_chi2, chi2)
        small = jnp.where(
            is_edge, upd2[:, 0] ** 2 < 0.01 * 0.01,
            upd3[:, 0] ** 2 + upd3[:, 1] ** 2 < 0.03 * 0.03,
        )
        conv = conv | (active & small)
        active = active & ~small
        return u, v, mean_diff, chi2, active, conv

    init = (
        px_init[:, 0], px_init[:, 1], jnp.zeros((n,)), jnp.zeros((n,)),
        valid, jnp.zeros((n,), bool),
    )
    u, v, mean_diff, chi2, _, conv = _run_align_loop(body, init, n_iter)
    conv = conv & (chi2 <= 1000.0 * PATCH * PATCH) & valid
    final_patch, _, _ = _sample(windows, au, av, u, v)
    return {
        "px": jnp.stack([u, v], axis=-1),
        "converged": conv,
        "chi2": chi2,
        "cur_patch": final_patch,
        "mean_diff": mean_diff,
    }


def ncc(patch_a: jnp.ndarray, patch_b: jnp.ndarray) -> jnp.ndarray:
    """Batched zero-mean NCC between (N, P, P) patches (matcher.cpp:379-404)."""
    a = patch_a.reshape(patch_a.shape[0], -1)
    b = patch_b.reshape(patch_b.shape[0], -1)
    a = a - jnp.mean(a, axis=-1, keepdims=True)
    b = b - jnp.mean(b, axis=-1, keepdims=True)
    num = jnp.sum(a * b, axis=-1)
    den = jnp.sqrt(jnp.sum(a * a, axis=-1) * jnp.sum(b * b, axis=-1)) + 1e-12
    return num / den
