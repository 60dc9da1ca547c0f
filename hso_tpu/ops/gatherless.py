"""Windowed sampling: one window gather per feature, then gather-free
subpixel reads inside the windows.

Every scattered-access pattern in the reference's hot loops (patch sampling
in CoarseTracker.cpp:317-342, warp/align in matcher.cpp, epipolar scoring)
is expressed through:

* ``extract_windows``  — per-feature (win × win) image windows, one
  ``dynamic_slice`` each.
* ``bilinear_grid``    — a G×G bilinear patch grid *inside* each window via
  banded (2-tap triangle) interpolation matrices, so iterative aligners (LM
  loops) never touch the image again after one window extraction per level.
* ``sample_points``    — scattered single-point bilinear reads as two-tap
  row/col contractions.

Every contraction runs at ``Precision.HIGHEST``: a GPU may otherwise take an
f32 matmul in TF32 (10 mantissa bits), which would round pixel intensities.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def extract_windows(
    img: jnp.ndarray, anchor_u: jnp.ndarray, anchor_v: jnp.ndarray, win: int
) -> jnp.ndarray:
    """Extract (N, win, win) windows with integer top-left anchors.

    One ``dynamic_slice`` per window (a native gather on the GPU).  Callers
    get anchors from :func:`clip_anchor` and keep coordinates consistent
    with the clipped values; an anchor outside [0, dim - win] (another
    pyramid level's, in :func:`hso_tpu.ops.epipolar.pack_level_windows`) is
    clamped into it, as ``dynamic_slice`` does.

    An image smaller than the window (the top pyramid level of a small
    camera) gets negative anchors from :func:`clip_anchor`; the window then
    holds the image at that offset and zeros before it.
    """
    h, w = img.shape
    ph, pw = max(win - h, 0), max(win - w, 0)
    if ph or pw:
        img = jnp.pad(img, ((ph, 0), (pw, 0)))
        anchor_u, anchor_v = anchor_u + pw, anchor_v + ph

    def one(u, v):
        return jax.lax.dynamic_slice(img, (v, u), (win, win))

    return jax.vmap(one)(anchor_u.astype(jnp.int32), anchor_v.astype(jnp.int32))


def clip_anchor(center_u, center_v, win: int, grid: int, h: int, w: int):
    """Integer window anchors centred on (center_u, center_v) with the G-grid
    centred, clipped to image bounds."""
    au = jnp.clip(jnp.floor(center_u).astype(jnp.int32) - (win - grid) // 2 - grid // 2, 0, w - win)
    av = jnp.clip(jnp.floor(center_v).astype(jnp.int32) - (win - grid) // 2 - grid // 2, 0, h - win)
    return au, av


def _tri_matrix(rel: jnp.ndarray, grid: int, win: int) -> jnp.ndarray:
    """Banded linear-interp matrix A (N, grid, win):
    A[n, g, y] = max(0, 1 - |rel[n] + g - y|)."""
    g = jnp.arange(grid, dtype=jnp.float32)[None, :, None]
    y = jnp.arange(win, dtype=jnp.float32)[None, None, :]
    return jnp.maximum(0.0, 1.0 - jnp.abs(rel[:, None, None] + g - y))


def bilinear_grid(
    windows: jnp.ndarray, rel_u: jnp.ndarray, rel_v: jnp.ndarray, grid: int
) -> jnp.ndarray:
    """Bilinearly sample a (grid × grid) patch from each window.

    ``rel_u/rel_v`` (N,) are window coordinates of the patch's (0,0) grid
    point; grid spacing is 1 pixel.  Returns (N, grid, grid) values
    out[n, gy, gx] = bilerp(W_n)(rel_u + gx, rel_v + gy).

    Pure banded matmuls: the LM-loop body of every aligner calls this — no
    gathers.  Samples falling outside the window read as 0; callers mask
    via :func:`grid_in_window`.
    """
    av = _tri_matrix(rel_v, grid, windows.shape[1])
    au = _tri_matrix(rel_u, grid, windows.shape[2])
    tmp = jnp.einsum("ngy,nyx->ngx", av, windows, precision=_HI)
    return jnp.einsum("ngx,nhx->ngh", tmp, au, precision=_HI)


def grid_in_window(rel_u, rel_v, grid: int, win: int):
    """True where the whole sampled grid lies strictly inside the window."""
    return (
        (rel_u >= 0.0)
        & (rel_v >= 0.0)
        & (rel_u + grid - 1 <= win - 1.0)
        & (rel_v + grid - 1 <= win - 1.0)
    )


def bilinear_scatter_in_windows(
    windows: jnp.ndarray, pu: jnp.ndarray, pv: jnp.ndarray
) -> jnp.ndarray:
    """Sample M *arbitrary* subpixel points per window (affine warps etc.).

    windows (N, WIN, WIN); pu/pv (N, M) window coords ⇒ (N, M) values via
    two-tap row/col weight tensors — one einsum, no gathers.  Out-of-window
    points read 0.
    """
    win = windows.shape[1]
    y = jnp.arange(win, dtype=jnp.float32)
    wy = jnp.maximum(0.0, 1.0 - jnp.abs(pv[..., None] - y))   # (N, M, WIN)
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(pu[..., None] - y))
    return jnp.einsum("nmy,nyx,nmx->nm", wy, windows, wx, precision=_HI)


def sample_points(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Scattered single-point bilinear reads as two-tap matmuls.

    out[n] = bilerp(img)(u[n], v[n]).  Cost: one (N,H)x(H,W) and one
    elementwise+reduce, no gathers.  Coordinates outside the
    image read as 0.
    """
    h, w = img.shape
    av = jnp.maximum(
        0.0, 1.0 - jnp.abs(v[:, None] - jnp.arange(h, dtype=img.dtype)[None, :])
    )
    au = jnp.maximum(
        0.0, 1.0 - jnp.abs(u[:, None] - jnp.arange(w, dtype=img.dtype)[None, :])
    )
    rows = jax.lax.dot(av, img, precision=_HI)  # (N, W)
    return jnp.sum(rows * au, axis=-1)


def sample_gradient_in_windows(windows, au, av, u, v):
    """Central-difference image gradient at one subpixel point per window.

    ``windows`` (N, W, W) with integer image-coord anchors (au, av); (u, v)
    image coords.  Returns (gx, gy) each (N,).  Replaces full-image Sobel
    ``sample_points`` on the hot paths (a converged match always sits ≥4 px
    inside its window, so the ±1 px stencil stays in-window); only the
    gradient *direction* is consumed downstream, for which the central
    difference of the pyramid level matches the Sobel direction.
    """
    ru = u - au.astype(jnp.float32)
    rv = v - av.astype(jnp.float32)
    pu = jnp.stack([ru + 1.0, ru - 1.0, ru, ru], axis=-1)
    pv = jnp.stack([rv, rv, rv + 1.0, rv - 1.0], axis=-1)
    vals = bilinear_scatter_in_windows(windows, pu, pv)
    gx = 0.5 * (vals[:, 0] - vals[:, 1])
    gy = 0.5 * (vals[:, 2] - vals[:, 3])
    return gx, gy
