"""Bilinear gather primitives — the single most reused kernel building block.

Every alignment / residual kernel in the reference reduces to bilinear reads
of u8 images at irregular subpixel coordinates (e.g. CoarseTracker.cpp:317-342,
matcher.cpp:165-196).  Here they are flat ``jnp.take`` gathers over the full
image with precomputed linear indices.  All functions are shape-polymorphic
over leading batch dims and clamp coordinates (callers carry validity masks).
"""

from __future__ import annotations

import jax.numpy as jnp


def _gather2d(img: jnp.ndarray, vi: jnp.ndarray, ui: jnp.ndarray) -> jnp.ndarray:
    h, w = img.shape
    vi = jnp.clip(vi, 0, h - 1)
    ui = jnp.clip(ui, 0, w - 1)
    return jnp.take(img.reshape(-1), vi * w + ui, axis=0)


def bilinear(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """I(u, v) with bilinear weights; u along width, v along height."""
    ui = jnp.floor(u).astype(jnp.int32)
    vi = jnp.floor(v).astype(jnp.int32)
    fu = u - ui
    fv = v - vi
    w_tl = (1.0 - fu) * (1.0 - fv)
    w_tr = fu * (1.0 - fv)
    w_bl = (1.0 - fu) * fv
    w_br = fu * fv
    return (
        w_tl * _gather2d(img, vi, ui)
        + w_tr * _gather2d(img, vi, ui + 1)
        + w_bl * _gather2d(img, vi + 1, ui)
        + w_br * _gather2d(img, vi + 1, ui + 1)
    )


def bilinear_with_grad(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """(I, dI/du, dI/dv) at subpixel (u, v).

    Gradients are the bilinear interpolation of central differences — exactly
    the reference's stencil (CoarseTracker.cpp:368-371): e.g.
    dx = 0.5 * (bilerp(I)(u+1, v) - bilerp(I)(u-1, v)).
    """
    val = bilinear(img, u, v)
    dx = 0.5 * (bilinear(img, u + 1.0, v) - bilinear(img, u - 1.0, v))
    dy = 0.5 * (bilinear(img, u, v + 1.0) - bilinear(img, u, v - 1.0))
    return val, dx, dy


def patch_values(
    img: jnp.ndarray, u0: jnp.ndarray, v0: jnp.ndarray, offsets: jnp.ndarray
) -> jnp.ndarray:
    """Bilinear patch gather: centers (N,), pattern ``offsets`` (P, 2) in
    pixels ⇒ values (N, P).  Offset x adds to u, y to v."""
    u = u0[:, None] + offsets[None, :, 0].astype(img.dtype)
    v = v0[:, None] + offsets[None, :, 1].astype(img.dtype)
    return bilinear(img, u, v)


def patch_values_with_grad(
    img: jnp.ndarray, u0: jnp.ndarray, v0: jnp.ndarray, offsets: jnp.ndarray
):
    """As :func:`patch_values` but also (N, P) image gradients."""
    u = u0[:, None] + offsets[None, :, 0].astype(img.dtype)
    v = v0[:, None] + offsets[None, :, 1].astype(img.dtype)
    return bilinear_with_grad(img, u, v)
