"""Closed-form small-matrix ops for batched hot paths.

``jnp.linalg.inv``/``det`` lower to LU factorization loops even for
2×2/3×3 batches; the adjugate forms below are a handful of fused
elementwise ops.
"""

from __future__ import annotations

import jax.numpy as jnp


def solve_spd_small(A: jnp.ndarray, b: jnp.ndarray,
                    eps: float = 1e-12) -> jnp.ndarray:
    """Solve A x = b for a small SPD system (n ≤ ~10) by a trace-time
    unrolled Cholesky + two triangular substitutions.

    ``jnp.linalg.solve`` lowers to a pivoted LU kernel; inside LM iteration
    loops (coarse tracker, pose optimizer) the unrolled form is a few dozen
    fused scalar ops instead.  Damped Gauss-Newton systems are SPD by
    construction; ``eps`` guards rank-deficient-but-positive corners, while
    a genuinely non-positive pivot propagates NaN so the callers' finite
    checks reject the step (the semantics ``jnp.linalg.solve`` had).
    """
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(jnp.where(s <= 0, jnp.nan, jnp.maximum(s, eps)))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    # forward: L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # backward: Lᵀ x = y
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def det2x2(A: jnp.ndarray) -> jnp.ndarray:
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def inv2x2(A: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Batched 2×2 inverse via the adjugate; near-singular inputs produce
    large-but-finite entries (callers gate with their own validity masks)."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    det = a * d - b * c
    det = jnp.where(jnp.abs(det) < eps, eps, det)
    adj = jnp.stack(
        [jnp.stack([d, -b], axis=-1), jnp.stack([-c, a], axis=-1)], axis=-2
    )
    return adj / det[..., None, None]


def inv3x3(A: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Batched 3×3 inverse via the adjugate."""
    m = A
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    det = jnp.where(jnp.abs(det) < eps, eps, det)
    adj = jnp.stack(
        [
            jnp.stack([c00, c10, c20], axis=-1),
            jnp.stack([c01, c11, c21], axis=-1),
            jnp.stack([c02, c12, c22], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]
