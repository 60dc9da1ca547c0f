"""Robust statistics: masked medians, MAD scale, Huber/Tukey weights.

Replaces the reference's ``hso::getMedian`` (nth_element,
/root/reference/include/hso/vikit/math_utils.h) and
``robust_cost::{MADScaleEstimator,HuberWeightFunction,TukeyWeightFunction}``
(/root/reference/src/vikit/robust_cost.cpp:65-148) with batched, masked,
static-shape versions: every statistic takes a validity mask so it can run
over padded slot arrays inside jit.
"""

from __future__ import annotations

import jax.numpy as jnp

#: 1 / Phi^-1(3/4) — consistency constant for MAD (robust_cost.cpp:68)
MAD_NORMALIZER = 1.4826


def masked_median(values: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Median of ``values[mask]`` without dynamic shapes.

    Invalid entries are pushed to +inf and a sort-based quantile over the
    valid count is taken (the reference's nth_element median picks element
    ``n/2`` of the sorted array — i.e. the *upper* median — so we do the same
    rather than averaging the middle pair).
    """
    n_valid = jnp.sum(mask.astype(jnp.int32))
    big = jnp.asarray(jnp.inf, dtype=values.dtype)
    sorted_vals = jnp.sort(jnp.where(mask, values, big))
    idx = jnp.clip(n_valid // 2, 0, values.shape[0] - 1)
    med = sorted_vals[idx]
    return jnp.where(n_valid > 0, med, jnp.zeros_like(med))


def masked_median_bisect(values: jnp.ndarray, mask: jnp.ndarray,
                         n_iter: int = 30) -> jnp.ndarray:
    """Masked upper-median by value-range bisection.

    O(n·iters) elementwise passes instead of an on-device sort.  Converges to
    the exact upper-median value within (max-min)/2^n_iter — use where the
    median feeds a robust threshold, not an exact order statistic.
    """
    import jax

    finite = mask & jnp.isfinite(values)
    n_valid = jnp.sum(finite.astype(jnp.int32))
    target = n_valid // 2 + 1          # upper median, 1-based rank
    lo = jnp.min(jnp.where(finite, values, jnp.inf))
    hi = jnp.max(jnp.where(finite, values, -jnp.inf))

    def body(_, c):
        lo_c, hi_c = c
        mid = 0.5 * (lo_c + hi_c)
        cnt = jnp.sum(((values <= mid) & finite).astype(jnp.int32))
        hit = cnt >= target
        return jnp.where(hit, lo_c, mid), jnp.where(hit, mid, hi_c)

    lo, hi = jax.lax.fori_loop(0, n_iter, body, (lo, hi))
    med = 0.5 * (lo + hi)
    return jnp.where(n_valid > 0, med, jnp.zeros_like(med))


def masked_mad_sigma(values: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """1.4826 * median(|v - median(v)|) over the masked entries."""
    med = masked_median(values, mask)
    return MAD_NORMALIZER * masked_median(jnp.abs(values - med), mask)


def mad_scale_of_abs(abs_errors: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """1.4826 * median(|e|) — the reference ``MADScaleEstimator::compute``
    (robust_cost.cpp:67-74), which takes already-absolute errors. Used by the
    pose optimizer; the coarse tracker instead uses :func:`masked_mad_sigma`
    (median + MAD of deviations, CoarseTracker.cpp:615-620)."""
    return MAD_NORMALIZER * masked_median(abs_errors, mask)


def huber_weight(x_over_sigma: jnp.ndarray, k: float = 1.345) -> jnp.ndarray:
    """w(x) = 1 if |x|<k else k/|x| (robust_cost.cpp:141-148)."""
    ax = jnp.abs(x_over_sigma)
    return jnp.where(ax < k, jnp.ones_like(ax), k / jnp.maximum(ax, 1e-12))


def tukey_weight(x_over_sigma: jnp.ndarray, b: float = 4.6851) -> jnp.ndarray:
    """w(x) = (1-(x/b)^2)^2 for |x|<b else 0 (robust_cost.cpp:93-108)."""
    r = x_over_sigma / b
    w = (1.0 - r * r)
    return jnp.where(jnp.abs(x_over_sigma) < b, w * w, jnp.zeros_like(w))
