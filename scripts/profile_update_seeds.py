"""Bisect update_seeds device time: run chained-prefix variants of the sweep
(each prefix feeds its partial result back into the carry so XLA cannot hoist
anything) and report the marginal cost of each stage."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from hso_tpu.utils.jax_cache import enable_compile_cache

enable_compile_cache()

from hso_tpu.cameras import PinholeCamera
from hso_tpu.math import se3
from hso_tpu.math.linalg_small import inv2x2
from hso_tpu.mapping.depth_filter import HOST_WIN, empty_seeds
from hso_tpu.ops.align import align_mixed, ncc
from hso_tpu.ops.epipolar import (EW, MAX_EPL, epipolar_zmncc_search,
                                  pack_level_windows, triangulate_depth)
from hso_tpu.ops.gatherless import sample_gradient_in_windows
from hso_tpu.ops.warp import (best_search_level, warp_from_stored_windows,
                              warp_matrices)

S = 1536
N = 32
cam = PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)
rng = np.random.default_rng(0)
pyr12 = tuple(jnp.asarray(rng.standard_normal((480 >> l, 640 >> l)) * 40 + 120,
                          jnp.float32) for l in (1, 2))
px = jnp.asarray(np.c_[rng.uniform(40, 600, S), rng.uniform(40, 440, S)], jnp.float32)
f = cam.cam2world(px).astype(jnp.float32)
level = jnp.asarray(rng.integers(0, 3, S), jnp.int32)
species = jnp.asarray(rng.integers(0, 2, S), jnp.int32)
g = rng.standard_normal((S, 2))
g /= np.linalg.norm(g, axis=-1, keepdims=True)
grad = jnp.asarray(g, jnp.float32)
mu0 = jnp.asarray(1.0 / rng.uniform(2, 8, S), jnp.float32)
host_win = jnp.asarray(rng.standard_normal((S, HOST_WIN, HOST_WIN)) * 40 + 120,
                       jnp.float32)
host_anchor = jnp.zeros((S, 2), jnp.int32)
T_cur = jnp.asarray(se3.exp(jnp.asarray([0.05, 0.02, 0.01, 0.005, 0.003, 0.001],
                                        jnp.float32)))
imgs = jnp.asarray(rng.standard_normal((N, 480, 640)) * 40 + 120, jnp.float32)


def sweep(stage, mu, sigma2, img0):
    """Prefix of update_seeds up to `stage`; returns a scalar folding every
    live intermediate so nothing is dead-code-eliminated."""
    pyr = (img0,) + pyr12
    sigma = jnp.sqrt(jnp.maximum(sigma2, 0.0))
    mu_safe = jnp.maximum(mu, 1e-10)
    T_b = jnp.broadcast_to(T_cur, (S, 3, 4))
    p_cur = se3.apply(T_b, f / mu_safe[:, None])
    px_cur0 = cam.world2cam(p_cur)
    visible = (p_cur[:, 2] > 0.0) & cam.is_in_frame(px_cur0, border=8)

    z_inv_min = mu + 2.0 * sigma
    z_inv_max = jnp.maximum(mu - 2.0 * sigma, 1e-8)
    d_close = 1.0 / jnp.maximum(z_inv_min, 1e-10)
    d_prior = 1.0 / mu_safe
    d_far = 1.0 / z_inv_max
    p_close = se3.apply(T_b, f * d_close[:, None])
    p_far = se3.apply(T_b, f * d_far[:, None])
    geom_ok = (p_far[:, 2] > 1e-3) & (d_far > d_close * 0.999)
    px_close0 = cam.world2cam(p_close)
    px_far0 = cam.world2cam(p_far)
    epl0_len = jnp.linalg.norm(px_close0 - px_far0, axis=-1)

    A_cur_ref, _ = warp_matrices(cam, cam, px, f, d_prior, T_b, level)
    search_level = jnp.clip(best_search_level(A_cur_ref, 2), 0, 2)
    for _ in range(2):
        fits = epl0_len * (2.0 ** -search_level.astype(jnp.float32)) <= MAX_EPL
        search_level = jnp.where(fits, search_level, search_level + 1)
    search_level = jnp.clip(search_level, 0, 2)
    A_ref_cur = inv2x2(A_cur_ref)
    A_ref_cur = jnp.where(jnp.isfinite(A_ref_cur), A_ref_cur, 0.0)
    if stage == 0:
        return jnp.sum(A_ref_cur) + jnp.sum(px_far0) + jnp.sum(px_close0)

    ref_border = warp_from_stored_windows(
        host_win, host_anchor, px, level, A_ref_cur, search_level)
    ref_patch = ref_border[:, 1:9, 1:9]
    if stage == 1:
        return jnp.sum(ref_border)

    s_scale = (2.0 ** -search_level.astype(jnp.float32))[:, None]
    px_close_l = px_close0 * s_scale
    px_far_l = px_far0 * s_scale
    epl = px_close_l - px_far_l
    epl_len = jnp.linalg.norm(epl, axis=-1)
    geom_ok &= jnp.isfinite(epl_len) & (epl_len > 1e-6)
    grad_cur = jnp.einsum("nij,nj->ni", A_cur_ref, grad)
    grad_cur = grad_cur / jnp.maximum(
        jnp.linalg.norm(grad_cur, axis=-1, keepdims=True), 1e-9)
    active = visible & geom_ok

    mid = 0.5 * (px_far_l + px_close_l)
    windows, anchors, img_hw = pack_level_windows(
        pyr, search_level, mid[:, 0], mid[:, 1], EW, 3)
    if stage == 2:
        return jnp.sum(windows)

    sr = epipolar_zmncc_search(
        windows, anchors, img_hw, ref_patch, px_far_l, px_close_l, active)
    good = active & sr["ok"] & (sr["score_best"] > 0.5)
    if stage == 3:
        return jnp.sum(sr["px_best"]) + jnp.sum(good)

    if stage == 4:      # (the separate align1d pre-pass was removed)
        return jnp.sum(sr["px_best"]) + jnp.sum(good)

    rm = align_mixed(species != 0, grad_cur, ref_border, sr["px_best"],
                     valid=good, windows=windows, anchors=anchors,
                     img_hw=img_hw)
    score = ncc(ref_patch, rm["cur_patch"])
    if stage == 5:
        return jnp.sum(rm["px"]) + jnp.sum(score)

    gx_c, gy_c = sample_gradient_in_windows(
        windows, anchors[0], anchors[1], rm["px"][:, 0], rm["px"][:, 1])
    px_match0 = rm["px"] / s_scale
    f_cur = cam.cam2world(px_match0)
    z_meas, tri_ok = triangulate_depth(T_b, f, f_cur)
    return jnp.sum(gx_c) + jnp.sum(z_meas)


import functools

STAGES = ["0 geometry+warpmat", "1 +warp_ref_border", "2 +pack_windows",
          "3 +zmncc_search", "4 (removed)", "5 +align_mixed+ncc", "6 +grad+triang"]

prev = 0.0
for stage in range(7):
    @functools.partial(jax.jit, static_argnums=0)
    def run(stg, imgs, mu, sigma2):
        def step(carry, img0):
            mu_c, s2_c = carry
            val = sweep(stg, mu_c, s2_c, img0)
            mu_n = mu_c + val * 1e-20
            return (mu_n, s2_c), val
        (_, _), vals = jax.lax.scan(step, (mu, sigma2), imgs)
        return jnp.sum(vals)

    sigma2 = jnp.full((S,), 0.01, jnp.float32)
    out = run(stage, imgs, mu0, sigma2)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(3):
        out = run(stage, imgs, mu0, sigma2)
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / 3 / N * 1e3
    print(f"{STAGES[stage]:>22s}: {ms:7.3f} ms/frame  (marginal {ms - prev:+7.3f})")
    prev = ms
