"""Micro-profile the individual kernels inside the hot stages.

Times the internal pieces of update_seeds and local_ba with representative
shapes.  All arrays are passed as jit ARGUMENTS: a zero-argument jit bakes
them in as constants, which can be re-uploaded on every call and then
dominates the time of a small kernel.
"""
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hso_tpu.cameras import PinholeCamera
from hso_tpu.math import se3
from hso_tpu.ops.align import align1d, align_mixed, ncc
from hso_tpu.ops.epipolar import EW, epipolar_zmncc_search, pack_level_windows
from hso_tpu.ops.gatherless import sample_gradient_in_windows
from hso_tpu.ops.warp import warp_from_stored_windows, warp_matrices
from hso_tpu.mapping.depth_filter import HOST_WIN

S = 1536
N_SCAN = 64
cam = PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)

rng = np.random.default_rng(0)
pyr = tuple(jnp.asarray(rng.standard_normal((480 >> l, 640 >> l)) * 40 + 120,
                        jnp.float32) for l in range(3))
px = jnp.asarray(np.c_[rng.uniform(40, 600, S), rng.uniform(40, 440, S)], jnp.float32)
f = cam.cam2world(px).astype(jnp.float32)
depth = jnp.asarray(rng.uniform(2.0, 8.0, S), jnp.float32)
level = jnp.asarray(rng.integers(0, 3, S), jnp.int32)
search_level = jnp.asarray(rng.integers(0, 3, S), jnp.int32)
grad = jnp.asarray(rng.standard_normal((S, 2)), jnp.float32)
grad = grad / jnp.linalg.norm(grad, axis=-1, keepdims=True)
species = jnp.asarray(rng.integers(0, 2, S), jnp.int32)
T_cur_ref = jnp.asarray(
    se3.exp(jnp.asarray([0.05, 0.02, 0.01, 0.005, 0.003, 0.001], jnp.float32)))
T_b = jnp.broadcast_to(T_cur_ref, (S, 3, 4))
host_win = jnp.asarray(rng.standard_normal((S, HOST_WIN, HOST_WIN)) * 40 + 120, jnp.float32)
host_anchor = jnp.zeros((S, 2), jnp.int32)
ref_border = jnp.asarray(rng.standard_normal((S, 10, 10)) * 40 + 120, jnp.float32)
valid = jnp.ones((S,), bool)
eye2 = jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32), (S, 2, 2))

results = {}


def timeit(name, body, *args, n_repeat=3, n_scan=N_SCAN):
    """The scan body must CONSUME the carry (perturb the first float-array
    argument) or XLA hoists the whole computation out of the loop."""
    def run(*a):
        def step(c, _):
            a2 = list(a)
            for k, x in enumerate(a2):
                if hasattr(x, "dtype") and x.dtype == jnp.float32 and x.ndim >= 1:
                    a2[k] = x + c * 1e-30
                    break
            return c + body(*a2) * 1e-12, None
        return jax.lax.scan(step, jnp.float32(0.0), None, length=n_scan)[0]

    fn = jax.jit(run)
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n_repeat):
        out = fn(*args)
        jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / n_repeat / n_scan * 1e3
    results[name] = ms
    print(f"{name:>28s}: {ms:8.3f} ms/frame")


# ---- update_seeds internals ----
timeit("warp_matrices", lambda px, f, depth, T_b, level:
       jnp.sum(warp_matrices(cam, cam, px, f, depth, T_b, level)[0]),
       px, f, depth, T_b, level)

timeit("warp_from_stored(44win)", lambda hw, ha, px, lv, e2, sl:
       jnp.sum(warp_from_stored_windows(hw, ha, px, lv, e2, sl)),
       host_win, host_anchor, px, level, eye2, search_level)

timeit("pack_level_windows(48)", lambda pyr, sl, u, v:
       jnp.sum(pack_level_windows(pyr, sl, u, v, EW, 3)[0]),
       pyr, search_level, px[:, 0] * 0.5, px[:, 1] * 0.5)

windows, anchors, img_hw = pack_level_windows(
    pyr, search_level, px[:, 0] * 0.5, px[:, 1] * 0.5, EW, 3)
px_far = px * 0.5
px_close = px_far + 8.0
ref_patch = ref_border[:, 1:9, 1:9]

timeit("epipolar_zmncc_search", lambda w, a0, a1, h0, h1, rp, pf, pc, v:
       jnp.sum(epipolar_zmncc_search(w, (a0, a1), (h0, h1), rp, pf, pc, v)["px_best"]),
       windows, anchors[0], anchors[1], img_hw[0], img_hw[1],
       ref_patch, px_far, px_close, valid)

timeit("align1d(6it,48win)", lambda g, rb, pi, v, w, a0, a1, h0, h1:
       jnp.sum(align1d(None, g, rb, pi, valid=v, windows=w, anchors=(a0, a1),
                       img_hw=(h0, h1), n_iter=6)["px"]),
       grad, ref_border, px_far, valid, windows, anchors[0], anchors[1],
       img_hw[0], img_hw[1])

timeit("align_mixed(10it,48win)", lambda ie, g, rb, pi, v, w, a0, a1, h0, h1:
       jnp.sum(align_mixed(ie, g, rb, pi, valid=v, windows=w, anchors=(a0, a1),
                           img_hw=(h0, h1))["px"]),
       species == 1, grad, ref_border, px_far, valid, windows,
       anchors[0], anchors[1], img_hw[0], img_hw[1])

timeit("sample_grad_in_windows", lambda w, a0, a1, u, v:
       jnp.sum(sample_gradient_in_windows(w, a0, a1, u, v)[0]),
       windows, anchors[0], anchors[1], px_far[:, 0], px_far[:, 1])

timeit("ncc", lambda a, b: jnp.sum(ncc(a, b)), ref_patch, ref_patch + 1.0)

# ---- full update_seeds ----
from hso_tpu.mapping.depth_filter import empty_seeds, update_seeds

seeds = empty_seeds(S)
seeds["valid"] = jnp.ones((S,), bool)
seeds["px"] = px
seeds["f"] = f
seeds["level"] = level
seeds["species"] = species
seeds["grad"] = grad
seeds["mu"] = 1.0 / depth
seeds["sigma2"] = jnp.full((S,), 0.01, jnp.float32)
seeds["z_range"] = jnp.full((S,), 1.0, jnp.float32)
seeds["converge_thresh"] = jnp.full((S,), 200.0, jnp.float32)
seeds["host_win"] = host_win
seeds["host_anchor"] = host_anchor
ring_T = jnp.broadcast_to(jnp.asarray(se3.identity() if hasattr(se3, "identity")
                                      else np.eye(3, 4, dtype=np.float32)), (8, 3, 4))
ring_T = jnp.zeros((8, 3, 4), jnp.float32) + jnp.eye(3, 4, dtype=jnp.float32)
ring_exp = jnp.ones((8,), jnp.float32)

timeit("update_seeds FULL", lambda sd, rT, rE, p0, p1, p2, sx0, sx1, sx2, T:
       jnp.sum(update_seeds(sd, rT, rE, (p0, p1, p2), (sx0, sx1, sx2),
                            (sx0, sx1, sx2), T, 1.0, 0.002, cam)[1]["n_updated"]),
       seeds, ring_T, ring_exp, pyr[0], pyr[1], pyr[2],
       pyr[0] * 0.1, pyr[1] * 0.1, pyr[2] * 0.1, jnp.asarray(T_cur_ref))

# ---- BA internals ----
import pickle
with open(os.path.join(ROOT, ".prof_state.pkl"), "rb") as fh:
    st = pickle.load(fh)
ba_args = [jnp.asarray(a) if isinstance(a, np.ndarray)
           else ({k: jnp.asarray(v) for k, v in a.items()}
                 if isinstance(a, dict) else a)
           for a in st["ba_args"]]
ba_kw = st["ba_kw"]
T_kf, free_kf, idist, point_valid, obs = ba_args[:5]
print(f"  [BA problem: K={T_kf.shape[0]} P={idist.shape[0]} "
      f"E={obs['valid'].shape[0]} n_valid_obs={int(np.asarray(obs['valid']).sum())}]")

from hso_tpu.ba.local_ba import (
    build_reduced_system, _schur_solve, local_bundle_adjustment,
    residuals_and_jacobians)

deltas = (jnp.float32(0.005), jnp.float32(0.003))

timeit("ba.resid+jac", lambda T, i, o:
       jnp.sum(residuals_and_jacobians(T, i, o)[0]), T_kf, idist, obs)

K_ = T_kf.shape[0]
P_ = idist.shape[0]
timeit("ba.build_reduced_system", lambda T, i, o, d0, d1:
       build_reduced_system(T, i, o, (d0, d1), K_, P_)["chi2"],
       T_kf, idist, obs, deltas[0], deltas[1])

sys0 = build_reduced_system(T_kf, idist, obs, deltas, K_, P_)

timeit("ba.schur_solve", lambda s, fk:
       jnp.sum(_schur_solve(s, fk, jnp.float32(1e-4), K_)[0]), sys0, free_kf)

timeit("ba.full", lambda *a: local_bundle_adjustment(
    a[0], a[1], a[2], a[3], a[4], **ba_kw)["chi2_final"],
    *ba_args, n_repeat=2, n_scan=8)
