"""Ablation profile of the REAL fused-step scan: stub out one stage at a
time (at the module-function level, rebuilding the step each time) and
measure the whole-scan ms/frame delta.  Unlike per-stage mini-scans
(profile_stages.py), this measures each stage's marginal cost inside the
actual composed program — scheduling, fusion and op overhead included.

    timeout 580 python scripts/profile_ablate.py
"""

import functools
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import jax

from hso_tpu.utils.jax_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp

import hso_tpu.pipeline.fused_step as fs
from bench import BOOT_NPZ, bench_camera, bench_scene, trajectory
from hso_tpu.config import Config
from hso_tpu.image.pyramid import build_frame_pyramids
from hso_tpu.math import se3np
from hso_tpu.pipeline.frame_handler import FrameHandler
from hso_tpu.utils.checkpoint import load_checkpoint

N_SCAN = 64
N_REP = 3

cam = bench_camera()
cfg = Config()
scene = bench_scene(cam)
vo = FrameHandler(cam, cfg)
load_checkpoint(vo, BOOT_NPZ, resume_stage="default")
start = vo.frame_count
poses = trajectory(start + N_SCAN + 1)
frames = [scene.render(T) for T in poses[start:]]

snap = vo._snapshot()
seeds0 = vo.seeds
last = vo.last_frame
obs0 = vo._prev_obs_dev(last)
T0 = jnp.asarray(last.T_f_w, jnp.float32)
pyr0 = build_frame_pyramids(jnp.asarray(frames[0]))["pyr"]
I_rel = jnp.asarray(se3np.identity(), jnp.float32)
imgs = jnp.asarray(np.stack(frames[1:N_SCAN + 1]))
P = vo.points.p_max

orig = {
    "update_seeds": fs.update_seeds,
    "match_points": fs.match_points,
    "make_coarse_tracker": fs.make_coarse_tracker,
    "optimize_pose": fs.optimize_pose,
    "select_candidates": fs.select_candidates,
    "build_frame_pyramids": fs.build_frame_pyramids,
}

S = int(np.asarray(seeds0["valid"]).shape[0])


def stub_update_seeds(seeds, ring_T, ring_exp, pyr, sx, sy, T, exp, pea, cam,
                      **kw):
    return seeds, {"n_updated": jnp.int32(0),
                   "px_match": jnp.zeros((S, 2), jnp.float32),
                   "matched": jnp.zeros((S,), bool)}


def stub_match_points(cand, pyr, sx, sy, T, exp, cam, **kw):
    n = cand["valid"].shape[0]
    return {"px": jnp.zeros((n, 2), jnp.float32),
            "level": jnp.zeros((n,), jnp.int32),
            "f_cur": jnp.zeros((n, 3), jnp.float32),
            "success": cand["valid"],
            "grad_cur": jnp.zeros((n, 2), jnp.float32)}


def stub_make_tracker(cam, **kw):
    def track(ref_pyr, cur_pyr, px, f, dist, T_init, a_init):
        return {"T_cur_ref": T_init, "exposure_ratio": jnp.float32(a_init),
                "n_tracked": jnp.int32(0)}
    return track


def stub_optimize_pose(T, p_world, f, level, grad, is_edge, is_temp, valid,
                       **kw):
    return {"T_f_w": T, "inlier": valid,
            "err_final_px": jnp.float32(0.0),
            "n_inliers": jnp.sum(valid.astype(jnp.int32))}


def stub_select(pos_w, valid, priority, T, cam, cell=16, grid_h=1, grid_w=1,
                **kw):
    C = grid_h * grid_w
    z = jnp.zeros((C,), jnp.int32)
    return {"cell_point": z, "cell_valid": jnp.zeros((C,), bool),
            "cell_px": jnp.zeros((C, 2), jnp.float32),
            "cell_point2": z, "cell_valid2": jnp.zeros((C,), bool),
            "cell_px2": jnp.zeros((C, 2), jnp.float32),
            "n_projected": jnp.int32(0)}


VARIANTS = [
    ("full", {}),
    ("-update_seeds", {"update_seeds": stub_update_seeds}),
    ("-match_points", {"match_points": stub_match_points}),
    ("-coarse_track", {"make_coarse_tracker": stub_make_tracker}),
    ("-pose_opt", {"optimize_pose": stub_optimize_pose}),
    ("-select", {"select_candidates": stub_select}),
    ("-seeds-match-track-pose", {
        "update_seeds": stub_update_seeds, "match_points": stub_match_points,
        "make_coarse_tracker": stub_make_tracker,
        "optimize_pose": stub_optimize_pose}),
]


def run_variant(patches):
    for k, v in patches.items():
        setattr(fs, k, v)
    try:
        fs.make_frame_step.cache_clear()
        step_fn = vo._fused_step()

        def step(carry, img):
            T_prev, prev_pyr, prev_gm, prev_it, exp_prev, obs, seeds, acc = carry
            out = step_fn(img, prev_pyr, prev_gm, T_prev, obs, prev_it,
                          exp_prev, I_rel, snap, seeds,
                          jnp.float32(vo.px_error_angle), acc)
            d = out["data"]
            carry = (out["T_new"], d["pyr"], d["grad_mean"],
                     d["intensity_mean"], out["exposure"], out["obs_next"],
                     out["seeds"], out["acc"])
            # checksum must consume state that EVERY variant still computes
            # per-frame (stubs can make packed entries loop-constant, letting
            # XLA fold the whole scan away)
            chk = (jnp.sum(out["T_new"]) + jnp.sum(d["grad_mean"])
                   + jnp.sum(out["seeds"]["mu"]) * 1e-9
                   + out["packed"][13] + out["packed"][15])
            return carry, chk

        @jax.jit
        def run(ims, seeds):
            acc0 = jnp.zeros((2, P), jnp.int32)
            carry0 = (T0, pyr0, jnp.float32(10.0), jnp.float32(128.0),
                      jnp.float32(1.0), obs0, seeds, acc0)
            (_, _, _, _, _, _, sf, _), chk = jax.lax.scan(step, carry0, ims)
            return jnp.sum(chk) + jnp.sum(sf["mu"])

        chk = run(imgs, seeds0)
        jax.block_until_ready(chk)
        t0 = time.perf_counter()
        for _ in range(N_REP):
            chk = run(imgs, seeds0)
        jax.block_until_ready(chk)
        return (time.perf_counter() - t0) / N_REP / N_SCAN * 1e3
    finally:
        for k in patches:
            setattr(fs, k, orig[k])
        fs.make_frame_step.cache_clear()


base = None
for name, patches in VARIANTS:
    ms = run_variant(patches)
    if base is None:
        base = ms
        print(f"{name:>26s}: {ms:7.3f} ms/frame")
    else:
        print(f"{name:>26s}: {ms:7.3f} ms/frame  (marginal {base - ms:+.3f})")
