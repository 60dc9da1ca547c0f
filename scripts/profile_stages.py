"""Per-stage device-time breakdown of the bench scan step.

Reconstructs the exact state `bench.py` snapshots after its real-pipeline
bootstrap (cached to `.prof_state.pkl` so the slow FrameHandler bootstrap is
paid once), then times each per-frame stage as its OWN `lax.scan` over the
same 64-frame segment — dispatch overhead excluded, per-frame ms reported.

Two-step usage (the bootstrap is built once on the CPU, where its snapshot
values are identical, and reused for the timed run):

    JAX_PLATFORMS=cpu python scripts/profile_stages.py --build  # → .prof_state.pkl
    python scripts/profile_stages.py            # GPU: timed per-stage scans

Stages sum to approximately the full fused step; the residual is fusion win
plus carry plumbing.
"""

import functools
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

from hso_tpu.utils.jax_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp

from hso_tpu.cameras import PinholeCamera
from hso_tpu.config import Config
from hso_tpu.image.pyramid import build_frame_pyramids
from hso_tpu.mapmodel.structures import TYPE_TEMPORARY
from hso_tpu.math import se3, se3np
from hso_tpu.mapping.depth_filter import update_seeds
from hso_tpu.ops.detect import detect_features
from hso_tpu.track.coarse_tracker import make_coarse_tracker
from hso_tpu.track.matcher import match_points, select_candidates
from hso_tpu.track.pose_optimizer import optimize_pose

STATE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     ".prof_state.pkl")
N_BOOT, N_HOST, N_SCAN = 48, 16, 64
N_REPEATS = 3


def to_np(x):
    if isinstance(x, dict):
        return {k: to_np(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_np(v) for v in x)
    if hasattr(x, "dtype"):
        return np.asarray(x)
    return x


def build_state():
    jax.config.update("jax_platforms", "cpu")   # fast untimed bootstrap
    sys.path.insert(0, os.path.dirname(STATE))
    import bench

    cam_args = (640, 480, 400.0, 400.0, 320.0, 240.0)
    cam = PinholeCamera(*cam_args)
    cfg = Config()
    from hso_tpu.utils.synthetic import BoxScene
    from hso_tpu.pipeline.frame_handler import FrameHandler
    import hso_tpu.pipeline.ba_glue as ba_glue

    scene = BoxScene(cam, half_width=2.0, half_height=1.5, depth=4.5,
                     seed=3, stepped_back=True)
    poses = bench.trajectory(N_BOOT + N_HOST + N_SCAN)
    frames = [scene.render(T) for T in poses]

    captured = {}
    orig_ba = ba_glue.local_bundle_adjustment

    def capturing_ba(*args, **kw):
        captured["args"], captured["kw"] = args, kw
        return orig_ba(*args, **kw)

    ba_glue.local_bundle_adjustment = capturing_ba
    vo = FrameHandler(cam, cfg)
    try:
        for k in range(N_BOOT + N_HOST):
            vo.add_image(frames[k], ts=float(k))
    finally:
        ba_glue.local_bundle_adjustment = orig_ba

    pts = vo.points
    last = vo.last_frame
    o = last.obs
    cell, gh, gw = vo._grid
    state = dict(
        cam_args=cam_args,
        frames=np.stack(frames[N_BOOT + N_HOST - 1:]),
        kf_poses=np.asarray(vo.kfs.poses, np.float32),
        kf_exposure=np.asarray(vo.kfs.exposure, np.float32),
        pos_w=np.asarray(pts.positions(vo.kfs.poses), np.float32),
        pt_valid=np.asarray(pts.valid),
        priority=np.asarray(pts.type.astype(np.int32)),
        snap={k: np.asarray(getattr(pts, k)) for k in (
            "patch_win", "patch_anchor", "patch_px", "patch_f", "patch_level",
            "patch_grad", "species", "patch_kf")},
        is_temp=np.asarray(pts.type == TYPE_TEMPORARY),
        seeds=to_np(vo.seeds),
        ring_T=np.asarray(vo._ring_poses(), np.float32),
        ring_exp=np.array([vo.kfs.exposure[i] if i >= 0 else 1.0
                           for i in vo.seed_ring], np.float32),
        px_error_angle=float(vo.px_error_angle),
        grid=(cell, gh, gw),
        obs=to_np(o),
        T0=np.asarray(last.T_f_w, np.float32),
        ba_args=to_np(captured["args"]),
        ba_kw=captured["kw"],
    )
    with open(STATE, "wb") as fh:
        pickle.dump(state, fh)
    return state


def main():
    if "--build" in sys.argv:
        build_state()
        print(f"state written to {STATE}")
        return
    if not os.path.exists(STATE):
        raise SystemExit("run `python scripts/profile_stages.py --build` first")
    with open(STATE, "rb") as fh:
        st = pickle.load(fh)

    cam = PinholeCamera(*st["cam_args"])
    cfg = Config()
    cell, gh, gw = st["grid"]
    C = gh * gw

    kf_poses = jnp.asarray(st["kf_poses"])
    kf_exposure = jnp.asarray(st["kf_exposure"])
    pos_w = jnp.asarray(st["pos_w"])
    pt_valid = jnp.asarray(st["pt_valid"])
    priority = jnp.asarray(st["priority"])
    snap = {k: jnp.asarray(v) for k, v in st["snap"].items()}
    is_temp = jnp.asarray(st["is_temp"])
    seeds0 = {k: jnp.asarray(v) for k, v in st["seeds"].items()}
    ring_T = jnp.asarray(st["ring_T"])
    ring_exp = jnp.asarray(st["ring_exp"])
    px_err_angle = st["px_error_angle"]
    T0 = jnp.asarray(st["T0"])

    o = st["obs"]
    ov = o["valid"] & (o["point_id"] >= 0)
    n0 = min(C, len(ov))

    def fit_c(a):
        a = np.asarray(a)[:n0]
        pad = [(0, C - n0)] + [(0, 0)] * (a.ndim - 1)
        return jnp.asarray(np.pad(a, pad))

    obs0 = {
        "px": fit_c(o["px"]), "f": fit_c(o["f"]), "level": fit_c(o["level"]),
        "grad": fit_c(o["grad"]), "species": fit_c(o["species"]),
        "pid": fit_c(np.where(ov, o["point_id"], 0)[:len(ov)]),
        "valid": fit_c(ov),
    }

    imgs = jnp.asarray(st["frames"][1:])       # the 64 scan frames
    pyr0_np = st["frames"][0]

    tracker = make_coarse_tracker(
        cam, max_level=cfg.klt_max_level, min_level=cfg.klt_min_level + 1,
        n_iter=cfg.coarse_n_iter, inverse=True)

    # precompute stacked pyramids for the stages downstream of stage 1
    pb = jax.jit(lambda im: build_frame_pyramids(im))
    all_data = [jax.tree.map(np.asarray, pb(jnp.asarray(f)))
                for f in st["frames"]]
    n_lv = len(all_data[0]["pyr"])
    pyr_stack = tuple(jnp.asarray(np.stack([d["pyr"][l] for d in all_data[1:]]))
                      for l in range(n_lv))
    sx_stack = tuple(jnp.asarray(np.stack([d["sobel_x"][l] for d in all_data[1:]]))
                     for l in range(3))
    sy_stack = tuple(jnp.asarray(np.stack([d["sobel_y"][l] for d in all_data[1:]]))
                     for l in range(3))
    pyr_prev0 = tuple(jnp.asarray(all_data[0]["pyr"][l]) for l in range(n_lv))

    results = {}

    def timeit(name, fn, *args):
        out = fn(*args)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(N_REPEATS):
            out = fn(*args)
            jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / N_REPEATS / N_SCAN * 1e3
        results[name] = ms
        print(f"{name:>22s}: {ms:8.3f} ms/frame")

    # ---- stage 1: pyramid + sobel ----
    @jax.jit
    def run_pyr(ims):
        def step(carry, img):
            d = build_frame_pyramids(img)
            s = sum(jnp.sum(p) for p in d["pyr"]) + d["grad_mean"]
            return carry + s * 1e-12, None
        return jax.lax.scan(step, jnp.float32(0.0), ims)[0]

    timeit("pyramid+sobel", run_pyr, imgs)

    # ---- stage 2: coarse tracker ----
    @jax.jit
    def run_track(pyrs):
        def step(carry, cur_pyr):
            T_prev, prev_pyr = carry
            p_prev = se3.apply(T_prev, pos_w[obs0["pid"]])
            dist = jnp.where(obs0["valid"] & (p_prev[:, 2] > 1e-5),
                             jnp.linalg.norm(p_prev, axis=-1), -1.0)
            tout = tracker(prev_pyr, cur_pyr, obs0["px"], obs0["f"],
                           dist.astype(jnp.float32),
                           jnp.asarray(se3np.identity(), jnp.float32), 1.0)
            T_cur = se3.mul(tout["T_cur_ref"], T_prev)
            return (T_cur, cur_pyr), T_cur[..., 0, 3]
        (_, _), out = jax.lax.scan(step, (T0, pyr_prev0), pyrs)
        return out

    timeit("coarse_tracker", run_track, pyr_stack)

    # ---- stage 3: candidate selection + gathers ----
    @functools.partial(jax.jit, static_argnums=0)
    def run_select(n):
        def step(carry, _):
            sel = select_candidates(pos_w, pt_valid, priority, T0, cam,
                                    cell=cell, grid_h=gh, grid_w=gw)
            cp = jnp.where(sel["cell_valid"], sel["cell_point"], 0)
            pkf = snap["patch_kf"][cp]
            T_p = kf_poses[pkf]
            p_in_patch = se3.apply(T_p, pos_w[cp])
            s = jnp.sum(p_in_patch) + jnp.sum(snap["patch_win"][cp])
            return carry + s * 1e-12, None
        return jax.lax.scan(step, jnp.float32(0.0), None, length=n)[0]

    timeit("select+gather", run_select, N_SCAN)

    # build the candidate dict once for match/pose stages
    sel = select_candidates(pos_w, pt_valid, priority, T0, cam,
                            cell=cell, grid_h=gh, grid_w=gw)
    cp = jnp.where(sel["cell_valid"], sel["cell_point"], 0)
    pkf = snap["patch_kf"][cp]
    T_p = kf_poses[pkf]
    p_in_patch = se3.apply(T_p, pos_w[cp])
    idist_p = 1.0 / jnp.maximum(jnp.linalg.norm(p_in_patch, axis=-1), 1e-9)
    cand = {
        "host_win": snap["patch_win"][cp],
        "host_anchor": snap["patch_anchor"][cp],
        "host_px": snap["patch_px"][cp],
        "host_f": snap["patch_f"][cp],
        "host_level": snap["patch_level"][cp],
        "grad": snap["patch_grad"][cp],
        "species": snap["species"][cp],
        "idist": idist_p.astype(jnp.float32),
        "T_host_w": T_p,
        "exposure_host": kf_exposure[pkf],
        "valid": sel["cell_valid"],
    }

    # ---- stage 4: batched matching ----
    @jax.jit
    def run_match(pyrs, sxs, sys_):
        def step(carry, inp):
            cur_pyr, sx, sy = inp
            mout = match_points(cand, cur_pyr, sx, sy, T0, 1.0, cam)
            return carry + jnp.sum(mout["px"]) * 1e-12, None
        return jax.lax.scan(step, jnp.float32(0.0), (pyrs, sxs, sys_))[0]

    timeit("match_points", run_match, pyr_stack[:3], sx_stack, sy_stack)

    mout = match_points(cand, tuple(p[0] for p in pyr_stack),
                        tuple(s[0] for s in sx_stack),
                        tuple(s[0] for s in sy_stack), T0, 1.0, cam)
    success = mout["success"] & sel["cell_valid"]

    # ---- stage 5: pose optimizer ----
    @functools.partial(jax.jit, static_argnums=0)
    def run_pose(n):
        def step(carry, _):
            pout = optimize_pose(
                T0, pos_w[cp], mout["f_cur"], mout["level"], mout["grad_cur"],
                snap["species"][cp] == 1, is_temp[cp], success,
                focal=float(cam.focal_mean), reproj_thresh=cfg.poseoptim_thresh)
            return carry + jnp.sum(pout["T_f_w"]) * 1e-12, None
        return jax.lax.scan(step, jnp.float32(0.0), None, length=n)[0]

    timeit("pose_optimizer", run_pose, N_SCAN)

    # ---- stage 6: depth-filter sweep ----
    @jax.jit
    def run_seeds(pyrs, sxs, sys_, seeds):
        def step(seeds, inp):
            cur_pyr, sx, sy = inp
            seeds, sstats = update_seeds(
                seeds, ring_T, ring_exp, cur_pyr, sx, sy, T0, 1.0,
                px_err_angle, cam)
            return seeds, sstats["n_updated"]
        seeds, nu = jax.lax.scan(step, seeds, (pyrs, sxs, sys_))
        return jnp.sum(nu) + jnp.sum(seeds["mu"])

    timeit("update_seeds", run_seeds, pyr_stack[:3], sx_stack, sy_stack, seeds0)

    # ---- stage 7: detection (per-KF, amortised /6 in the bench) ----
    @jax.jit
    def run_detect(pyrs, sxs, sys_):
        def step(carry, inp):
            cur_pyr, sx, sy = inp
            occ = jnp.zeros((-(-cam.height // 32), -(-cam.width // 32)), bool)
            det = detect_features(cur_pyr, sx, sy, jnp.float32(10.0), occ,
                                  n_out=cfg.n_fts_max)
            return carry + jnp.sum(det["score"]) * 1e-12, None
        return jax.lax.scan(step, jnp.float32(0.0), (pyrs, sxs, sys_))[0]

    timeit("detect (per-KF)", run_detect, pyr_stack[:3], sx_stack, sy_stack)

    # ---- stage 8: local BA (per-KF, amortised /6) ----
    from hso_tpu.ba.local_ba import local_bundle_adjustment
    ba_args = [jnp.asarray(a) if isinstance(a, np.ndarray)
               else ({k: jnp.asarray(v) for k, v in a.items()}
                     if isinstance(a, dict) else a)
               for a in st["ba_args"]]
    ba_kw = st["ba_kw"]

    @functools.partial(jax.jit, static_argnums=0)
    def run_ba(n):
        def step(carry, _):
            out = local_bundle_adjustment(*ba_args, **ba_kw)
            return carry + out["chi2_final"] * 1e-12, None
        return jax.lax.scan(step, jnp.float32(0.0), None, length=n)[0]

    timeit("local_ba (per-KF)", run_ba, N_SCAN)

    total = sum(results.values())
    amort = (sum(v for k, v in results.items() if "per-KF" not in k)
             + sum(v for k, v in results.items() if "per-KF" in k) / 6.0)
    print(f"{'SUM (all)':>22s}: {total:8.3f} ms/frame")
    print(f"{'SUM (KF amortised /6)':>22s}: {amort:8.3f} ms/frame "
          f"(= {1e3 / amort:.1f} fps)")


if __name__ == "__main__":
    main()
