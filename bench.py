"""Benchmark: whole-pipeline per-frame throughput on one GPU.

Headline metric ``pipeline_frames_per_s``: the FULL per-frame tracking path —
image pyramid + Sobel construction, coarse-to-fine 7-DoF photometric
alignment, map reprojection into the cell grid, batched direct feature
matching, motion-only reprojection pose LM, and the complete depth-filter
seed sweep — plus keyframe-amortised work (hybrid feature detection and a
windowed Schur bundle adjustment, executed every KF_EVERY-th frame via
``lax.cond``, the pipeline's realistic keyframe rate).  This mirrors the fps
the reference prints, which is whole-pipeline
(/root/reference/src/frame_handler_base.cpp:121-127).

Honesty protocol:
  * the map (point table, memoized patch sources, depth-filter seed state)
    is built by running the REAL FrameHandler over a bootstrap segment — no
    oracle depths anywhere.  The bootstrap state is committed as
    ``artifacts/bench_boot.npz`` (produced by ``python bench.py --regen``,
    which runs the live bootstrap and snapshots it at a keyframe event) so
    the bench itself resumes in seconds instead of re-running ~50 frames
    through the host loop each run;
  * the windowed Schur BA in the timed scan is LIVE: a dense (P, KW)
    observation ring grid rides in the scan carry, every keyframe step
    registers its own inlier matches into its ring column, the last-KW
    window (oldest rows gauge-fixed) is solved with the real solver
    (hso_tpu/ba/local_ba.py), and the solution writes BACK into the carry —
    keyframe poses, inverse distances, re-anchored world positions, and
    outlier-stripped observations all feed subsequent frames.
    (``artifacts/bench_ba.npz`` remains the captured problem used by the
    multichip dryrun and scripts/dryrun_multiproc.sh);
  * the timed segment is a single ``lax.scan`` whose step calls THE SAME
    fused per-frame function the live pipeline dispatches
    (``FrameHandler._fused_step`` → hso_tpu/pipeline/fused_step.py), with
    pose/pyramid/obs/seed state feeding forward through the carry: one
    dispatch and one host sync per N_SCAN frames, so the figure is the
    device path's rate on a GPU attached to its host;
  * the MAP EVOLVES inside the timed scan: keyframe steps run hybrid
    feature detection (feeding depth-filter seed init), update the keyframe
    pose registry and seed-host ring, harvest converged seeds and ACTIVATE
    them on-device into a reserved point-table region (they become
    matchable on subsequent frames), and solve + write back the LIVE
    windowed BA (previous bullet).  Remaining host-only residual vs
    ``add_image``: the success/fail-driven TEMPORARY point lifecycle,
    which runs at keyframe cadence in the live loop;
  * the scan trajectory is checked against ground truth with scale-aligned
    ATE — if the RMSE gate fails, the bench prints ``"value": null`` and
    exits nonzero: a broken tracking loop cannot report a garbage-fast
    number;
  * ``host_loop_frames_per_s`` (secondary, in the same JSON line) times the
    real ``FrameHandler.add_image`` host loop including all per-frame host
    bookkeeping and the one per-frame device sync;
  * it measures only on a GPU: another platform is refused unless ``--cpu``
    asks for a rehearsal, and the JSON names the device and the card's
    power limit.

Baseline: ``vs_baseline`` divides by the measured-on-this-machine CPU anchor
in BASELINE.md (see scripts/baseline_cpu_microbench.py); falls back to the
documented 40 fps estimate if the anchor file is absent.

Prints exactly one JSON line on stdout.
"""

import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np

import jax
import jax.numpy as jnp

from hso_tpu.cameras import PinholeCamera
from hso_tpu.config import Config
from hso_tpu.math import se3np
from hso_tpu.ops.detect import detect_features
from hso_tpu.pipeline.frame_handler import SEED_RING, FrameHandler
from hso_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from hso_tpu.utils.device import device_report
from hso_tpu.utils.evaluate import ate
from hso_tpu.utils.jax_cache import enable_compile_cache
from hso_tpu.utils.synthetic import BoxScene

REFERENCE_CPU_FPS_FALLBACK = 40.0  # used only if BASELINE_CPU.json is absent
N_BOOT = 48                       # untimed real-pipeline bootstrap frames (regen)
N_HOST = 16                       # frames timed through the host loop
N_SCAN = 192                      # frames timed through the fused scan,
                                  # one dispatch and one sync for all of them
N_REPEATS = 2
KF_EVERY = 6                      # amortised keyframe-work cadence

BOOT_NPZ = os.path.join(ROOT, "artifacts", "bench_boot.npz")
BA_NPZ = os.path.join(ROOT, "artifacts", "bench_ba.npz")
CPU_ANCHOR = os.path.join(ROOT, "BASELINE_CPU.json")

_T0 = time.perf_counter()


def _phase(msg: str) -> None:
    print(f"[bench {time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr)


def bench_camera() -> PinholeCamera:
    return PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)


def bench_scene(cam) -> BoxScene:
    return BoxScene(cam, half_width=2.0, half_height=1.5, depth=4.5,
                    seed=3, stepped_back=True)


def trajectory(n):
    """Brisk oscillating sweep inside the box (same family as the e2e tests:
    enough parallax to bootstrap, bounded net motion so the map stays in
    view over the steady-state segment)."""
    poses = []
    for k in range(n):
        t = k / 18.0
        xi = np.r_[0.8 * np.sin(0.8 * t), 0.12 * np.sin(0.5 * t), 0.10 * np.sin(0.35 * t),
                   0.02 * np.sin(0.9 * t), -0.05 * np.sin(0.6 * t), 0.02 * np.sin(0.4 * t)]
        poses.append(se3np.exp(xi))
    return poses


def reference_cpu_fps() -> tuple[float, list, str]:
    if os.path.exists(CPU_ANCHOR):
        with open(CPU_ANCHOR) as f:
            anchor = json.load(f)
        return (float(anchor["reference_cpu_fps"]),
                anchor.get("reference_cpu_fps_range"),
                "measured hot-loop anchor on this CPU "
                "(BASELINE_CPU.json; reference-favoring upper bound => "
                "speedup is a lower bound)")
    return (REFERENCE_CPU_FPS_FALLBACK, None,
            "40 fps literature estimate (no anchor file)")


# ---------------------------------------------------------------- BA capture
def save_ba_problem(path, args, kw) -> None:
    T_kf, free, idist, pvalid, obs = args
    blobs = {
        "T_kf": np.asarray(T_kf), "free": np.asarray(free),
        "idist": np.asarray(idist), "pvalid": np.asarray(pvalid),
        "kw_json": np.frombuffer(json.dumps(kw).encode(), np.uint8),
    }
    for k, v in obs.items():
        blobs["obs_" + k] = np.asarray(v)
    np.savez(path, **blobs)


def load_ba_problem(path):
    z = np.load(path)
    obs = {k[4:]: jnp.asarray(z[k]) for k in z.files if k.startswith("obs_")}
    kw = json.loads(bytes(z["kw_json"]).decode())
    args = (jnp.asarray(z["T_kf"]), jnp.asarray(z["free"]),
            jnp.asarray(z["idist"]), jnp.asarray(z["pvalid"]), obs)
    return args, kw


class _BACapture:
    """Context manager: record the (args, kwargs) of the latest windowed-BA
    call the live pipeline makes, and count the calls, while still running
    the real solver."""

    def __init__(self):
        self.args = None
        self.kw = None
        self.n = 0

    def __enter__(self):
        import hso_tpu.pipeline.ba_glue as ba_glue

        self._mod = ba_glue
        self._orig = ba_glue.solve_capture

        def capturing(args, kw):
            self.args, self.kw = args, kw
            self.n += 1

        ba_glue.solve_capture = capturing
        return self

    def __exit__(self, *exc):
        self._mod.solve_capture = self._orig
        return False


# ---------------------------------------------------------------- bootstrap
def bootstrap_live(cam, cfg, scene, save: bool) -> FrameHandler:
    """Run the real pipeline over the bootstrap segment and (optionally)
    snapshot its state at the first keyframe event past N_BOOT frames."""
    poses = trajectory(N_BOOT + 25)
    vo = FrameHandler(cam, cfg)
    with _BACapture() as cap:
        for k in range(N_BOOT):
            vo.add_image(scene.render(poses[k]), ts=float(k))
        # continue to the next keyframe event so the snapshot's last_frame
        # is a keyframe with a stored pyramid (resume_stage="default" needs it)
        for k in range(N_BOOT, N_BOOT + 25):
            res = vo.add_image(scene.render(poses[k]), ts=float(k))
            if res.status == "keyframe":
                break
    n_pts = int(vo.points.valid.sum())
    assert vo.stage == "default" and n_pts > 50, (
        f"bootstrap failed: stage={vo.stage} n_pts={n_pts}")
    assert cap.args is not None, "pipeline never ran BA during bootstrap"
    if save:
        os.makedirs(os.path.dirname(BOOT_NPZ), exist_ok=True)
        save_checkpoint(vo, BOOT_NPZ)
        save_ba_problem(BA_NPZ, cap.args, cap.kw)
        _phase(f"snapshot saved: frame {vo.frame_count}, {n_pts} points "
               f"({os.path.getsize(BOOT_NPZ) // 2**20} MiB)")
    return vo


def require_gpu(allow_cpu: bool) -> dict:
    """Refuse to measure anywhere but a GPU (``allow_cpu`` is for a CPU
    rehearsal, whose numbers are not device metrics)."""
    dev = device_report()
    if dev["platform"] != "gpu" and not allow_cpu:
        print(f"bench: JAX found platform {dev['platform']!r} "
              f"({dev['kind']}), not a GPU; pass --cpu for a CPU rehearsal",
              file=sys.stderr)
        sys.exit(2)
    return dev


def resume(cam, cfg, scene, regen: bool = False) -> FrameHandler:
    """The bench's map state: the committed bootstrap snapshot, or (with
    ``regen``) a live bootstrap that rewrites it."""
    if os.path.exists(BOOT_NPZ) and not regen:
        vo = FrameHandler(cam, cfg)
        load_checkpoint(vo, BOOT_NPZ, resume_stage="default")
        assert vo.stage == "default" and int(vo.points.valid.sum()) > 50
        _phase(f"bootstrap state resumed at frame {vo.frame_count} "
               f"({int(vo.points.valid.sum())} points)")
        return vo
    vo = bootstrap_live(cam, cfg, scene, save=True)
    _phase("live bootstrap done")
    return vo


def host_loop(vo, scene, n_warm_max: int = 20) -> float:
    """Time the real ``FrameHandler`` host loop over N_HOST frames, after
    warming through the first THREE keyframe events (one-time executable
    loads for detection, BA and seed harvest/init fire lazily across the
    first few keyframes).  Returns frames/s."""
    start = vo.frame_count
    poses = trajectory(start + n_warm_max + N_HOST)
    frames = [scene.render(T) for T in poses[start:]]
    k = 0
    nkf = 0
    while k < n_warm_max:
        res = vo.add_image(frames[k], ts=float(start + k))
        k += 1
        if res.status == "keyframe":
            nkf += 1
            if nkf >= 3 and k >= 2:
                break
    _phase(f"host loop warm ({k} frames, {nkf} keyframes)")
    t0 = time.perf_counter()
    for j in range(k, k + N_HOST):
        vo.add_image_pipelined(frames[j], ts=float(start + j))
    vo.flush()
    host_fps = N_HOST / (time.perf_counter() - t0)
    assert vo.stage == "default", f"host loop lost tracking: {vo.stage}"
    _phase(f"host loop timed: {host_fps:.2f} fps")
    return host_fps


def scan(vo, cam, cfg, scene) -> dict:
    """Time the fused evolving-map scan over the N_SCAN frames that follow
    ``vo``'s last frame.  Returns dict(fps, compile_s, ate_rmse_m,
    peak_bytes) — ``peak_bytes`` is None where the device keeps no memory
    statistics."""
    start = vo.frame_count
    poses = trajectory(start + N_SCAN)
    frames = [scene.render(T) for T in poses[start:]]
    _phase(f"{len(frames)} scan frames rendered")

    from hso_tpu.ba.local_ba import local_bundle_adjustment
    from hso_tpu.image.pyramid import build_frame_pyramids
    from hso_tpu.math import se3
    from hso_tpu.mapping.depth_filter import harvest_and_prune, init_seeds
    from hso_tpu.ops.detect import occupancy_grid

    # ---- snapshot the live map state for the steady-state scan.  The scan
    # step IS the pipeline's fused per-frame step (FrameHandler._fused_step /
    # hso_tpu/pipeline/fused_step.py) — the bench cannot diverge from what
    # add_image dispatches ----
    snap = vo._snapshot()
    step_fn = vo._fused_step()
    seeds0 = vo.seeds
    px_err_angle = vo.px_error_angle

    last = vo.last_frame
    obs0 = vo._prev_obs_dev(last)
    T0 = jnp.asarray(last.T_f_w, jnp.float32)
    pyr0 = build_frame_pyramids(
        jnp.asarray(scene.render(poses[start - 1])))["pyr"]
    gm0 = jnp.float32(last.grad_mean)
    it0 = jnp.float32(last.intensity_mean)
    exp0 = jnp.float32(last.exposure)
    I_rel = jnp.asarray(se3np.identity(), jnp.float32)

    scan_imgs = jnp.asarray(np.stack(frames))
    kf_sched = jnp.asarray((np.arange(N_SCAN) % KF_EVERY) == KF_EVERY - 1)

    # ---- EVOLVING-MAP scan: the map state (point tables, keyframe pose
    # registry, seed-host ring, seeds) lives in the scan CARRY and keyframe
    # steps mutate it on device — detection feeds seed init, the seed
    # harvest ACTIVATES converged seeds into a reserved point-table region
    # (they become matchable CANDIDATEs on subsequent frames), the pose
    # registry and ring grow, and the windowed Schur BA solves the captured
    # covisibility problem.  Host-side-only work (BA window assembly /
    # pose writeback, TEMPORARY-point lifecycle) is the documented residual
    # difference from add_image. ----
    R_RES = 512        # reserved slots for in-scan activations (ring)
    R_ACT = 64         # activation cap per keyframe
    P0 = vo.points.p_max
    P_T = P0 + R_RES + 1                    # +1 trash row absorbs masked writes
    TRASH = P_T - 1
    S_SEEDS = int(np.asarray(vo.seeds["valid"]).shape[0])
    kf0 = len(vo.kfs.frames)
    batch0 = vo.batch_counter
    TYPE_CAND_VALID = 8 + 2                 # pack_light(CANDIDATE, valid)
    KW = int(cfg.n_kfs_window)              # live-BA sliding window (ring)
    N_FIX_GAUGE = 4                         # oldest window kfs held fixed
    P_BA = 2048                             # compacted BA point slots (=
                                            # cfg.n_points_ba_max; live rows
                                            # + activation ring fit with 2x
                                            # headroom)

    def padP(a, fill=0.0):
        pad = [(0, P_T - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, pad, constant_values=fill)

    MUT_KEYS = ("light", "pos_w", "pt_pack", "species")

    def _initial_obs_grid():
        """Seed the scan's dense (P, KW, 7) packed BA observation grid
        ([meas_u, meas_v, grad_u, grad_v, edgelet, level, valid]) from the
        live pipeline's registered keyframe observations (the last KW
        keyframes, column = global kf index mod KW) — the first in-scan BA
        solves the same covisibility window add_image would."""
        pack = np.zeros((P_T, KW, 7), np.float32)
        for kf in vo.kfs.frames[-KW:]:
            c = kf.kf_index % KW
            o = kf.obs
            sel = o["valid"] & (o["point_id"] >= 0)
            pid = o["point_id"][sel]
            f = o["f"][sel]
            pack[pid, c, 0:2] = f[:, :2] / np.maximum(f[:, 2:3], 1e-9)
            pack[pid, c, 2:4] = o["grad"][sel]
            pack[pid, c, 4] = o["species"][sel] == 1
            pack[pid, c, 5] = o["level"][sel]
            pack[pid, c, 6] = 1.0
        return pack

    def make_state0(snap):
        st = {k: padP(snap[k]) for k in MUT_KEYS}
        st["kf_poses"] = snap["kf_poses"]
        st["kf_exposure"] = snap["kf_exposure"]
        st["ring_T"] = snap["ring_T"]
        st["ring_exp"] = snap["ring_exp"]
        st["ring_kf"] = jnp.asarray(vo.seed_ring.astype(np.int32))
        st["kf_count"] = jnp.int32(kf0)
        st["batch"] = jnp.int32(batch0)
        st["cursor"] = jnp.int32(0)
        # live-BA state: host anchoring + inverse distances + obs grid
        pts = vo.points
        st["f_host"] = padP(jnp.asarray(pts.host_f.astype(np.float32)))
        st["host_kf"] = padP(jnp.asarray(pts.host_kf.astype(np.int32)),
                             fill=-1)
        st["idist"] = padP(jnp.asarray(pts.idist.astype(np.float32)))
        st["ba_pack"] = jnp.asarray(_initial_obs_grid())
        return st

    def step(carry, inp):
        img, is_kf = inp
        (T_prev, prev_pyr, prev_gm, prev_it, exp_prev, obs, seeds, acc,
         st) = carry
        snap_t = {k: st[k] for k in MUT_KEYS + (
            "kf_poses", "kf_exposure", "ring_T", "ring_exp")}
        out = step_fn(img, prev_pyr, prev_gm, T_prev, obs, prev_it, exp_prev,
                      I_rel, snap_t, seeds, jnp.float32(px_err_angle), acc)
        data = out["data"]

        def kf_work(args):
            st, seeds = args
            st = dict(st)
            kf_idx = st["kf_count"]
            slot = jnp.mod(st["batch"], SEED_RING)
            st["kf_poses"] = st["kf_poses"].at[kf_idx].set(out["T_new"])
            st["kf_exposure"] = st["kf_exposure"].at[kf_idx].set(out["exposure"])
            st["ring_T"] = st["ring_T"].at[slot].set(out["T_new"])
            st["ring_exp"] = st["ring_exp"].at[slot].set(out["exposure"])
            st["ring_kf"] = st["ring_kf"].at[slot].set(kf_idx)

            # ---- LIVE windowed Schur BA on the scan's own evolving state
            # (ba::LocalBundleAdjustment on the live window,
            # /root/reference/src/bundle_adjustment.cpp:556-897).
            # 1. register this keyframe's observations into the dense
            #    (P, KW) ring grid (column = kf index mod KW; registering
            #    evicts the column of the keyframe that left the window)
            col = jnp.mod(kf_idx, KW)
            ok_slot = out["success"] & out["inlier"]
            pid = jnp.where(ok_slot, out["cid"], TRASH)
            f_c = out["f_cur"]
            meas = f_c[:, :2] / jnp.maximum(f_c[:, 2:3], 1e-9)
            row = jnp.concatenate([
                meas, out["grad_cur"],
                (out["species"] == 1).astype(jnp.float32)[:, None],
                out["level"].astype(jnp.float32)[:, None],
                ok_slot.astype(jnp.float32)[:, None]], axis=1)
            st["ba_pack"] = (st["ba_pack"].at[:, col].set(0.0)
                             .at[pid, col].set(row)
                             .at[TRASH].set(0.0))
            # 2. assemble the window: the last KW keyframes, laid out by
            #    their ring column; the oldest N_FIX_GAUGE (and kf 0) are
            #    held fixed (the fixation-horizon gauge anchor,
            #    bundle_adjustment.cpp:595-598)
            base = kf_idx + 1 - KW
            g_col = base + jnp.mod(jnp.arange(KW) - base, KW)
            col_live = g_col >= 0
            T_win = st["kf_poses"][jnp.clip(g_col, 0, None)]
            free = col_live & (g_col != 0) & (g_col >= base + N_FIX_GAUGE)
            pt_valid = st["light"] >= 8
            host_in = (st["host_kf"] >= jnp.maximum(base, 0)) & (
                st["host_kf"] <= kf_idx)
            host_slot = jnp.mod(jnp.clip(st["host_kf"], 0, None), KW)
            pvalid = pt_valid & host_in
            obs_valid = ((st["ba_pack"][..., 6] > 0.5) & col_live[None, :]
                         & pvalid[:, None]
                         & (jnp.arange(KW)[None, :] != host_slot[:, None]))
            # compact the problem to the windowed rows before solving: the
            # full table is 4.6k slots but only ~0.5-1k are hosted in the
            # window with observations — the solver's per-iteration cost
            # scales with the (P, K) grid, so gather the live rows into a
            # P_BA-slot problem and scatter the solution back (capacity
            # P_BA >= live points + the activation ring, never exceeded)
            has_obs = jnp.any((st["ba_pack"][..., 6] > 0.5)
                              & col_live[None, :], axis=1)
            cand_b = pvalid & has_obs
            _, rows_b = jax.lax.top_k(
                jnp.where(cand_b, P_T - jnp.arange(P_T), 0), P_BA)
            pv_b = cand_b[rows_b]
            pk_b = st["ba_pack"][rows_b]
            obs_b = {"meas": pk_b[..., 0:2],
                     "grad": pk_b[..., 2:4],
                     "is_edgelet": pk_b[..., 4] > 0.5,
                     "level": pk_b[..., 5].astype(jnp.int32),
                     "valid": obs_valid[rows_b],
                     "f_host": st["f_host"][rows_b],
                     "host": host_slot[rows_b]}
            ba = local_bundle_adjustment(
                T_win, free, st["idist"][rows_b], pv_b, obs_b, n_kf=KW,
                n_pts=P_BA, n_iter=int(cfg.loba_num_iter),
                focal=float(cam.focal_mean))
            # 3. write back: window keyframe poses, inverse distances, the
            #    re-anchored world positions, and outlier-stripped obs
            st["kf_poses"] = st["kf_poses"].at[jnp.clip(g_col, 0, None)].set(
                jnp.where((col_live & free)[:, None, None], ba["T_kf"], T_win))
            id_ok_b = pv_b & (ba["idist"] > 1e-10)
            tgt_b = jnp.where(id_ok_b, rows_b, TRASH)
            st["idist"] = st["idist"].at[tgt_b].set(
                jnp.where(id_ok_b, ba["idist"], st["idist"][rows_b]))
            keep_b = (pk_b[..., 6] > 0.5) & (ba["obs_inlier"] | ~obs_b["valid"])
            st["ba_pack"] = st["ba_pack"].at[tgt_b, :, 6].set(
                keep_b.astype(jnp.float32)).at[TRASH].set(0.0)
            id_ok = jnp.zeros((P_T,), bool).at[tgt_b].set(id_ok_b)
            id_ok = id_ok.at[TRASH].set(False)
            T_h = st["kf_poses"][jnp.clip(st["host_kf"], 0, None)]
            pos_ba = se3.apply(
                se3.inv(T_h),
                st["f_host"] / jnp.maximum(st["idist"], 1e-9)[:, None])
            st["pos_w"] = jnp.where(id_ok[:, None],
                                    pos_ba.astype(jnp.float32), st["pos_w"])

            # seed harvest + device-side activation of converged seeds
            seeds_w = seeds  # windows needed for activation below
            seeds2, bundle = harvest_and_prune(
                seeds, st["batch"], st["ring_T"], cfg.max_seed_kf_batches,
                4.0, float(cam.focal_mean))
            conv = bundle[:, 0] > 0.5
            _, rows = jax.lax.top_k(
                jnp.where(conv, S_SEEDS - jnp.arange(S_SEEDS), 0), R_ACT)
            taken = conv[rows]
            b_r = bundle[rows]
            host_slot = b_r[:, 2].astype(jnp.int32)
            mu = jnp.maximum(b_r[:, 12], 1e-9)
            f_s = b_r[:, 5:8]
            T_h = st["ring_T"][host_slot]
            pos_new = se3.apply(se3.inv(T_h), f_s / mu[:, None])
            off = jnp.cumsum(taken.astype(jnp.int32)) - 1
            tgt = jnp.where(taken,
                            P0 + jnp.mod(st["cursor"] + off, R_RES), TRASH)
            st["pos_w"] = st["pos_w"].at[tgt].set(pos_new.astype(jnp.float32))
            st["light"] = st["light"].at[tgt].set(TYPE_CAND_VALID)
            # live-BA anchoring of the activated point (host bearing /
            # keyframe / inverse distance)
            st["f_host"] = st["f_host"].at[tgt].set(f_s.astype(jnp.float32))
            st["host_kf"] = st["host_kf"].at[tgt].set(
                jnp.where(taken, st["ring_kf"][host_slot], -1))
            st["idist"] = st["idist"].at[tgt].set(mu.astype(jnp.float32))
            hw = seeds_w["host_win"].shape[-1]
            c0 = (hw - 24) // 2
            new_rows = jnp.concatenate([
                seeds_w["host_win"][rows, c0:c0 + 24, c0:c0 + 24]
                .reshape(R_ACT, -1),
                b_r[:, 3:5],                                     # px
                f_s,                                             # f
                (seeds_w["host_anchor"][rows] + c0).astype(jnp.float32),
                b_r[:, 8:9],                                     # level
                b_r[:, 10:12],                                   # grad
                b_r[:, 9:10],                                    # species
                st["ring_kf"][host_slot][:, None].astype(jnp.float32),
            ], axis=1)
            st["pt_pack"] = st["pt_pack"].at[tgt].set(new_rows)
            st["species"] = st["species"].at[tgt].set(
                b_r[:, 9].astype(st["species"].dtype))
            st["cursor"] = jnp.mod(
                st["cursor"] + jnp.sum(taken.astype(jnp.int32)), R_RES)

            # detection (occupancy = this frame's inlier matches) → new seeds
            occ = occupancy_grid(out["px"], out["inlier"],
                                 cam.height, cam.width, 32)
            det = detect_features(data["pyr"][:3], data["sobel_x"],
                                  data["sobel_y"], data["grad_mean"], occ,
                                  n_out=cfg.n_fts_max)
            f_det = cam.cam2world(det["px"]).astype(jnp.float32)
            seeds3 = init_seeds(
                seeds2, det, data["pyr"], f_det, slot, st["batch"] + 1,
                out["depth_mean"], 0.5 * jnp.maximum(out["depth_min"], 1e-3),
                cfg.seed_converge_sigma2_thresh)

            st["kf_count"] = kf_idx + 1
            st["batch"] = st["batch"] + 1
            chk = (jnp.sum(det["score"]) + ba["chi2_final"]
                   + jnp.sum(taken.astype(jnp.float32))).astype(jnp.float32)
            return st, seeds3, chk

        def no_kf(args):
            st, seeds = args
            return st, seeds, jnp.float32(0.0)

        st, seeds_new, kf_chk = jax.lax.cond(
            is_kf, kf_work, no_kf, (st, out["seeds"]))

        chk = (kf_chk + out["n_seeds_updated"].astype(jnp.float32)
               + out["n_matches"].astype(jnp.float32) + out["err_px"])
        carry = (out["T_new"], data["pyr"], data["grad_mean"],
                 data["intensity_mean"], out["exposure"], out["obs_next"],
                 seeds_new, out["acc"], st)
        return carry, (out["T_new"], chk)

    @jax.jit
    def run(imgs, seeds, snap):
        acc0 = jnp.zeros((2, P_T), jnp.int32)
        st0 = make_state0(snap)
        carry0 = (T0, pyr0, gm0, it0, exp0, obs0, seeds, acc0, st0)
        (_, _, _, _, _, _, seeds_fin, _, st_fin), (traj, chk) = jax.lax.scan(
            step, carry0, (imgs, kf_sched))
        # consume all stage outputs so XLA cannot dead-code-eliminate them
        return traj, (jnp.sum(chk) + jnp.sum(seeds_fin["mu"])
                      + jnp.sum(st_fin["pos_w"]) * 1e-9
                      + st_fin["cursor"].astype(jnp.float32))

    _phase("scan inputs staged")
    t0 = time.perf_counter()
    run_c = run.lower(scan_imgs, seeds0, snap).compile()
    compile_s = time.perf_counter() - t0
    traj, chk = run_c(scan_imgs, seeds0, snap)    # warmup
    _ = np.asarray(chk)
    _phase(f"scan compiled ({compile_s:.1f} s) and warm")

    t0 = time.perf_counter()
    for _ in range(N_REPEATS):
        traj, chk = run_c(scan_imgs, seeds0, snap)
        _ = np.asarray(chk)                      # forced sync
    dt = time.perf_counter() - t0
    assert np.isfinite(float(chk)), "scan produced non-finite state"
    fps = N_SCAN * N_REPEATS / dt
    stats = jax.devices()[0].memory_stats() or {}
    _phase(f"scan timed: {fps:.2f} fps")

    # the scan must actually track: scale-aligned ATE against ground truth
    traj_np = np.asarray(traj, np.float64)
    est_xyz = np.stack([se3np.translation(se3np.inv(se3np.normalize(T)))
                        for T in traj_np])
    gt_xyz = np.stack([se3np.translation(se3np.inv(T)) for T in poses[start:]])
    res = ate(est_xyz, gt_xyz, with_scale=True)
    return {"fps": fps, "compile_s": compile_s, "ate_rmse_m": float(res.rmse),
            "peak_bytes": stats.get("peak_bytes_in_use")}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    dev = require_gpu(allow_cpu="--cpu" in argv)
    enable_compile_cache()
    cam = bench_camera()
    cfg = Config()
    scene = bench_scene(cam)
    _phase(f"start on {dev['kind']} ({dev['card']})")
    vo = resume(cam, cfg, scene, regen="--regen" in argv)
    host_fps = host_loop(vo, scene)
    out = scan(vo, cam, cfg, scene)

    # honesty gate (FATAL): a mis-tracking scan reports no speed
    base_fps, base_range, base_note = reference_cpu_fps()
    device = {"platform": dev["platform"], "device_kind": dev["kind"],
              "count": dev["count"], "card": dev["card"]}
    if not (out["ate_rmse_m"] < 0.10):
        print(json.dumps({
            "metric": "pipeline_frames_per_s", "value": None, "unit": "frames/s",
            "vs_baseline": None, "device": device,
            "error": f"scan ATE RMSE {out['ate_rmse_m']:.4f} m exceeds 0.10 m "
                     "gate — the pipeline is mis-tracking; fps withheld",
        }))
        sys.exit(1)

    doc = {
        "metric": "pipeline_frames_per_s",
        "value": out["fps"],
        "unit": "frames/s",
        "vs_baseline": out["fps"] / base_fps,
        "host_loop_frames_per_s": host_fps,
        "scan_ate_rmse_m": out["ate_rmse_m"],
        "scan_compile_s": out["compile_s"],
        "peak_bytes_in_use": out["peak_bytes"],
        "device": device,
        "baseline_note": base_note,
    }
    if base_range:
        doc["vs_baseline_range"] = [out["fps"] / base_range[1],
                                    out["fps"] / base_range[0]]
    print(json.dumps(doc))


if __name__ == "__main__":
    main()
