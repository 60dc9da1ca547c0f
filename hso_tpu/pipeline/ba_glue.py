"""Covisibility window selection + BA observation assembly / writeback.

Host-side glue between the map model and the device BA solver, re-designing
``FrameHandlerMono::createCovisibilityGraph`` (/root/reference/src/
frame_handler_mono.cpp:559-647, ORB-SLAM-style shared-point counting) and the
setup/teardown halves of ``ba::LocalBundleAdjustment``
(/root/reference/src/bundle_adjustment.cpp:556-897):

  * core = keyframes sharing ≥ threshold points with the centre KF (top
    ``core_n_kfs``), plus the last KF and the centre,
  * KF 0 and keyframes older than 20 keyframe-ids are held fixed; hosts and
    targets outside the core enter as fixed vertices,
  * observations = every (keyframe, feature-slot) referencing a windowed
    point, host frames excluded (the host constraint enters through the
    inverse-distance parameterisation),
  * after the solve: pose/idist writeback and outlier-observation stripping.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

import functools

from hso_tpu.ba.local_ba import local_bundle_adjustment
from hso_tpu.math import se3np


@functools.lru_cache(maxsize=16)
def _jitted_local_ba(n_kf: int, n_pts: int, n_iter: int, focal: float,
                     strip_px: float):
    return jax.jit(functools.partial(
        local_bundle_adjustment, n_kf=n_kf, n_pts=n_pts, n_iter=n_iter,
        focal=focal, strip_px=strip_px))


#: optional observer called with (args, kwargs) of every windowed-BA solve —
#: bench.py's problem capture hooks in here (the solve itself is jitted, so
#: monkeypatching the solver symbol would only see tracers)
solve_capture = None


@jax.jit
def _pack_ba_out(T_kf, idist, obs_inlier, chi2_init, chi2_final):
    """Flatten the solver outputs the host consumes into ONE buffer: one
    device→host transfer per keyframe instead of five."""
    return jnp.concatenate([
        T_kf.reshape(-1).astype(jnp.float32),
        idist.astype(jnp.float32),
        obs_inlier.reshape(-1).astype(jnp.float32),
        jnp.stack([chi2_init, chi2_final]).astype(jnp.float32),
    ])


def covisible_keyframes(handler, center) -> list[int]:
    """Keyframes sharing map points with the centre, counted through the
    inverted point→observers index — O(center obs × observers/point), never
    a scan over all keyframes (the reference maintains its covisibility
    graph incrementally for the same reason, frame_handler_mono.cpp:559-647).
    """
    o = center.obs
    seen = o["point_id"][o["valid"] & (o["point_id"] >= 0)].tolist()
    if not seen:
        return []
    pts = handler.points
    frames = handler.kfs.frames
    counter: dict[int, int] = {}
    for p in set(seen):
        for kf, _ in pts.live_obs(p, frames):
            if kf != center.kf_index:
                counter[kf] = counter.get(kf, 0) + 1
    counts = sorted(counter.items(), key=lambda t: (-t[1], t[0]))
    th = 5 if len(set(seen)) > 30 else 3
    core = [k for k, c in counts if c >= th][: handler.cfg.core_n_kfs]
    if not core and counts:
        core = [counts[0][0]]
    last_kf = frames[-2].kf_index if len(frames) > 1 else None
    if last_kf is not None and last_kf not in core:
        core.append(last_kf)
    return core


def run_local_ba(handler, center) -> dict | None:
    cfg = handler.cfg
    K = cfg.n_kfs_window
    P = cfg.n_points_ba_max

    core = covisible_keyframes(handler, center)
    window = core + [center.kf_index]

    # ---- points observed by the window ----
    pts = handler.points
    point_set: list[int] = []
    point_slot = {}
    for k in window:
        ko = handler.kfs.frames[k].obs
        for p in ko["point_id"][ko["valid"] & (ko["point_id"] >= 0)].tolist():
            if p not in point_slot and pts.valid[p]:
                if len(point_set) >= P:
                    break
                point_slot[p] = len(point_set)
                point_set.append(p)

    if len(point_set) < 8:
        return None

    # ---- keyframe slots: window first (free per fixation rules), then
    # fixed hosts/targets as encountered ----
    kf_slot = {}
    free_flags = []

    def slot_of(kf_idx: int, free: bool) -> int | None:
        if kf_idx in kf_slot:
            return kf_slot[kf_idx]
        if len(kf_slot) >= K:
            return None
        kf_slot[kf_idx] = len(kf_slot)
        free_flags.append(free)
        return kf_slot[kf_idx]

    center_id = center.kf_index
    for k in window:
        is_free = not (k == 0 or k + 20 < center_id)
        slot_of(k, is_free)
    # points whose host keyframe cannot get a slot (window overflow) are
    # dropped from this BA round — their obs rows would have no host vertex
    kept = []
    for p in point_set:
        if slot_of(int(pts.host_kf[p]), False) is not None:
            kept.append(p)
        else:
            del point_slot[p]
    point_set = kept
    point_slot = {p: i for i, p in enumerate(point_set)}
    if len(point_set) < 8:
        return None

    # ---- observation cells: all live obs of windowed points (through the
    # inverted index — never a scan over all keyframes), host frame excluded.
    # Dense (P, K) grid: a point is observed at most once per keyframe, so
    # each observation lives at its (point-slot, kf-slot) cell (the
    # solver's scatter-free layout, hso_tpu/ba/local_ba.py docstring). ----
    frames = handler.kfs.frames
    meas = np.zeros((P, K, 2), np.float32)
    grad = np.zeros((P, K, 2), np.float32)
    is_edge = np.zeros((P, K), bool)
    level = np.zeros((P, K), np.int32)
    valid = np.zeros((P, K), bool)
    f_host = np.zeros((P, 3), np.float32)
    host_col = np.zeros(P, np.int32)
    src_kf = np.full((P, K), -1, np.int32)   # writeback: cell → (kf, feature)
    src_i = np.full((P, K), -1, np.int32)

    n_obs = 0
    for p in point_set:
        s = point_slot[p]
        host = int(pts.host_kf[p])
        host_col[s] = kf_slot[host]
        f_host[s] = pts.host_f[p]
        for kf_idx, i in pts.live_obs(p, frames):
            if kf_idx == host:
                continue
            t = slot_of(kf_idx, False)
            if t is None:
                continue
            ko = frames[kf_idx].obs
            # at most one live observation per (point, keyframe) — a second
            # write would silently clobber this cell's measurement while
            # n_obs counted both, corrupting the BA input
            assert not valid[s, t], (
                f"duplicate observation of point {p} in keyframe {kf_idx}")
            f = ko["f"][i]
            meas[s, t] = f[:2] / max(f[2], 1e-9)
            grad[s, t] = ko["grad"][i]
            is_edge[s, t] = ko["species"][i] == 1
            level[s, t] = ko["level"][i]
            valid[s, t] = True
            src_kf[s, t] = kf_idx
            src_i[s, t] = i
            n_obs += 1

    if n_obs < 8:
        return None

    # ---- pack keyframes / points ----
    T_kf = np.tile(se3np.identity()[None], (K, 1, 1)).astype(np.float32)
    free = np.zeros(K, bool)
    for kf_idx, s in kf_slot.items():
        T_kf[s] = handler.kfs.poses[kf_idx]
        free[s] = free_flags[s]
    idist = np.zeros(P, np.float32)
    pvalid = np.zeros(P, bool)
    for p, s in point_slot.items():
        idist[s] = pts.idist[p]
        pvalid[s] = True

    obs = {
        "meas": jnp.asarray(meas),
        "grad": jnp.asarray(grad),
        "is_edgelet": jnp.asarray(is_edge),
        "level": jnp.asarray(level),
        "valid": jnp.asarray(valid),
        "f_host": jnp.asarray(f_host),
        "host": jnp.asarray(host_col),
    }

    n_iter = cfg.loba_num_iter
    if len(handler.kfs.frames) <= 5:
        n_iter = 30
    if cfg.distributed_ba:
        from hso_tpu.ba.distributed import distributed_bundle_adjustment

        out = distributed_bundle_adjustment(
            jnp.asarray(T_kf), jnp.asarray(free), jnp.asarray(idist),
            jnp.asarray(pvalid), obs, n_kf=K, n_pts=P, n_iter=n_iter,
            focal=float(handler.cam.focal_mean),
            strip_px=float(cfg.loba_thresh),
            n_devices=cfg.ba_n_devices,
        )
    else:
        # jit the whole solve: the eager form dispatches hundreds of small
        # ops one by one
        args_c = (jnp.asarray(T_kf), jnp.asarray(free), jnp.asarray(idist),
                  jnp.asarray(pvalid), obs)
        if solve_capture is not None:
            solve_capture(args_c, dict(
                n_kf=K, n_pts=P, n_iter=n_iter,
                focal=float(handler.cam.focal_mean),
                strip_px=float(cfg.loba_thresh)))
        out = _jitted_local_ba(K, P, n_iter, float(handler.cam.focal_mean),
                               float(cfg.loba_thresh))(*args_c)

    # ---- writeback (ONE device→host transfer for all solver outputs) ----
    buf = np.asarray(_pack_ba_out(out["T_kf"], out["idist"],
                                  out["obs_inlier"], out["chi2_init"],
                                  out["chi2_final"]), np.float64)
    nT = K * 12
    T_new = buf[:nT].reshape(K, 3, 4)
    id_new = buf[nT:nT + P]
    inl = buf[nT + P:nT + P + P * K].reshape(P, K) > 0.5
    chi2_init, chi2_final = buf[-2], buf[-1]
    # Pose writeback is OFF by default (Config.loba_pose_writeback): the
    # synchronous chain deliberately keeps the device pose cache pre-BA
    # (below), so BA pose RECORDS are epoch-inconsistent with the tracked
    # chain around them and measurably damage the keyframe trajectory
    # (boxseq-2200: 15.3 mm RMSE / 161 mm max excursion with writeback vs
    # 3.5 mm / 9.1 mm without; the reference's shared-memory tracker
    # consumes BA poses continuously, bundle_adjustment.cpp:826-834, which
    # this architecture does not).
    for kf_idx, s in kf_slot.items():
        if free[s] and cfg.loba_pose_writeback:
            handler.kfs.sync_pose(kf_idx, se3np.normalize(T_new[s]))
            if kf_idx == center.kf_index:
                center.T_f_w = handler.kfs.poses[kf_idx]
                # center.T_dev is deliberately NOT invalidated: the frame's
                # device pose cache and its obs_dev observation set form a
                # CONSISTENT pair (the matches were made under that pose);
                # feeding the BA-corrected pose with pre-BA observation rays
                # into the next coarse track biases the photometric
                # reference (measured: boxseq-2200 ATE max 0.25 m vs
                # 0.08 m).  The BA correction reaches the next frame through
                # the snapshot's kf_poses/pos_w instead.
    for p, s in point_slot.items():
        if id_new[s] > 1e-10:
            pts.idist[p] = id_new[s]
    n_strip = 0
    bad = np.nonzero(~inl & (src_kf >= 0))
    for s, t in zip(*bad):
        ko = handler.kfs.frames[src_kf[s, t]].obs
        ko["point_id"][src_i[s, t]] = -1
        ko["valid"][src_i[s, t]] = False
        n_strip += 1

    return {
        "n_obs": n_obs,
        "n_points": len(point_set),
        "n_kfs": len(kf_slot),
        "n_stripped": n_strip,
        "chi2_init": float(chi2_init),
        "chi2_final": float(chi2_final),
    }
