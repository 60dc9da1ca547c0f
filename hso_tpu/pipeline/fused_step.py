"""One-dispatch-per-frame: the whole default tracking path as a single
jitted device function.

The reference's per-frame path is one pass of the tracking thread
(HSO's src/frame_handler_mono.cpp:173-355); here it is ONE
device dispatch per frame — pyramid + Sobel construction, coarse-to-fine
7-DoF photometric alignment (both FC and IC variants under ``lax.cond``,
selected by the gradient-mean test of frame_handler_mono.cpp:184-209),
grid candidate selection with the runner-up retry pass, batched direct
matching, motion-only pose LM, on-device scene-depth statistics, and the
full depth-filter seed sweep.

``FrameHandler.add_image`` and ``bench.py`` call THE SAME step function, so
the benchmarked scan and the live pipeline cannot diverge.  The host keeps only branchy bookkeeping: observation writeback,
point lifecycle counters, the keyframe decision, and keyframe-time work
(detection, BA, seed init) — none of which dispatches device work on the
non-keyframe path.

The map state enters as a *snapshot* dict of device arrays; heavy members
(patch windows, positions, keyframe poses) change only at keyframe events
and are cached device-side by the caller (``FrameHandler._snapshot``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from hso_tpu.image.pyramid import build_frame_pyramids
from hso_tpu.math import se3
from hso_tpu.math.robust import masked_median
from hso_tpu.mapping.depth_filter import update_seeds
from hso_tpu.track.coarse_tracker import make_coarse_tracker
from hso_tpu.track.matcher import match_points, select_candidates
from hso_tpu.track.pose_optimizer import optimize_pose

#: snapshot keys that change only at keyframe events (heavy, cached device-side)
SNAP_HEAVY = (
    "pos_w", "kf_poses", "kf_exposure", "ring_T", "ring_exp",
    "pt_pack", "species",
)

#: packed per-point patch-source row layout (snap["pt_pack"], (P, PT_COLS)
#: float32): ONE row gather per match pass, sliced afterwards, instead of
#: ~10 per-field gathers.  ints (anchor/level/species/kf) are exact in f32
#: at their ranges.
PT_WIN = 24
PT_NW = PT_WIN * PT_WIN
PT_COLS = PT_NW + 12
# column offsets after the flattened window:
#   [px 0:2 | f 2:5 | anchor 5:7 | level 7 | grad 8:10 | species 10 | kf 11]
#: the per-frame snapshot member: point lifecycle state packed into ONE
#: int32 array (type in bits 0-2, valid in bit 3) so the host uploads a
#: single small buffer per frame
SNAP_LIGHT = ("light",)

TYPE_TEMPORARY = 1


def pack_light(pt_type, pt_valid):
    import numpy as np

    return (pt_type.astype(np.int32) + 8 * pt_valid.astype(np.int32))


@jax.jit
def scatter_rows(dst, idx, src):
    """Patch rows of a device-resident snapshot table (fixed-width scatter;
    callers pad ``idx`` by repeating a real row so duplicates write the same
    value)."""
    return dst.at[idx].set(src)


def candidate_rows(snap, cp, cp_valid, T_cur, patch_closest: bool = False):
    """Matcher candidate rows for map points ``cp`` (ONE packed-row gather
    from the snapshot, sliced into the fields ``match_points`` reads)."""
    if patch_closest:
        # getCloseViewObs over the two stored views (point.cpp:
        # 97-137): pick host vs latest-keyframe view by viewing
        # angle to the current camera
        p_w = snap["pos_w"][cp]
        c_cur = se3.translation(se3.inv(T_cur))

        def cosang(kf_idx):
            c_v = se3.translation(se3.inv(snap["kf_poses"][kf_idx]))
            a = c_v - p_w
            b = c_cur[None, :] - p_w
            return jnp.sum(a * b, -1) / (
                jnp.linalg.norm(a, axis=-1)
                * jnp.linalg.norm(b, axis=-1) + 1e-9)

        hp = snap["host_pack"][cp]
        pp = snap["pt_pack"][cp]
        use_host = (
            cosang(hp[:, PT_NW + 11].astype(jnp.int32))
            > cosang(pp[:, PT_NW + 11].astype(jnp.int32)))
        pk = jnp.where(use_host[:, None], hp, pp)
    else:
        pk = snap["pt_pack"][cp]          # ONE gather for all fields
    win = pk[:, :PT_NW].reshape(-1, PT_WIN, PT_WIN)
    c = pk[:, PT_NW:]
    pkf = c[:, 11].astype(jnp.int32)
    T_p = snap["kf_poses"][pkf]
    p_in_patch = se3.apply(T_p, snap["pos_w"][cp])
    idist_p = 1.0 / jnp.maximum(
        jnp.linalg.norm(p_in_patch, axis=-1), 1e-9)
    return {
        "host_win": win,
        "host_anchor": c[:, 5:7].astype(jnp.int32),
        "host_px": c[:, 0:2],
        "host_f": c[:, 2:5],
        "host_level": c[:, 7].astype(jnp.int32),
        "grad": c[:, 8:10],
        "species": c[:, 10].astype(jnp.int32),
        "idist": idist_p.astype(jnp.float32),
        "T_host_w": T_p,
        "exposure_host": snap["kf_exposure"][pkf],
        "valid": cp_valid,
    }


@functools.lru_cache(maxsize=8)
def make_frame_step(cam, grid: tuple, klt_max_level: int, klt_min_level: int,
                    coarse_n_iter: int, pattern_offset: int,
                    poseoptim_thresh: float, n_obs_pad: int = 0,
                    edgelet_cos_angle: float = 0.86, align_max_iter: int = 10,
                    patch_closest: bool = False):
    """Build the jitted fused per-frame step for a fixed camera/config.

    ``n_obs_pad`` > C pads the returned ``obs_next`` arrays (and accepted
    ``prev_obs``) to a fixed slot count so bootstrap/reloc frames with
    differently-sized observation tables reuse the same trace."""
    cell, gh, gw = grid
    C = gh * gw

    track_fc = make_coarse_tracker(
        cam, max_level=klt_max_level, min_level=klt_min_level + 1,
        n_iter=coarse_n_iter, inverse=False, pattern_offset=pattern_offset)
    track_ic = make_coarse_tracker(
        cam, max_level=klt_max_level, min_level=klt_min_level + 1,
        n_iter=coarse_n_iter, inverse=True, pattern_offset=pattern_offset)

    @jax.jit
    def step(img, prev_pyr, prev_grad_mean, T_prev, prev_obs, prev_intensity,
             exposure_prev, T_init_rel, snap, seeds, px_error_angle, acc):
        data = build_frame_pyramids(img)
        lt = snap["light"]
        pt_valid = lt >= 8
        priority = lt & 7
        is_temp = priority == TYPE_TEMPORARY

        # ---- 1. coarse photometric tracking vs the previous frame ----
        pid = prev_obs["pid"]
        p_prev = se3.apply(T_prev, snap["pos_w"][pid])
        dist = jnp.where(
            prev_obs["valid"] & (p_prev[:, 2] > 1e-5),
            jnp.linalg.norm(p_prev, axis=-1), -1.0).astype(jnp.float32)
        # FC vs IC by gradient mean (frame_handler_mono.cpp:184-209)
        use_fc = data["grad_mean"] > prev_grad_mean + 0.5
        a_init = data["intensity_mean"] / jnp.maximum(prev_intensity, 1e-6)
        targs = (prev_pyr, data["pyr"], prev_obs["px"], prev_obs["f"], dist,
                 T_init_rel, a_init)
        tout = jax.lax.cond(use_fc, lambda a: track_fc(*a),
                            lambda a: track_ic(*a), targs)
        T_cur = se3.mul(tout["T_cur_ref"], T_prev)
        r = tout["exposure_ratio"]
        exposure = jnp.where(
            jnp.abs(r - 1.0) < 0.01, exposure_prev, r * exposure_prev)

        # ---- 2. grid selection + batched matching with budget passes
        # (reprojector.cpp:257-330): pass 1 matches every cell's best
        # candidate; pass 2 retries the cells whose best FAILED with their
        # runner-up, compacted into C//2 slots (more simultaneous failures
        # than that means the frame is in trouble anyway — the reference's
        # budget walk stops early too) ----
        sel = select_candidates(
            snap["pos_w"], pt_valid, priority, T_cur, cam,
            cell=cell, grid_h=gh, grid_w=gw)

        cp1 = jnp.where(sel["cell_valid"], sel["cell_point"], 0)
        m1 = match_points(candidate_rows(snap, cp1, sel["cell_valid"], T_cur,
                                         patch_closest), data["pyr"],
                          data["sobel_x"], data["sobel_y"], T_cur, exposure,
                          cam, edgelet_cos_angle=edgelet_cos_angle,
                          align_max_iter=align_max_iter)
        s1 = m1["success"] & sel["cell_valid"]

        R = C // 2
        want2 = sel["cell_valid2"] & ~s1
        # earliest wanting cell per retry slot (deterministic compaction)
        _, ridx = jax.lax.top_k(
            jnp.where(want2, C - jnp.arange(C), 0), R)
        take = want2[ridx]
        cp2 = jnp.where(take, sel["cell_point2"][ridx], 0)
        m2 = match_points(candidate_rows(snap, cp2, take, T_cur,
                                         patch_closest), data["pyr"],
                          data["sobel_x"], data["sobel_y"], T_cur, exposure,
                          cam, edgelet_cos_angle=edgelet_cos_angle,
                          align_max_iter=align_max_iter)
        s2 = m2["success"] & take
        # route retry results back to their cells by an integer index
        # gather: cell c reads retry slot slot_of[c], or the zero row R
        # when no slot retried it (ids and coordinates come back exact)
        slot_of = jnp.full((C,), R, jnp.int32).at[
            jnp.where(take, ridx, C)].set(jnp.arange(R, dtype=jnp.int32),
                                          mode="drop")

        def back(a):
            return jnp.concatenate(
                [a, jnp.zeros((1,) + a.shape[1:], a.dtype)])[slot_of]

        tried2 = slot_of < R
        use2 = back(s2)
        success = s1 | use2

        def pick(a1, a2):
            u2 = use2.reshape((C,) + (1,) * (a1.ndim - 1))
            return jnp.where(u2, back(a2), a1)

        cid = jnp.where(use2, back(cp2), cp1)
        m_px = pick(m1["px"], m2["px"])
        m_f = pick(m1["f_cur"], m2["f_cur"])
        m_level = pick(m1["level"], m2["level"])
        m_grad = pick(m1["grad_cur"], m2["grad_cur"])
        m_species = snap["species"][cid]

        # ---- 3. motion-only pose refinement ----
        pout = optimize_pose(
            T_cur, snap["pos_w"][cid], m_f, m_level, m_grad,
            m_species == 1, is_temp[cid], success,
            focal=float(cam.focal_mean), reproj_thresh=poseoptim_thresh)
        T_new = pout["T_f_w"]
        inlier = pout["inlier"] & success

        # ---- 4. scene-depth statistics (getSceneDepth analogue) ----
        p_cur = se3.apply(T_new, snap["pos_w"][cid])
        z = p_cur[:, 2]
        d = jnp.linalg.norm(p_cur, axis=-1)
        ok = inlier & (z > 0)
        depth_mean = masked_median(jnp.where(ok, z, jnp.inf), ok)
        depth_min = jnp.min(jnp.where(ok, z, jnp.inf))
        distance_mean = masked_median(jnp.where(ok, d, jnp.inf), ok)

        # ---- 5. depth-filter observation sweep ----
        seeds_new, sstats = update_seeds(
            seeds, snap["ring_T"], snap["ring_exp"], data["pyr"],
            data["sobel_x"], data["sobel_y"], T_new, exposure,
            px_error_angle, cam)

        # next frame's tracking reference: this frame's inlier matches,
        # padded to the fixed observation slot count
        pad = max(n_obs_pad - C, 0)

        def padded(a):
            return jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))

        obs_next = {
            "px": padded(m_px),
            "f": padded(m_f),
            "pid": padded(cid),
            "valid": padded(inlier),
        }

        # ---- 6. host-sync packing.  The per-frame host readback is ONE
        # transfer: every scalar the host branches on goes into `packed`
        # (ints < 2^24 are exact in f32), and the per-slot results the host
        # needs only at keyframe/sparse events go into `slot_pack` (fetched
        # lazily).  Point success/fail counters accumulate ON DEVICE in
        # `acc` and are drained at keyframe events — point lifecycle
        # transitions (kill/promote) therefore land at keyframes instead of
        # per frame, the same lag the reference's async mapping thread has
        # (/root/reference/src/depth_filter.cpp:242-328). ----
        cp2f = jnp.where(sel["cell_valid2"], sel["cell_point2"], 0)
        # membership-reduction accumulation: a dense (P, C) compare and
        # reduce in place of 4 scatter-adds
        p_ids = jnp.arange(acc.shape[1], dtype=cp1.dtype)
        m1p = p_ids[:, None] == cp1[None, :]                  # (P, C)
        m2p = p_ids[:, None] == cp2f[None, :]
        succ_inc = (jnp.sum((m1p & s1[None, :]).astype(jnp.int32), axis=1)
                    + jnp.sum((m2p & (tried2 & use2)[None, :]).astype(jnp.int32),
                              axis=1))
        fail_inc = (jnp.sum((m1p & (sel["cell_valid"] & ~s1)[None, :])
                    .astype(jnp.int32), axis=1)
                    + jnp.sum((m2p & (tried2 & ~use2)[None, :])
                              .astype(jnp.int32), axis=1))
        acc_new = acc + jnp.stack([succ_inc, fail_inc])

        packed = jnp.concatenate([
            T_new.reshape(-1).astype(jnp.float32),            # 0:12
            jnp.stack([
                exposure,                                     # 12
                jnp.sum(success.astype(jnp.float32)),         # 13 n_matches
                jnp.sum(inlier.astype(jnp.float32)),          # 14 n_inliers
                pout["err_final_px"],                         # 15
                depth_mean, depth_min, distance_mean,         # 16,17,18
                sstats["n_updated"].astype(jnp.float32),      # 19
                tout["n_tracked"].astype(jnp.float32),        # 20
                r,                                            # 21 exposure ratio
                data["grad_mean"],                            # 22
                data["intensity_mean"],                       # 23
            ]).astype(jnp.float32),
        ])
        flags = (success.astype(jnp.int32)
                 + 2 * inlier.astype(jnp.int32)
                 + 4 * sel["cell_valid"].astype(jnp.int32)
                 + 8 * s1.astype(jnp.int32)
                 + 16 * tried2.astype(jnp.int32)
                 + 32 * use2.astype(jnp.int32))
        slot_pack = jnp.concatenate([
            m_px,                                             # 0,1
            m_f,                                              # 2,3,4
            m_grad,                                           # 5,6
            m_level[:, None].astype(jnp.float32),             # 7
            m_species[:, None].astype(jnp.float32),           # 8
            cid[:, None].astype(jnp.float32),                 # 9
            flags[:, None].astype(jnp.float32),               # 10
        ], axis=-1)
        # keyframe-event fetch: slot results + lifecycle accumulators + seed
        # match stats in ONE flat buffer (one transfer, not four).
        # Layout: [slot_pack (C*11) | acc (2P) |
        # seed_match_px (2S) | seed_matched (S)]
        kf_pack = jnp.concatenate([
            slot_pack.reshape(-1),
            acc_new.reshape(-1).astype(jnp.float32),
            sstats["px_match"].reshape(-1),
            sstats["matched"].astype(jnp.float32),
        ])

        return {
            "packed": packed,
            "slot_pack": slot_pack,
            "kf_pack": kf_pack,
            "acc": acc_new,
            "obs_next": obs_next,
            "data": data,
            "T_track": T_cur,
            "T_new": T_new,
            "exposure": exposure,
            "exposure_ratio": r,
            "n_tracked": tout["n_tracked"],
            "cid": cid,
            "success": success,
            "inlier": inlier,
            "cv1": sel["cell_valid"],
            "s1": s1,
            "tried2": tried2,
            "s2_used": use2,
            "cp1": cp1,
            "cp2": jnp.where(sel["cell_valid2"], sel["cell_point2"], 0),
            "px": m_px,
            "f_cur": m_f,
            "level": m_level,
            "grad_cur": m_grad,
            "species": m_species,
            "err_px": pout["err_final_px"],
            "n_matches": jnp.sum(success.astype(jnp.int32)),
            "n_inliers": jnp.sum(inlier.astype(jnp.int32)),
            "depth_mean": depth_mean,
            "depth_min": depth_min,
            "distance_mean": distance_mean,
            "seeds": seeds_new,
            "n_seeds_updated": sstats["n_updated"],
            "seed_match_px": sstats["px_match"],
            "seed_matched": sstats["matched"],
        }

    return step
