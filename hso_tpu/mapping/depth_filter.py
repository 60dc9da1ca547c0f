"""Probabilistic depth filter: per-seed recursive inverse-depth estimation.

Batched re-design of the reference ``DepthFilter`` (HSO's src/
depth_filter.cpp).  The reference runs a dedicated mapping thread that sweeps
a seed list with a 4-worker thread pool, doing a per-seed serial epipolar
walk (``observeDepthRow`` → ``Matcher::doLineStereo``); here the whole sweep
is ONE jitted device call over a static seed table:

  * seeds are SoA slot arrays (masked), hosts referenced through a small ring
    of recent keyframes,
  * each seed stores a window of its host image, extracted once at seed
    creation — per-frame affine re-warping of the reference patch then needs
    no host-image access at all (appearance memoization),
  * the ±2σ inverse-depth range projects to an epipolar segment; matching is
    the dense ZMNCC correlation search (ops/epipolar.py) + batched KLT
    refinement (ops/align.py), partitioned by search level,
  * measurement fusion is the reference's inverse-variance update
    (``updateSeed``, depth_filter.cpp:527-537) with ``computeTau``
    triangulation uncertainty (:539-555),
  * seed lifecycle (creation from detections, aging after
    ``max_seed_kf_batches`` keyframe batches, convergence harvesting at
    √σ² < z_range/converge_thresh) is slot allocation with masks.

The reference's idle-time backfill from pre-frames
(``observeDepthWithPreviousFrameOnce``) runs here as masked sweeps of the
newest seed batch against retained pre-frames at keyframe creation
(``update_mask``); the multi-view activation refinement
(``activatePoint``/``seedOptimizer``) is the batched GN over each seed's
observation ring in :func:`_activation_refine`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from hso_tpu.math import se3
from hso_tpu.ops.align import align_mixed, ncc
from hso_tpu.ops.epipolar import epipolar_zmncc_search, triangulate_depth
from hso_tpu.ops.gatherless import bilinear_scatter_in_windows, clip_anchor, extract_windows
from hso_tpu.ops.warp import best_search_level, warp_matrices

HOST_WIN = 44          #: stored host-image window edge.  Sized so the 10×10
#: bordered ref patch stays inside even when the epipolar search runs two
#: levels coarser than the seed's own level (±5·2² px + bilinear tap) — the
#: long-range search case; the point table keeps the compact 24 px windows
#: (mapmodel.structures.crop_window at the seed→point handoffs).
N_OBS_RING = 8         #: per-seed observation ring for activation refinement
SEED_FIELDS = (
    "valid", "host", "px", "f", "level", "species", "grad",
    "mu", "sigma2", "a", "b", "z_range", "converge_thresh", "batch_id",
    "host_win", "host_anchor",
)
EDGELET = 1
GRADIENT = 2


def empty_seeds(s_max: int):
    z2 = jnp.zeros((s_max,), jnp.float32)
    return {
        "valid": jnp.zeros((s_max,), bool),
        "host": jnp.zeros((s_max,), jnp.int32),
        "px": jnp.zeros((s_max, 2), jnp.float32),
        "f": jnp.zeros((s_max, 3), jnp.float32),
        "level": jnp.zeros((s_max,), jnp.int32),
        "species": jnp.zeros((s_max,), jnp.int32),
        "grad": jnp.zeros((s_max, 2), jnp.float32),
        "mu": z2, "sigma2": z2, "a": z2, "b": z2,
        "z_range": z2, "converge_thresh": z2,
        "batch_id": jnp.zeros((s_max,), jnp.int32),
        "host_win": jnp.zeros((s_max, HOST_WIN, HOST_WIN), jnp.float32),
        "host_anchor": jnp.zeros((s_max, 2), jnp.int32),
        "n_updates": z2,  # per-seed successful observation count (diagnostics)
        # observation ring for multi-view activation refinement
        # (the reference's optFrames_P/A lists, depth_filter.h:73-75)
        "obs_uv": jnp.zeros((s_max, N_OBS_RING, 2), jnp.float32),
        "obs_T": jnp.zeros((s_max, N_OBS_RING, 3, 4), jnp.float32),
        "obs_valid": jnp.zeros((s_max, N_OBS_RING), bool),
        "obs_count": jnp.zeros((s_max,), jnp.int32),
        # TEMPORARY map point spawned from this seed (Seed::temp linkage), -1 none
        "temp_point": jnp.full((s_max,), -1, jnp.int32),
    }


@functools.partial(jax.jit, static_argnames=("n_levels",))
def init_seeds(
    seeds,
    det,                 # detection dict from ops.detect (px/level/species/grad/valid)
    kf_pyr,              # new keyframe pyramid (tuple)
    f_det,               # (N,3) bearings of detections
    host_slot,           # int32 — ring slot of the new keyframe
    batch_id,            # int32 — keyframe batch counter
    depth_mean,          # scalar — median scene depth (seed prior)
    depth_min,           # scalar
    converge_thresh,     # scalar (100 or 200, frame_handler_mono.cpp:335-338)
    n_levels: int = 3,
):
    """Allocate seed slots for new detections (initializeSeeds +
    Seed::Seed, depth_filter.cpp:55-69,164-205)."""
    s_max = seeds["valid"].shape[0]
    n_det = det["px"].shape[0]

    # stored host windows at each detection's own level
    win = jnp.zeros((n_det, HOST_WIN, HOST_WIN), jnp.float32)
    anch = jnp.zeros((n_det, 2), jnp.int32)
    for lvl in range(n_levels):
        img = kf_pyr[lvl]
        scale = 1.0 / (1 << lvl)
        u = det["px"][:, 0] * scale
        v = det["px"][:, 1] * scale
        au, av = clip_anchor(u, v, HOST_WIN, 0, *img.shape)
        w_l = extract_windows(img, au, av, HOST_WIN)
        sel = det["level"] == lvl
        win = jnp.where(sel[:, None, None], w_l, win)
        anch = jnp.where(sel[:, None], jnp.stack([au, av], -1), anch)

    # slot allocation: free slots first (argsort: False<True)
    order = jnp.argsort(seeds["valid"].astype(jnp.int32), stable=True)
    det_ok = det["valid"]
    n_free = jnp.sum(~seeds["valid"])
    take = (jnp.arange(n_det) < n_free) & det_ok
    slot = order[jnp.arange(n_det) % s_max]

    mu0 = 1.0 / jnp.maximum(depth_mean, 1e-6)
    zr0 = 1.0 / jnp.maximum(depth_min, 1e-6)
    sig0 = zr0 * zr0 / 36.0

    def _bdim(mask, values):
        extra = values.ndim - 1
        return mask.reshape(mask.shape + (1,) * extra)

    new = dict(seeds)
    new["valid"] = seeds["valid"].at[slot].set(
        jnp.where(take, True, seeds["valid"][slot])
    )
    assign = {
        "host": jnp.full((n_det,), host_slot, jnp.int32),
        "px": det["px"].astype(jnp.float32),
        "f": f_det.astype(jnp.float32),
        "level": det["level"],
        "species": det["species"],
        "grad": det["grad"].astype(jnp.float32),
        "mu": jnp.full((n_det,), mu0, jnp.float32),
        "sigma2": jnp.full((n_det,), sig0, jnp.float32),
        "a": jnp.full((n_det,), 10.0, jnp.float32),
        "b": jnp.full((n_det,), 10.0, jnp.float32),
        "z_range": jnp.full((n_det,), zr0, jnp.float32),
        "converge_thresh": jnp.full((n_det,), converge_thresh, jnp.float32),
        "batch_id": jnp.full((n_det,), batch_id, jnp.int32),
        "host_win": win,
        "host_anchor": anch,
        "n_updates": jnp.zeros((n_det,), jnp.float32),
        "obs_uv": jnp.zeros((n_det, N_OBS_RING, 2), jnp.float32),
        "obs_T": jnp.zeros((n_det, N_OBS_RING, 3, 4), jnp.float32),
        "obs_valid": jnp.zeros((n_det, N_OBS_RING), bool),
        "obs_count": jnp.zeros((n_det,), jnp.int32),
        "temp_point": jnp.full((n_det,), -1, jnp.int32),
    }
    for field, values in assign.items():
        new[field] = seeds[field].at[slot].set(
            jnp.where(_bdim(take, values), values, seeds[field][slot])
        )
    return new


@functools.partial(jax.jit, static_argnames=("cam", "n_levels"))
def update_seeds(
    seeds,
    host_T_w,           # (R, 3, 4) ring of host keyframe poses (world→kf)
    host_exposure,      # (R,)
    cur_pyr,            # current frame pyramid tuple
    cur_sobel_x, cur_sobel_y,   # tuples (n_levels)
    T_cur_w,            # (3, 4)
    cur_exposure,       # scalar
    px_error_angle,     # scalar
    cam,
    update_mask=None,   # optional (S,) bool — restrict the sweep to a subset
                        # (used by the pre-frame backfill to touch only the
                        # newest seed batch, observeDepthWithPreviousFrameOnce)
    n_levels: int = 3,
):
    """One observation sweep: epipolar-match every visible seed in the current
    frame and fuse the depth measurement (updateSeedsLoop body)."""
    s_max = seeds["valid"].shape[0]
    T_h = host_T_w[seeds["host"]]
    T_cur_ref = se3.mul(
        jnp.broadcast_to(T_cur_w, T_h.shape), se3.inv(T_h)
    )

    mu = seeds["mu"]
    sigma = jnp.sqrt(jnp.maximum(seeds["sigma2"], 0.0))
    mu_safe = jnp.maximum(mu, 1e-10)
    p_cur = se3.apply(T_cur_ref, seeds["f"] / mu_safe[:, None])
    px_cur0 = cam.world2cam(p_cur)
    visible = (
        seeds["valid"]
        & (p_cur[:, 2] > 0.0)
        & cam.is_in_frame(px_cur0, border=8)
    )
    if update_mask is not None:
        visible &= update_mask

    z_inv_min = mu + 2.0 * sigma               # max inverse depth (close)
    z_inv_max = jnp.maximum(mu - 2.0 * sigma, 1e-8)
    d_close = 1.0 / jnp.maximum(z_inv_min, 1e-10)
    d_prior = 1.0 / mu_safe
    d_far = 1.0 / z_inv_max

    # ---- epipolar endpoints (level-0 pixel coords) ----
    p_close = se3.apply(T_cur_ref, seeds["f"] * d_close[:, None])
    p_far = se3.apply(T_cur_ref, seeds["f"] * d_far[:, None])
    geom_ok = (p_far[:, 2] > 1e-3) & (d_far > d_close * 0.999)
    px_close0 = cam.world2cam(p_close)
    px_far0 = cam.world2cam(p_far)
    epl0_len = jnp.linalg.norm(px_close0 - px_far0, axis=-1)

    # ---- affine warp of the memoized host patch ----
    A_cur_ref, _ = warp_matrices(
        cam, cam, seeds["px"], seeds["f"], d_prior, T_cur_ref, seeds["level"]
    )
    search_level = jnp.clip(best_search_level(A_cur_ref, n_levels - 1), 0, n_levels - 1)
    # search-range parity with the reference's 100 px cap (matcher.cpp:
    # 875-879): a ±2σ segment longer than the search window holds at the
    # warp-chosen level is matched one/two levels coarser instead of cropped
    # away — full range coverage up to MAX_EPL·2^(n_levels-1) = 144 px in
    # level-0 coords, beyond the reference's cap (uncertain seeds trade
    # match precision for range; the KLT refinement restores subpixel).
    from hso_tpu.ops.epipolar import MAX_EPL

    for _ in range(n_levels - 1):
        fits = epl0_len * (2.0 ** -search_level.astype(jnp.float32)) <= MAX_EPL
        search_level = jnp.where(fits, search_level, search_level + 1)
    search_level = jnp.clip(search_level, 0, n_levels - 1)
    from hso_tpu.math.linalg_small import inv2x2

    A_ref_cur = inv2x2(A_cur_ref)
    A_ref_cur = jnp.where(jnp.isfinite(A_ref_cur), A_ref_cur, 0.0)

    from hso_tpu.ops.warp import warp_from_stored_windows

    ref_border = warp_from_stored_windows(
        seeds["host_win"], seeds["host_anchor"], seeds["px"], seeds["level"],
        A_ref_cur, search_level,
    )
    exposure_ratio = cur_exposure / jnp.maximum(host_exposure[seeds["host"]], 1e-6)
    ref_border = ref_border * exposure_ratio[:, None, None]
    ref_patch = ref_border[:, 1:9, 1:9]

    # ---- epipolar endpoints at the search level ----
    s_scale = (2.0 ** -search_level.astype(jnp.float32))[:, None]
    px_close_l = px_close0 * s_scale
    px_far_l = px_far0 * s_scale
    epl = px_close_l - px_far_l
    epl_len = jnp.linalg.norm(epl, axis=-1)
    geom_ok &= jnp.isfinite(epl_len) & (epl_len > 1e-6)

    # edgelet/gradient direction gate (matcher.cpp:903-910)
    grad_cur = jnp.sum(A_cur_ref * seeds["grad"][:, None, :], axis=-1)
    grad_cur = grad_cur / jnp.maximum(jnp.linalg.norm(grad_cur, axis=-1, keepdims=True), 1e-9)
    cosangle = jnp.abs(jnp.sum(grad_cur * epl, axis=-1) / jnp.maximum(epl_len, 1e-9))
    dir_gate = jnp.where(seeds["species"] != 0, cosangle >= 0.4, True)

    active = visible & geom_ok & dir_gate

    # ---- level-packed epipolar search + refinement (one pass, all levels) ----
    from hso_tpu.ops.epipolar import EW, pack_level_windows

    mid = 0.5 * (px_far_l + px_close_l)
    windows, anchors, img_hw = pack_level_windows(
        cur_pyr, search_level, mid[:, 0], mid[:, 1], EW, n_levels
    )
    sr = epipolar_zmncc_search(
        windows, anchors, img_hw, ref_patch, px_far_l, px_close_l, active
    )
    # loose pre-refinement gate: the dense score map is sampled at integer
    # patch positions, so a subpixel peak (esp. at coarse search levels)
    # reads well below its refined value — candidate acceptance here mirrors
    # the reference's generous ZMSSD threshold before KLT refinement
    # (matcher.cpp:947-969); the strict NCC 0.8 gate applies AFTER
    # refinement below.
    good = active & sr["ok"] & (sr["score_best"] > 0.5)

    # subpixel KLT refinement straight from the integer ZMNCC peak — 2D for
    # corners, along-normal 1D for edgelets, one fused LM loop (the
    # reference's doLineStereo likewise goes directly from the best epipolar
    # sample to KLTLimited2D/1D, matcher.cpp:1004-1049)
    is_corner = seeds["species"] == 0
    rm = align_mixed(
        ~is_corner, grad_cur, ref_border, sr["px_best"],
        valid=good, windows=windows, anchors=anchors, img_hw=img_hw,
    )
    px_ref_l = rm["px"]
    refined_ok = rm["converged"]
    score = ncc(ref_patch, rm["cur_patch"])
    # edgelet normal agreement in the current frame (checkNormal):
    # gradient direction sampled from the packed search windows
    from hso_tpu.ops.gatherless import sample_gradient_in_windows

    gx_c, gy_c = sample_gradient_in_windows(
        windows, anchors[0], anchors[1], px_ref_l[:, 0], px_ref_l[:, 1]
    )
    meas_ok = good & refined_ok & (score > 0.8)
    gn = jnp.stack([gx_c, gy_c], -1)
    gn = gn / jnp.maximum(jnp.linalg.norm(gn, axis=-1, keepdims=True), 1e-9)
    normal_ok = jnp.where(
        seeds["species"] == EDGELET,
        jnp.sum(grad_cur * gn, axis=-1) > 0.7,
        True,
    )
    meas_ok &= normal_ok

    px_match0 = px_ref_l * (2.0 ** search_level.astype(jnp.float32))[:, None]
    f_cur = cam.cam2world(px_match0)
    z_meas, tri_ok = triangulate_depth(T_cur_ref, seeds["f"], f_cur)
    meas_ok &= tri_ok & (z_meas > 1e-6)
    z_meas = jnp.where(meas_ok, z_meas, 0.0)

    # ---- fusion (computeTau + updateSeed) ----
    T_ref_cur = se3.inv(T_cur_ref)
    t = T_ref_cur[..., :3, 3]
    fz = seeds["f"] * z_meas[:, None]
    a_vec = fz - t
    t_norm = jnp.maximum(jnp.linalg.norm(t, axis=-1), 1e-12)
    a_norm = jnp.maximum(jnp.linalg.norm(a_vec, axis=-1), 1e-12)
    alpha = jnp.arccos(jnp.clip(jnp.sum(seeds["f"] * t, -1) / t_norm, -1.0, 1.0))
    beta = jnp.arccos(jnp.clip(jnp.sum(a_vec * -t, -1) / (t_norm * a_norm), -1.0, 1.0))
    beta_plus = beta + px_error_angle
    gamma_plus = jnp.pi - alpha - beta_plus
    z_plus = t_norm * jnp.sin(beta_plus) / jnp.maximum(jnp.sin(gamma_plus), 1e-9)
    tau = z_plus - z_meas
    z_safe = jnp.maximum(z_meas, 1e-9)
    tau_inv = 0.5 * (1.0 / jnp.maximum(1e-7, z_safe - tau) - 1.0 / (z_safe + tau))
    tau2 = tau_inv * tau_inv

    x = 1.0 / z_safe
    id_var = seeds["sigma2"] * 1.01
    wf = tau2 / jnp.maximum(tau2 + id_var, 1e-20)
    new_mu = (1.0 - wf) * x + wf * seeds["mu"]
    new_var = id_var * wf

    upd = meas_ok & jnp.isfinite(new_mu) & jnp.isfinite(new_var) & (tau2 > 0)
    out = dict(seeds)
    out["mu"] = jnp.where(upd, jnp.where(jnp.abs(new_mu) < 1e-10, 1e-10, new_mu), seeds["mu"])
    out["sigma2"] = jnp.where(upd & (new_var < seeds["sigma2"]), new_var, seeds["sigma2"])
    out["b"] = jnp.where(visible & ~meas_ok, seeds["b"] + 1.0, seeds["b"])
    out["n_updates"] = seeds["n_updates"] + upd.astype(jnp.float32)

    # record the observation (unit-plane measurement + frame pose) in the
    # per-seed ring for activation refinement.  One-hot masked writes over
    # the R=8-slot axis (a fused select) rather than an ``.at[rows, slot]``
    # scatter per array.
    slot = seeds["obs_count"] % N_OBS_RING
    hit = (slot[:, None] ==
           jnp.arange(N_OBS_RING, dtype=slot.dtype)[None, :])   # (S, R)
    w_hit = hit & upd[:, None]
    uv_meas = f_cur[:, :2] / jnp.maximum(f_cur[:, 2:3], 1e-9)
    out["obs_uv"] = jnp.where(
        w_hit[..., None], uv_meas[:, None, :], seeds["obs_uv"])
    T_cur_b = jnp.asarray(T_cur_w, jnp.float32)
    out["obs_T"] = jnp.where(
        w_hit[..., None, None], T_cur_b[None, None], seeds["obs_T"])
    out["obs_valid"] = seeds["obs_valid"] | w_hit
    out["obs_count"] = seeds["obs_count"] + upd.astype(jnp.int32)

    return out, {
        "n_visible": jnp.sum(visible.astype(jnp.int32)),
        "n_updated": jnp.sum(upd.astype(jnp.int32)),
        "px_match": px_match0,
        "matched": upd,
    }


def _activation_refine(seeds, host_T_w, n_iter: int = 8, min_obs=3.0,
                       focal=450.0):
    """Multi-view inverse-distance refinement over the per-seed observation
    ring — the batched analogue of the reference's ``activatePoint`` +
    ``seedOptimizer`` (depth_filter.cpp:729-852,854-1076; re-match in ≤30
    target views, mean-shift gate, GN on 1-DoF idist).

    The ring holds independently *matched* positions (epipolar search + KLT,
    recorded at measurement time), so the reference's re-match displacement
    test maps to: mean pixel distance between each stored match and the
    converged estimate's prediction in that view.

    Returns (mu_refined, refine_ok, dist_px) — dist_px is the mean
    verification displacement (inf when the ring is empty)."""
    T_h = host_T_w[seeds["host"]]                       # (S,3,4)
    T_th = se3.mul(seeds["obs_T"], se3.inv(T_h)[:, None])   # (S,R,3,4)
    fH = seeds["f"]
    m = seeds["obs_valid"]
    n_obs = jnp.sum(m.astype(jnp.int32), axis=-1)

    def residuals(rho):
        q = fH / jnp.maximum(rho, 1e-10)[:, None]
        pT = se3.apply(T_th, q[:, None, :])             # (S,R,3)
        z = jnp.where(jnp.abs(pT[..., 2]) < 1e-9, 1e-9, pT[..., 2])
        proj = pT[..., :2] / z[..., None]
        r = seeds["obs_uv"] - proj                      # (S,R,2)
        # d proj/d rho (same algebra as ba/local_ba Juvdd)
        t_th = T_th[..., :3, 3]
        Rf = jnp.einsum("srij,sj->sri", T_th[..., :3, :3], fH,
                        precision=jax.lax.Precision.HIGHEST)
        den = Rf[..., 2] + rho[:, None] * t_th[..., 2]
        den = jnp.where(jnp.abs(den) < 1e-9, 1e-9, den)
        J0 = -(t_th[..., 0] - proj[..., 0] * t_th[..., 2]) / den
        J1 = -(t_th[..., 1] - proj[..., 1] * t_th[..., 2]) / den
        # J0/J1 are ∂(obs - proj)/∂rho directly (same closed form the BA
        # solver uses, autodiff-verified there)
        J = jnp.stack([J0, J1], axis=-1)                # (S,R,2)
        return r, J

    def body(_, rho):
        r, Jr = residuals(rho)
        w = m.astype(jnp.float32)
        H = jnp.sum(w * jnp.sum(Jr * Jr, -1), axis=-1) + 1e-12
        g = -jnp.sum(w * jnp.sum(Jr * r, -1), axis=-1)
        step = g / H
        rho_new = rho + step
        ok = jnp.isfinite(rho_new) & (rho_new > 1e-10)
        return jnp.where(ok, rho_new, rho)

    rho0 = seeds["mu"]

    # mean-shift verification at the converged (filtered) estimate: how far
    # do the stored matches sit from where the converged depth projects them
    # (activatePoint's distMean, depth_filter.cpp:820-835)
    r0, _ = residuals(rho0)
    d_px = focal * jnp.linalg.norm(r0, axis=-1)          # (S,R)
    w = m.astype(jnp.float32)
    dist_px = jnp.sum(w * d_px, axis=-1) / jnp.maximum(
        n_obs.astype(jnp.float32), 1.0)
    dist_px = jnp.where(n_obs > 0, dist_px, jnp.inf)

    rho = jax.lax.fori_loop(0, n_iter, body, rho0)
    # acceptance gate: enough views — the adaptive threshold is the
    # convergence-rate statistic clamp(0.7·nMeanConvergeFrame_, 3, 8)
    # (depth_filter.cpp:772-776) — and the refinement stayed within the
    # filter's ±3σ belief
    sigma = jnp.sqrt(jnp.maximum(seeds["sigma2"], 0.0))
    ok = (
        (n_obs.astype(jnp.float32) >= min_obs)
        & (jnp.abs(rho - rho0) < 3.0 * sigma + 1e-6)
        & (rho > 1e-10)
    )
    return jnp.where(ok, rho, rho0), ok, dist_px


@jax.jit
def harvest_and_prune(seeds, batch_counter, host_T_w=None, max_batches: int = 3,
                      min_activation_obs=3.0, focal=450.0):
    """Extract converged seeds (with multi-view activation re-verification +
    refinement) and kill stale ones (updateSeeds tail,
    depth_filter.cpp:375-498).

    Converged seeds whose stored matches disagree with the converged depth
    (mean displacement > 3.2 px corners / 2.5 px edgelets) are REJECTED —
    erased without becoming landmarks, exactly the reference's
    isValid=false path (depth_filter.cpp:820-835,426-434); moderate
    disagreement (> 2.5 / 2.0 px) keeps the filtered estimate instead of
    the multi-view refinement (:840-843).

    Returns (seeds', bundle) where ``bundle`` is a single (S, 15) float32
    array packing [converged, stale, host, px(2), f(3), level, species,
    grad(2), mu, temp_point, n_updates] — ONE device→host transfer covers
    everything the host-side harvest needs; rejected seeds are folded into
    stale so their TEMPORARY points die."""
    sigma = jnp.sqrt(jnp.maximum(seeds["sigma2"], 0.0))
    converged = seeds["valid"] & (
        sigma < seeds["z_range"] / jnp.maximum(seeds["converge_thresh"], 1e-6)
    )
    mu = seeds["mu"]
    rejected = jnp.zeros_like(converged)
    if host_T_w is not None:
        mu_ref, ref_ok, dist_px = _activation_refine(
            seeds, host_T_w, min_obs=min_activation_obs, focal=focal)
        is_edge = seeds["species"] == EDGELET
        kill_th = jnp.where(is_edge, 2.5, 3.2)
        refine_th = jnp.where(is_edge, 2.0, 2.5)
        has_ring = jnp.isfinite(dist_px)
        rejected = converged & has_ring & (dist_px > kill_th)
        converged &= ~rejected
        use_ref = ref_ok & (dist_px <= refine_th)
        mu = jnp.where(converged & use_ref, mu_ref, mu)
    mu_ok = (mu > 1e-10) & ((seeds["f"][:, 2] / jnp.maximum(mu, 1e-10)) > 1e-10)
    converged &= mu_ok
    stale = seeds["valid"] & (
        ((batch_counter - seeds["batch_id"]) > max_batches) | rejected
    )
    out = dict(seeds)
    out["valid"] = seeds["valid"] & ~converged & ~stale
    f32 = jnp.float32
    bundle = jnp.concatenate([
        converged[:, None].astype(f32),             # 0
        stale[:, None].astype(f32),                 # 1
        seeds["host"][:, None].astype(f32),         # 2
        seeds["px"],                                # 3,4
        seeds["f"],                                 # 5,6,7
        seeds["level"][:, None].astype(f32),        # 8
        seeds["species"][:, None].astype(f32),      # 9
        seeds["grad"],                              # 10,11
        mu[:, None].astype(f32),                    # 12
        seeds["temp_point"][:, None].astype(f32),   # 13
        seeds["n_updates"][:, None].astype(f32),    # 14
    ], axis=-1)
    return out, bundle


@jax.jit
def gather_seed_windows(host_win, host_anchor, idx):
    """Device-side row gather so the host fetches only the converged seeds'
    appearance windows (the full ring is ~8 MB; a keyframe converges tens).
    Windows and anchors are flattened into ONE (n, W·W+2) buffer — one
    device→host transfer instead of two."""
    n = idx.shape[0]
    return jnp.concatenate([
        host_win[idx].reshape(n, -1),
        host_anchor[idx].astype(jnp.float32),
    ], axis=-1)
