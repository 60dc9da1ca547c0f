"""Batched direct matching of map points into the current frame.

Batched re-design of ``Matcher::findMatchDirect`` (HSO's src/matcher.cpp
:270-375): for every candidate point at once — affine warp of its memoized
host patch, search-level selection, exposure compensation, inverse-
compositional alignment (2D for corners, along-normal 1D for edgelets), NCC
and edgelet-normal acceptance gates, 20 px displacement cap.

The reference warps from the observation with the closest viewing angle
(``getCloseViewObs``); here each point carries ONE memoized patch-source
view, refreshed whenever the point is observed in a new keyframe
(PointTable.patch_*), which the pipeline passes as the ``host_*`` candidate
rows — recency approximates closest angle under smooth motion, and residual
viewing-angle degradation is absorbed by the NCC gate.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from hso_tpu.math import se3
from hso_tpu.ops.align import align_mixed, ncc
from hso_tpu.ops.gatherless import sample_gradient_in_windows
from hso_tpu.ops.warp import best_search_level, warp_from_stored_windows, warp_matrices

EDGELET = 1


@functools.partial(jax.jit, static_argnames=("cam", "n_levels", "align_max_iter"))
def match_points(
    cand,               # dict of candidate rows: host_win, host_anchor, host_px,
                        # host_f, host_level, grad, species, idist,
                        # T_host_w (N,3,4), exposure_host (N,), valid (N,)
    cur_pyr,
    cur_sobel_x,
    cur_sobel_y,
    T_cur_w,            # (3,4)
    exposure_cur,
    cam,
    n_levels: int = 3,
    edgelet_cos_angle: float = 0.86,   # Config.edgelet_angle
    align_max_iter: int = 10,          # Config.align_max_iter
):
    """Returns dict(px (N,2) level-0, level (N,), f_cur (N,3), success (N,))."""
    n = cand["valid"].shape[0]
    T_c_h = se3.mul(jnp.broadcast_to(jnp.asarray(T_cur_w, jnp.float32), cand["T_host_w"].shape),
                    se3.inv(cand["T_host_w"]))
    depth_host = 1.0 / jnp.maximum(cand["idist"], 1e-10)

    A_cur_ref, px_proj = warp_matrices(
        cam, cam, cand["host_px"], cand["host_f"], depth_host, T_c_h,
        cand["host_level"],
    )
    search_level = jnp.clip(best_search_level(A_cur_ref, n_levels - 1), 0, n_levels - 1)
    from hso_tpu.math.linalg_small import inv2x2

    A_ref_cur = inv2x2(A_cur_ref)
    A_ref_cur = jnp.where(jnp.isfinite(A_ref_cur), A_ref_cur, 0.0)

    ref_border = warp_from_stored_windows(
        cand["host_win"], cand["host_anchor"], cand["host_px"],
        cand["host_level"], A_ref_cur, search_level,
    )
    exp_ratio = exposure_cur / jnp.maximum(cand["exposure_host"], 1e-6)
    ref_border = ref_border * exp_ratio[:, None, None]
    ref_patch = ref_border[:, 1:9, 1:9]

    grad_cur = jnp.sum(A_cur_ref * cand["grad"][:, None, :], axis=-1)
    grad_cur = grad_cur / jnp.maximum(
        jnp.linalg.norm(grad_cur, axis=-1, keepdims=True), 1e-9
    )
    is_edge = cand["species"] == EDGELET

    valid0 = cand["valid"] & cam.is_in_frame(px_proj, border=8)

    # level-packed windows: one alignment pass for all candidates
    from hso_tpu.ops.epipolar import pack_level_windows

    scale_s = (2.0 ** -search_level.astype(jnp.float32))[:, None]
    px_init = px_proj * scale_s
    windows, anchors, img_hw = pack_level_windows(
        cur_pyr, search_level, px_init[:, 0], px_init[:, 1], 24, n_levels
    )
    rm = align_mixed(is_edge, grad_cur, ref_border, px_init,
                     n_iter=align_max_iter, valid=valid0,
                     windows=windows, anchors=anchors, img_hw=img_hw)
    px_l = rm["px"]
    conv = rm["converged"]
    score = ncc(ref_patch, rm["cur_patch"])
    # gradient direction from the packed windows (see
    # gatherless.sample_gradient_in_windows)
    gx_c, gy_c = sample_gradient_in_windows(
        windows, anchors[0], anchors[1], px_l[:, 0], px_l[:, 1]
    )
    disp_ok = jnp.linalg.norm(px_l - px_init, axis=-1) < 20.0
    gn = jnp.stack([gx_c, gy_c], -1)
    gn = gn / jnp.maximum(jnp.linalg.norm(gn, axis=-1, keepdims=True), 1e-9)
    normal_ok = jnp.where(
        is_edge, jnp.sum(grad_cur * gn, axis=-1) > edgelet_cos_angle, True
    )

    success = valid0 & conv & (score > 0.7) & disp_ok & normal_ok
    px_out = jnp.where(
        success[:, None], px_l * (2.0 ** search_level.astype(jnp.float32))[:, None], 0.0
    )
    f_cur = cam.cam2world(px_out)
    return {
        "px": px_out,
        "level": search_level,
        "f_cur": f_cur.astype(jnp.float32),
        "success": success,
        "grad_cur": grad_cur,
    }


@functools.partial(jax.jit, static_argnames=("cam", "cell", "grid_h", "grid_w", "n_types"))
def select_candidates(
    pos_w,              # (P,3) world positions
    valid,              # (P,)
    priority,           # (P,) int — higher wins a cell (point-type quality)
    T_cur_w,            # (3,4)
    cam,
    cell: int = 36,
    grid_h: int = 14,
    grid_w: int = 21,
    n_types: int = 8,
):
    """Grid-based candidate selection (Reprojector::reprojectMap grid,
    /root/reference/src/reprojector.cpp:120-349): project all live points,
    keep the best-priority point per grid cell.

    Returns dict(cell_point (C,), cell_valid (C,), cell_px (C,2)) with
    C = grid_h*grid_w.
    """
    p = pos_w.shape[0]
    p_cur = se3.apply(jnp.asarray(T_cur_w, jnp.float32), pos_w)
    px = cam.world2cam(p_cur)
    ok = valid & (p_cur[:, 2] > 0.0) & cam.is_in_frame(px, border=8)

    cx = jnp.clip((px[:, 0] // cell).astype(jnp.int32), 0, grid_w - 1)
    cy = jnp.clip((px[:, 1] // cell).astype(jnp.int32), 0, grid_h - 1)
    cidx = cy * grid_w + cx
    n_cells = grid_h * grid_w

    key = priority * p + jnp.arange(p, dtype=jnp.int32)
    key = jnp.where(ok, key, -1)
    # scatter-free per-cell max: a (C, P) membership-masked reduction
    # (a C×P compare-and-reduce, ~1.4 M elements here).
    member = cidx[None, :] == jnp.arange(n_cells, dtype=jnp.int32)[:, None]
    keyg = jnp.where(member, key[None, :], -1)       # (C, P)
    best = jnp.max(keyg, axis=1)
    cell_valid = best >= 0
    cell_point = jnp.where(cell_valid, best % p, 0)
    cell_px = px[cell_point]
    # runner-up per cell — the reprojector's later budget passes retry a
    # cell with its next-best candidate when the first fails to match
    # (reprojector.cpp:257-330 3-pass scheduling)
    best2 = jnp.max(jnp.where(keyg == best[:, None], -1, keyg), axis=1)
    cell_valid2 = best2 >= 0
    cell_point2 = jnp.where(cell_valid2, best2 % p, 0)
    return {
        "cell_point": cell_point,
        "cell_valid": cell_valid,
        "cell_px": cell_px,
        "cell_point2": cell_point2,
        "cell_valid2": cell_valid2,
        "cell_px2": px[cell_point2],
        "n_projected": jnp.sum(ok.astype(jnp.int32)),
    }
