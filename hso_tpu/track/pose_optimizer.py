"""Motion-only pose refinement on reprojection errors.

Batched re-design of ``pose_optimizer::optimizeLevenbergMarquardt3rd``
(/root/reference/src/pose_optimizer.cpp:399-771): Levenberg-Marquardt on the
unit-plane reprojection error of all matched features, with

  * host-anchored points (the caller supplies ``p_world`` already derived
    from each point's host feature bearing / inverse distance — for motion-
    only optimisation the host anchoring is algebraically equivalent to a
    world point),
  * separate MAD scales for corners vs edgelets with the reference's
    fallbacks (0.5×/2× when one class is empty),
  * Huber weights (k=1.345), ×0.5 down-weight for TEMPORARY points,
  * per-level measurement scaling 1/2^level,
  * LM with trial loop (mu·diag damping, nu doubling, ≤5 trials/iteration),
  * post-solve outlier stripping: corners at ``reproj_thresh/focal`` (or
    χ²(5.991) when < 80 features), edgelets at 1.3px/focal.

Everything is one jitted call over padded (N,) slot arrays.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from hso_tpu.math import se3
from hso_tpu.math.linalg_small import solve_spd_small
from hso_tpu.math.robust import huber_weight, mad_scale_of_abs

EPS = 1e-10
_HI = jax.lax.Precision.HIGHEST


def _project2d(p):
    z = jnp.where(jnp.abs(p[..., 2]) < 1e-12, 1e-12, p[..., 2])
    return p[..., :2] / z[..., None]


def _jacobian_uv_xi(xyz):
    x, y = xyz[..., 0], xyz[..., 1]
    z = xyz[..., 2]
    zi = 1.0 / jnp.where(jnp.abs(z) < 1e-8, 1e-8, z)
    zi2 = zi * zi
    zero = jnp.zeros_like(x)
    row0 = jnp.stack([-zi, zero, x * zi2, x * y * zi2, -(1.0 + x * x * zi2), y * zi], axis=-1)
    row1 = jnp.stack([zero, -zi, y * zi2, 1.0 + y * y * zi2, -x * y * zi2, -x * zi], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


@functools.partial(jax.jit, static_argnames=("n_iter", "focal"))
def optimize_pose(
    T_f_w,            # (3,4) current world→frame pose estimate
    p_world,          # (N,3) point positions (host-anchored upstream)
    f_obs,            # (N,3) observed bearings in the frame
    level,            # (N,) pyramid level of each observation
    grad,             # (N,2) edgelet normals (unit), arbitrary for corners
    is_edgelet,       # (N,) bool
    is_temporary,     # (N,) bool — TEMPORARY map points get 0.5 weight
    valid,            # (N,) bool slot mask
    focal: float = 450.0,
    reproj_thresh: float = 2.0,
    n_iter: int = 12,
):
    """Returns dict(T_f_w, inlier, err_init_px, err_final_px, scale_px,
    n_obs, cov)."""
    T = jnp.asarray(T_f_w, jnp.float32)
    sqrt_inv_cov = 1.0 / (1 << level).astype(jnp.float32)
    obs_uv = _project2d(f_obs)

    def residuals(T_e):
        p_t = se3.apply(T_e, p_world)
        e = (obs_uv - _project2d(p_t)) * sqrt_inv_cov[:, None]
        r_edge = jnp.sum(grad * e, axis=-1)
        r_corner = jnp.linalg.norm(e, axis=-1)
        r_abs = jnp.where(is_edgelet, jnp.abs(r_edge), r_corner)
        return p_t, e, r_edge, r_abs

    # ---- robust scales (pose_optimizer.cpp:459-487) ----
    _, _, _, r_abs0 = residuals(T)
    m_corner = valid & ~is_edgelet
    m_edge = valid & is_edgelet
    n_c = jnp.sum(m_corner.astype(jnp.int32))
    n_e = jnp.sum(m_edge.astype(jnp.int32))
    s_c = mad_scale_of_abs(jnp.where(m_corner, r_abs0, jnp.inf), m_corner)
    s_e = mad_scale_of_abs(jnp.where(m_edge, r_abs0, jnp.inf), m_edge)
    scale_pt = jnp.where(n_c > 0, s_c, 2.0 * s_e)
    scale_ls = jnp.where(n_e > 0, s_e, 0.5 * s_c)
    scale_pt = jnp.maximum(scale_pt, 1e-7)
    scale_ls = jnp.maximum(scale_ls, 1e-7)

    def weights(r_edge, r_abs):
        wgt = jnp.where(
            is_edgelet,
            huber_weight(jnp.abs(r_edge) / scale_ls),
            huber_weight(r_abs / scale_pt),
        )
        wgt = jnp.where(is_temporary, wgt * 0.5, wgt)
        return jnp.where(valid, wgt, 0.0)

    def chi2_of(T_e):
        _, _, r_edge, r_abs = residuals(T_e)
        wgt = weights(r_edge, r_abs)
        return jnp.sum(jnp.where(valid, r_abs * r_abs * wgt, 0.0))

    def system(T_e):
        p_t, e, r_edge, r_abs = residuals(T_e)
        wgt = weights(r_edge, r_abs)
        J = _jacobian_uv_xi(p_t) * sqrt_inv_cov[:, None, None]   # (N,2,6)
        J_edge = jnp.sum(grad[..., None] * J, axis=1)            # (N,6)
        e_edge = r_edge
        w_e = jnp.where(is_edgelet, wgt, 0.0)
        A_e = jnp.einsum("ni,nj,n->ij", J_edge, J_edge, w_e, precision=_HI)
        b_e = -jnp.einsum("ni,n,n->i", J_edge, e_edge, w_e, precision=_HI)
        w_c = jnp.where(is_edgelet, 0.0, wgt)
        A_c = jnp.einsum("nki,nkj,n->ij", J, J, w_c, precision=_HI)
        b_c = -jnp.einsum("nki,nk,n->i", J, e, w_c, precision=_HI)
        return A_e + A_c, b_e + b_c

    chi2_0 = chi2_of(T)

    def outer(i, carry):
        T_c, chi2_c, mu, nu, stop, A_last = carry

        def trial(j, tc):
            T_t, chi2_t, mu_t, nu_t, accepted, stop_t, A_l = tc
            A, b = system(T_t)
            Ad = A + jnp.diag(jnp.diag(A)) * mu_t
            dT = solve_spd_small(Ad, b)
            ok = jnp.all(jnp.isfinite(dT))
            T_new = se3.mul(se3.exp(dT), T_t)
            chi2_new = chi2_of(T_new)
            rho = jnp.where(ok, chi2_t - chi2_new, -1.0)
            do = (~accepted) & (~stop_t)
            acc = do & (rho > 0)
            T_t = jnp.where(acc, T_new, T_t)
            chi2_t = jnp.where(acc, chi2_new, chi2_t)
            A_l = jnp.where(acc, A, A_l)
            # the reference feeds the *raw* chi2 decrease into the Nielsen
            # update (pose_optimizer.cpp:652) — replicate verbatim
            mu_t = jnp.where(
                acc,
                mu_t * jnp.maximum(1.0 / 3.0, jnp.minimum(1.0 - (2.0 * rho - 1.0) ** 3, 2.0 / 3.0)),
                jnp.where(do, jnp.maximum(mu_t * nu_t, 1e-4), mu_t),
            )
            nu_t = jnp.where(acc, 2.0, jnp.where(do, nu_t * 2.0, nu_t))
            stop_t = stop_t | (acc & (jnp.max(jnp.abs(dT)) <= EPS))
            accepted = accepted | acc
            return T_t, chi2_t, mu_t, nu_t, accepted, stop_t, A_l

        # trials run under a while_loop so an accepted (or stopped) state
        # exits immediately instead of paying the remaining masked
        # system-builds + solves (the reference's inner loop breaks the
        # same way)
        T_c, chi2_c, mu, nu, accepted, stop, A_last, _ = jax.lax.while_loop(
            lambda tc: (~tc[4]) & (~tc[5]) & (tc[7] < 5),
            lambda tc: trial(0, tc[:7]) + (tc[7] + 1,),
            (T_c, chi2_c, mu, nu, jnp.bool_(False), stop, A_last, jnp.int32(0)),
        )
        stop = stop | ~accepted
        return T_c, chi2_c, mu, nu, stop, A_last

    init = (T, chi2_0, jnp.float32(0.1), jnp.float32(2.0),
            jnp.bool_(False), jnp.zeros((6, 6), jnp.float32))
    with jax.named_scope("pose_lm"):
        T, chi2_f, _, _, _, A_last = jax.lax.fori_loop(0, n_iter, outer, init)

    # ---- outlier stripping + stats (pose_optimizer.cpp:696-770) ----
    _, _, r_edge_f, r_abs_f = residuals(T)
    n_obs = jnp.sum(valid.astype(jnp.int32))
    thresh_pt = jnp.where(
        n_obs < 80, jnp.sqrt(5.991) / focal, reproj_thresh / focal
    )
    thresh_ls = 1.3 / focal
    inlier = valid & jnp.where(
        is_edgelet, jnp.abs(r_edge_f) <= thresh_ls, r_abs_f <= thresh_pt
    )

    def med_px(r2, m):
        from hso_tpu.math.robust import masked_median

        return jnp.sqrt(masked_median(r2, m)) * focal

    err_init = med_px(r_abs0 * r_abs0, valid)
    err_final = med_px(r_abs_f * r_abs_f, valid)
    cov = jnp.linalg.inv(A_last * focal * focal + jnp.eye(6) * 1e-12)
    error_weight = jnp.where(err_final < 1.5, 1.0, 1.5 / jnp.maximum(err_final, 1.5))

    return {
        "T_f_w": T,
        "inlier": inlier,
        "n_inliers": jnp.sum(inlier.astype(jnp.int32)),
        "err_init_px": err_init,
        "err_final_px": err_final,
        "scale_px": scale_pt * focal,
        "cov": cov,
        "error_weight": error_weight,
    }
