"""Sliding-window bundle adjustment: a purpose-built Schur-complement LM
solver replacing the reference's g2o stack.

Re-designs ``ba::LocalBundleAdjustment`` + the custom g2o types
(/root/reference/src/bundle_adjustment.cpp:556-897,
/root/reference/include/hso/bundle_adjustment.h:185-404):

  * landmarks are 1-DoF inverse distances anchored at a host feature
    (``VertexSBAPointID``); residuals are unit-plane reprojections in the
    target frame, scalar along-normal for edgelets
    (``EdgeProjectID2UV(EdgeLet)``) with information 1/4^level,
  * keyframes older than the fixation horizon (or KF 0) are held fixed,
  * Huber deltas per class from the median of initial residuals
    (×1.4826; fallbacks 1.0/f and 0.5/f when a class is empty),
  * Levenberg-Marquardt with the landmark block eliminated analytically —
    H_pp is *scalar* per point, so the Schur reduction is a single
    (6K, P)·(P, 6K) matmul, not a sparse factorization,
  * after the solve, observations are re-tested and stripped at 2.0 px
    (corners) / 1.2 px (edgelets).

Observation layout: a **dense (P, K) grid** — each windowed point is
observed at most once per windowed keyframe, so observations live at their
(point-slot, keyframe-slot) cell with a validity mask.  Every Hessian
assembly reduction is then a dense ``einsum`` over the grid — zero
scatter/``segment_sum`` ops.  Hosts are a per-point column (``host`` (P,)),
relative poses come from a (K, K) pair table, and the host-side one-hot
``M_h`` (P, K) routes host-block contributions with matmuls.

Shapes are static: K keyframe slots, P point slots.  The per-iteration
reduced-system build (:func:`build_reduced_system`) is a pure sum over the
grid — the multi-host distributed BA shards the P axis across devices in
contiguous blocks and ``psum``s only the (6K, 6K) camera system
(see ba/distributed.py).

Jacobians use this module's own convention (tangent [rho, phi], update
T ← exp(δ)·T) and are verified against ``jax.jacfwd`` in the tests rather
than transcribed from g2o.

Observation dict (all leading dims (P, K) unless noted):
  ``meas`` (P,K,2) unit-plane measurement in the target frame
  ``grad`` (P,K,2) edgelet normal (unit, target frame)
  ``is_edgelet`` (P,K) bool     ``level`` (P,K) int
  ``valid`` (P,K) bool — False for the host column and empty cells
  ``f_host`` (P,3) host-frame unit bearing    ``host`` (P,) int keyframe slot
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from hso_tpu.math import se3
from hso_tpu.math.robust import MAD_NORMALIZER, masked_median_bisect

OBS_KEYS = ("meas", "grad", "is_edgelet", "level", "valid", "f_host", "host")
_HI = jax.lax.Precision.HIGHEST


def host_onehot(host, n_kf: int):
    """(P, K) float one-hot of each point's host keyframe slot."""
    return (host[:, None] == jnp.arange(n_kf)[None, :]).astype(jnp.float32)


def residuals_and_jacobians(T_kf, idist, obs):
    """Per-cell residuals and analytic Jacobians on the dense (P, K) grid.

    T_kf  : (K, 3, 4) world→kf poses
    idist : (P,) inverse distances
    obs   : dense observation dict (module docstring)

    Returns r (P,K,2) (edgelet residual in [...,0], [...,1]=0), J_rho (P,K,2),
    J_host (P,K,2,6), J_target (P,K,2,6), sqrt_info (P,K).
    (Edgelet rows are pre-projected onto the normal.)

    All small contractions are written in explicit broadcast-multiply form:
    einsums over (3,)/(6,) axes would lower to per-cell micro
    ``dot_general``s, while the elementwise form fuses.  The unit-plane projection
    Jacobian A = (1/z)·[[1,0,-u],[0,1,-v]] is folded in algebraically:
    -A·M has rows -(M₀ - u·M₂)/z and -(M₁ - v·M₂)/z.
    """
    fH = obs["f_host"]                                   # (P,3)
    rho = idist
    rho_safe = jnp.where(jnp.abs(rho) < 1e-10, 1e-10, rho)

    # (K,K,3,4) pair table T_th = T_t · T_h⁻¹, then pick rows by host
    # (one (P,K)·(K·12) matmul instead of per-cell gathers)
    T_inv = se3.inv(T_kf)
    T_pairs = se3.mul(T_kf[None, :], jnp.broadcast_to(
        T_inv[:, None], (T_kf.shape[0],) * 2 + (3, 4)))   # [h, t]
    Mh = host_onehot(obs["host"], T_kf.shape[0])
    T_th = jnp.einsum("ph,htij->ptij", Mh, T_pairs, precision=_HI)      # (P,K,3,4)

    q = fH / rho_safe[:, None]                            # (P,3) host point
    R_th = T_th[..., :3, :3]
    t_th = T_th[..., :3, 3]
    pT = jnp.sum(R_th * q[:, None, None, :], -1) + t_th   # (P,K,3)
    px_, py_, pz_ = pT[..., 0], pT[..., 1], pT[..., 2]
    z = jnp.where(jnp.abs(pz_) < 1e-12, 1e-12, pz_)
    zi = 1.0 / z
    u = px_ * zi
    v = py_ * zi
    proj = jnp.stack([u, v], axis=-1)

    def neg_A_dot(m0, m1, m2):
        """rows of -A·M from M's three rows (each (..., C))."""
        return jnp.stack(
            [-(m0 - u[..., None] * m2) * zi[..., None],
             -(m1 - v[..., None] * m2) * zi[..., None]], axis=-2)

    # d pT / d rho = R_th · (-q / rho)
    dpT_drho = jnp.sum(R_th * (-q / rho_safe[:, None])[:, None, None, :], -1)
    J_rho2 = jnp.stack(
        [-(dpT_drho[..., 0] - u * dpT_drho[..., 2]) * zi,
         -(dpT_drho[..., 1] - v * dpT_drho[..., 2]) * zi], axis=-1)  # (P,K,2)

    # d pT / d delta_target = [I | -pT^]; rows written out
    one = jnp.ones_like(px_)
    zero = jnp.zeros_like(px_)
    tr0 = jnp.stack([one, zero, zero, zero, pz_, -py_], axis=-1)
    tr1 = jnp.stack([zero, one, zero, -pz_, zero, px_], axis=-1)
    tr2 = jnp.stack([zero, zero, one, py_, -px_, zero], axis=-1)
    J_t2 = neg_A_dot(tr0, tr1, tr2)                       # (P,K,2,6)

    # d pT / d delta_host = -R_th·[I | -q^]; B = R_th·[I | -q^] has
    # columns [R_th | R_th·(-q^)], each a broadcast mul-sum over j
    qx, qy, qz = q[..., 0], q[..., 1], q[..., 2]
    zq = jnp.zeros_like(qx)
    nhq = jnp.stack(                                      # -hat(q): (P,3,3)
        [jnp.stack([zq, qz, -qy], -1),
         jnp.stack([-qz, zq, qx], -1),
         jnp.stack([qy, -qx, zq], -1)], axis=-2)
    RB = jnp.sum(R_th[..., :, :, None] * nhq[:, None, None, :, :], axis=-2)
    B = jnp.concatenate([R_th, RB], axis=-1)              # (P,K,3,6)
    # -A·(-B) = A·B → reuse neg_A_dot on -B's rows
    J_h2 = neg_A_dot(-B[..., 0, :], -B[..., 1, :], -B[..., 2, :])

    # residual r = meas - proj
    r2 = obs["meas"] - proj                               # (P,K,2)

    # edgelets: project residual & Jacobians onto the normal, scalar row 0
    g = obs["grad"]
    is_e = obs["is_edgelet"][..., None]
    r_e = jnp.sum(g * r2, axis=-1, keepdims=True)
    r = jnp.where(is_e, jnp.concatenate([r_e, jnp.zeros_like(r_e)], -1), r2)
    Je_rho = jnp.sum(g * J_rho2, axis=-1, keepdims=True)
    J_rho = jnp.where(
        is_e, jnp.concatenate([Je_rho, jnp.zeros_like(Je_rho)], -1), J_rho2)
    Je_h = jnp.sum(g[..., None] * J_h2, axis=-2)[..., None, :]
    J_h = jnp.where(is_e[..., None],
                    jnp.concatenate([Je_h, jnp.zeros_like(Je_h)], -2), J_h2)
    Je_t = jnp.sum(g[..., None] * J_t2, axis=-2)[..., None, :]
    J_t = jnp.where(is_e[..., None],
                    jnp.concatenate([Je_t, jnp.zeros_like(Je_t)], -2), J_t2)

    sqrt_info = 1.0 / (1 << obs["level"]).astype(jnp.float32)
    return r, J_rho, J_h, J_t, sqrt_info


def residual_norms(r, obs, sqrt_info):
    """Information-scaled residual norms (P,K): |r|·s for corners, |r₀|·s
    for edgelets (their residual is already scalar in channel 0)."""
    return jnp.where(
        obs["is_edgelet"], jnp.abs(r[..., 0]), jnp.linalg.norm(r, axis=-1)
    ) * sqrt_info


def huber_chi2(rn, is_edgelet, valid, delta_corner, delta_edge):
    delta = jnp.where(is_edgelet, delta_edge, delta_corner)
    chi = jnp.where(rn <= delta, rn * rn, 2.0 * delta * rn - delta * delta)
    return jnp.sum(jnp.where(valid, chi, 0.0))


def compute_deltas(T_kf, idist, obs, focal: float):
    """Huber deltas per class from the median of initial residuals
    (bundle_adjustment.cpp:661-680)."""
    r0, _, _, _, sqrt_info = residuals_and_jacobians(T_kf, idist, obs)
    rn0 = residual_norms(r0, obs, sqrt_info).reshape(-1)
    is_e = obs["is_edgelet"].reshape(-1)
    valid = obs["valid"].reshape(-1)
    m_c = valid & ~is_e
    m_e = valid & is_e
    med_c = masked_median_bisect(jnp.where(m_c, rn0, jnp.inf), m_c)
    med_e = masked_median_bisect(jnp.where(m_e, rn0, jnp.inf), m_e)
    d_c = jnp.where(jnp.sum(m_c) > 0, MAD_NORMALIZER * med_c, 1.0 / focal)
    d_e = jnp.where(jnp.sum(m_e) > 0, MAD_NORMALIZER * med_e, 0.5 / focal)
    return jnp.maximum(d_c, 1e-7), jnp.maximum(d_e, 1e-7)


def build_reduced_system(T_kf, idist, obs, deltas, n_kf: int, n_pts: int):
    """One Gauss-Newton linearization with analytic landmark elimination.

    Returns dict(H_cc (6K,6K), g_c (6K,), H_pp (P,), g_p (P,), W (P,6K),
    chi2, rn (P,K)).  All outputs are *sums over observation cells* — in the
    distributed solver each shard computes them on its contiguous point-block
    slice and the camera system is psum-reduced.  Zero scatters: the dense
    grid makes every reduction an einsum.
    """
    K = n_kf
    r, J_rho, J_h, J_t, sqrt_info = residuals_and_jacobians(T_kf, idist, obs)
    rn = residual_norms(r, obs, sqrt_info)
    delta_c, delta_e = deltas
    delta = jnp.where(obs["is_edgelet"], delta_e, delta_c)
    w = jnp.where(rn <= delta, 1.0, delta / jnp.maximum(rn, 1e-12))
    w = jnp.where(obs["valid"], w, 0.0)
    chi2 = huber_chi2(rn, obs["is_edgelet"], obs["valid"], delta_c, delta_e)

    iw = w * sqrt_info * sqrt_info                        # (P,K)
    Mh = host_onehot(obs["host"], K)

    # Everything below is elementwise broadcast + big reductions/matmuls —
    # no per-cell micro dot_generals (see residuals_and_jacobians docstring).
    wr = r * iw[..., None]                                # (P,K,2)
    Jr_w = J_rho * iw[..., None]

    # ---- landmark blocks (scalar per point) ----
    H_pp = jnp.sum(J_rho * Jr_w, axis=(1, 2))
    g_p = -jnp.sum(Jr_w * r, axis=(1, 2))

    # ---- point-camera coupling W[p] ∈ R^{6K}: target part lands at its own
    # column, host part at the point's host column ----
    Wt = jnp.sum(J_t * Jr_w[..., None], axis=2)           # (P,K,6)
    Wh = jnp.sum(J_h * Jr_w[..., None], axis=(1, 2))      # (P,6)
    W = (Wt + Mh[..., None] * Wh[:, None, :]).reshape(-1, 6 * K)

    # ---- camera-camera blocks: (t,t) diagonal, (h,h) diagonal via Mh,
    # (t,h)/(h,t) cross via Mh.  Per-cell 6×6 outer products are formed as
    # one (P,K,6,6) broadcast (r unrolled), then grouped by host with a
    # (K, P)·(P, ·) one-hot matmul ----
    def outer66(Ja, Jb):
        return (Ja[..., 0, :, None] * Jb[..., 0, None, :]
                + Ja[..., 1, :, None] * Jb[..., 1, None, :]) * iw[..., None, None]

    Htt = jnp.sum(outer66(J_t, J_t), axis=0)                  # (K,6,6)
    Hhh_p = jnp.sum(outer66(J_h, J_h), axis=1)                # (P,6,6)
    Hhh = jnp.einsum("ph,pij->hij", Mh, Hhh_p, precision=_HI)              # (K,6,6)
    Hth = jnp.einsum("ph,pkij->khij", Mh, outer66(J_t, J_h),
                     precision=_HI)  # (K,K,6,6) [t,h]

    eyeK = jnp.eye(K)
    blocks = (
        Htt[:, None] * eyeK[:, :, None, None]
        + Hhh[:, None] * eyeK[:, :, None, None]
        + Hth                                            # (t,h) block
        + Hth.transpose(1, 0, 3, 2)                      # (h,t) = (t,h)ᵀ
    )                                                     # (K,K,6,6)
    H_cc = blocks.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K)

    g_t = -jnp.sum(J_t * wr[..., None], axis=(0, 2))          # (K,6)
    g_h_p = -jnp.sum(J_h * wr[..., None], axis=(1, 2))        # (P,6)
    g_c = (g_t + jnp.einsum("ph,pi->hi", Mh, g_h_p, precision=_HI)).reshape(6 * K)

    return {"H_cc": H_cc, "g_c": g_c, "H_pp": H_pp, "g_p": g_p, "W": W,
            "chi2": chi2, "rn": rn}


def _schur_solve(sys, free_kf_mask, lam, n_kf: int):
    """Damped solve of the reduced camera system + back-substitution factors.

    Returns (delta_c (6K,), delta_p (P,))."""
    H_pp_d = sys["H_pp"] * (1.0 + lam) + 1e-12
    Hpp_inv = 1.0 / H_pp_d
    W = sys["W"]
    H_red = sys["H_cc"] - jnp.dot((W * Hpp_inv[:, None]).T, W, precision=_HI)
    g_red = sys["g_c"] - jnp.dot(W.T, Hpp_inv * sys["g_p"], precision=_HI)

    # damping + gauge fixing: zero rows/cols of fixed cameras, unit diagonal
    diag = jnp.diag(H_red)
    H_red = H_red + jnp.diag(diag * lam)
    free6 = jnp.repeat(free_kf_mask, 6)
    m = free6.astype(jnp.float32)
    H_red = H_red * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
    g_red = g_red * m

    delta_c = jnp.linalg.solve(H_red, g_red)
    delta_c = jnp.where(jnp.isfinite(delta_c), delta_c, 0.0) * m
    delta_p = Hpp_inv * (sys["g_p"] - jnp.dot(W, delta_c, precision=_HI))
    return delta_c, delta_p


def _apply(T_kf, idist, delta_c, delta_p, point_valid, n_kf: int):
    d = delta_c.reshape(n_kf, 6)
    T_new = se3.mul(se3.exp(d), T_kf)
    idist_new = jnp.where(point_valid, idist + delta_p, idist)
    return T_new, idist_new


@functools.partial(
    jax.jit, static_argnames=("n_kf", "n_pts", "n_iter", "focal", "strip_px")
)
def local_bundle_adjustment(
    T_kf,              # (K,3,4)
    free_kf,           # (K,) bool — False = held fixed
    idist,             # (P,)
    point_valid,       # (P,) bool
    obs,               # dense (P,K) observation dict (module docstring)
    n_kf: int,
    n_pts: int,
    n_iter: int = 10,
    focal: float = 450.0,
    strip_px: float = 2.0,   # corner strip threshold (Config::lobaThresh);
                             # edgelets strip at 0.6× (ref 2.0/1.2 px)
):
    """Run windowed BA; returns dict(T_kf, idist, obs_inlier, chi2_init,
    chi2_final, deltas).

    One linearization per LM iteration: the carried reduced system is reused
    for the solve and the accept test compares against the freshly built
    system at the trial state (n_iter + 1 builds total).
    """
    T_kf = jnp.asarray(T_kf, jnp.float32)
    idist = jnp.asarray(idist, jnp.float32)

    deltas = compute_deltas(T_kf, idist, obs, focal)
    sys0 = build_reduced_system(T_kf, idist, obs, deltas, n_kf, n_pts)
    chi2_init = sys0["chi2"]
    lam0 = 1e-5 * jnp.maximum(jnp.max(jnp.diag(sys0["H_cc"])), 1.0)

    def body(i, carry):
        T_c, id_c, lam, nu, sys_c = carry
        dc, dp = _schur_solve(sys_c, free_kf, lam, n_kf)
        T_new, id_new = _apply(T_c, id_c, dc, dp, point_valid, n_kf)
        sys_new = build_reduced_system(T_new, id_new, obs, deltas, n_kf, n_pts)
        accept = sys_new["chi2"] < sys_c["chi2"]
        T_c = jnp.where(accept, T_new, T_c)
        id_c = jnp.where(accept, id_new, id_c)
        sys_c = jax.tree.map(lambda a, b: jnp.where(accept, b, a), sys_c, sys_new)
        lam = jnp.where(accept, lam * 0.5, jnp.minimum(lam * nu, 1e7))
        nu = jnp.where(accept, 2.0, nu * 2.0)
        return T_c, id_c, lam, nu, sys_c

    with jax.named_scope("ba_lm"):
        T_kf, idist, _, _, sys_f = jax.lax.fori_loop(
            0, n_iter, body, (T_kf, idist, lam0, jnp.float32(2.0), sys0)
        )

    # ---- outlier stripping (bundle_adjustment.cpp:843-892) — the carried
    # system's rn is already at the final accepted state ----
    thresh = jnp.where(
        obs["is_edgelet"], 0.6 * strip_px / focal, strip_px / focal
    )
    obs_inlier = obs["valid"] & (sys_f["rn"] <= thresh)

    return {
        "T_kf": T_kf,
        "idist": idist,
        "obs_inlier": obs_inlier,
        "chi2_init": chi2_init,
        "chi2_final": sys_f["chi2"],
        "deltas": deltas,
    }
