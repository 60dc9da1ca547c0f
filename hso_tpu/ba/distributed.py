"""Multi-device sliding-window BA: point-block-sharded Schur reduction.

The BASELINE.json north-star config: keyframe and map-point blocks
partitioned across a device mesh, distributed BA via Schur-complement
reduction with a ``psum`` of the camera-camera Hessian blocks.  The
reference has no analogue (single process, g2o, shared memory — SURVEY.md
§2.3).

Scheme (v3 — dense (P, K) observation grid, point axis sharded):
  * the observation grid of ``hso_tpu.ba.local_ba`` is (P, K) — sharding the
    point axis in contiguous blocks automatically places every observation
    cell on the device that owns its point; the host-side partitioner is
    just zero-padding P to a multiple of the mesh size (no row shuffling,
    nothing dropped),
  * each device linearizes only its own grid slice —
    :func:`hso_tpu.ba.local_ba.build_reduced_system` is a pure sum over
    cells — so the landmark blocks ``H_pp``/``g_p`` and the point-camera
    coupling ``W`` stay LOCAL; per-device memory scales as P/n,
  * the Schur reduction needs only the (6K, 6K) reduced camera system
    globally: each device computes ``Wᵀ·H_pp⁻¹·W`` and ``Wᵀ·H_pp⁻¹·g_p``
    over its point block and the small results are ``psum``-reduced
    together with its partial ``H_cc``/``g_c``/chi²,
  * the damped solve of the reduced camera system runs replicated (6K ≤ 96
    unknowns); landmark back-substitution is local per point block,
  * the whole LM loop lives inside one ``shard_map`` call — one dispatch per
    solve, collectives inside; one linearization per LM iteration (the
    carried system is reused across reject steps, exactly like the
    single-device solver).

Robust deltas are passed in (compute them with
:func:`hso_tpu.ba.local_ba.compute_deltas`) since medians don't distribute
as sums.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hso_tpu.ba.local_ba import (
    OBS_KEYS,
    _apply,
    build_reduced_system,
    compute_deltas,
    residual_norms,
    residuals_and_jacobians,
)

_HI = jax.lax.Precision.HIGHEST

#: observation-dict keys indexed by point (sharded); everything in OBS_KEYS
#: has a leading P axis in the dense layout.
_P_SHARDED = OBS_KEYS


def make_distributed_ba(mesh: Mesh, n_kf: int, n_pts_local: int,
                        n_iter: int = 10, axis: str = "pts"):
    """Build the jitted distributed BA step for a fixed mesh/shape config.

    The returned function takes
      (T_kf (K,3,4) replicated, free_kf (K,) replicated,
       idist (n_dev·P_l,) point-sharded, point_valid point-sharded,
       obs dict with leading P axis sharded, delta_corner, delta_edge)
    and returns (T_kf', idist' (point-sharded), chi2_final).
    """
    K = n_kf

    def shard_fn(T_kf, free_kf, idist, point_valid, obs, delta_c_, delta_e_):
        deltas = (delta_c_, delta_e_)

        def build(T_c, id_c):
            sys = build_reduced_system(T_c, id_c, obs, deltas, K, n_pts_local)
            # only the camera system and the scalar energy are global;
            # H_pp/g_p/W/rn stay local to this point block
            for k in ("H_cc", "g_c", "chi2"):
                sys[k] = jax.lax.psum(sys[k], axis)
            return sys

        def schur_solve(sys, lam):
            H_pp_d = sys["H_pp"] * (1.0 + lam) + 1e-12
            Hpp_inv = 1.0 / H_pp_d
            W = sys["W"]                                     # (P_l, 6K) local
            H_red = sys["H_cc"] - jax.lax.psum(
                jnp.dot((W * Hpp_inv[:, None]).T, W, precision=_HI), axis)
            g_red = sys["g_c"] - jax.lax.psum(
                jnp.dot(W.T, Hpp_inv * sys["g_p"], precision=_HI), axis)

            diag = jnp.diag(H_red)
            H_red = H_red + jnp.diag(diag * lam)
            free6 = jnp.repeat(free_kf, 6)
            m = free6.astype(jnp.float32)
            H_red = H_red * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
            g_red = g_red * m
            delta_c = jnp.linalg.solve(H_red, g_red)
            delta_c = jnp.where(jnp.isfinite(delta_c), delta_c, 0.0) * m
            delta_p = Hpp_inv * (sys["g_p"] - jnp.dot(W, delta_c, precision=_HI))   # local
            return delta_c, delta_p

        def body(i, carry):
            T_c, id_c, lam, nu, sys_c = carry
            dc, dp = schur_solve(sys_c, lam)
            T_new, id_new = _apply(T_c, id_c, dc, dp, point_valid, K)
            sys_new = build(T_new, id_new)
            accept = sys_new["chi2"] < sys_c["chi2"]
            T_c = jnp.where(accept, T_new, T_c)
            id_c = jnp.where(accept, id_new, id_c)
            sys_c = jax.tree.map(
                lambda a, b: jnp.where(accept, b, a), sys_c, sys_new)
            lam = jnp.where(accept, lam * 0.5, jnp.minimum(lam * nu, 1e7))
            nu = jnp.where(accept, 2.0, nu * 2.0)
            return T_c, id_c, lam, nu, sys_c

        sys0 = build(T_kf, idist)
        lam0 = 1e-5 * jnp.maximum(jnp.max(jnp.diag(sys0["H_cc"])), 1.0)
        T_f, id_f, _, _, sys_f = jax.lax.fori_loop(
            0, n_iter, body, (T_kf, idist, lam0, jnp.float32(2.0), sys0)
        )
        return T_f, id_f, sys_f["chi2"], sys_f["rn"]

    obs_spec = {k: P(axis) for k in _P_SHARDED}
    rep = P()
    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(rep, rep, P(axis), P(axis), obs_spec, rep, rep),
        out_specs=(rep, P(axis), rep, P(axis)),
        check_vma=False,
    )
    return jax.jit(fn)


_DBA_CACHE: dict = {}


def distributed_bundle_adjustment(
    T_kf, free_kf, idist, point_valid, obs,
    n_kf: int, n_pts: int, n_iter: int = 10, focal: float = 450.0,
    strip_px: float = 2.0, n_devices: int = 0,
):
    """Drop-in replacement for :func:`hso_tpu.ba.local_ba.
    local_bundle_adjustment` that runs the LM loop point-block-sharded over
    the available device mesh (``Config.distributed_ba`` routes the live
    pipeline here, ba_glue.run_local_ba).

    Same inputs/outputs as the single-device solver; ``n_devices`` 0 means
    all devices of the default backend.  Outlier stripping semantics match
    local_ba (/root/reference/src/bundle_adjustment.cpp:843-892) via the
    final carried residual norms.
    """
    import numpy as np

    devs = jax.devices()
    nd = n_devices or len(devs)
    nd = min(nd, len(devs))

    obs_j = {k: jnp.asarray(v) for k, v in obs.items()}
    T_kf = jnp.asarray(T_kf, jnp.float32)
    idist = jnp.asarray(idist, jnp.float32)
    deltas = compute_deltas(T_kf, idist, obs_j, focal)

    obs_s, idist_s, pv_s, p_local = shard_problem(
        obs_j, idist, point_valid, nd)

    key = (nd, n_kf, p_local, n_iter)
    if key not in _DBA_CACHE:
        mesh = Mesh(np.array(devs[:nd]), axis_names=("pts",))
        _DBA_CACHE[key] = (mesh, make_distributed_ba(
            mesh, n_kf=n_kf, n_pts_local=p_local, n_iter=n_iter))
    mesh, step = _DBA_CACHE[key]

    T_f, idist_f, chi2_final, rn_f = step(
        T_kf, jnp.asarray(free_kf), jnp.asarray(idist_s), jnp.asarray(pv_s),
        shard_obs({k: jnp.asarray(v) for k, v in obs_s.items()}, mesh),
        *deltas,
    )
    idist_out = jnp.asarray(np.asarray(idist_f)[:n_pts])
    rn_f = jnp.asarray(np.asarray(rn_f)[:n_pts])

    # chi2_init on the original grid
    r0, _, _, _, sqrt_info = residuals_and_jacobians(T_kf, idist, obs_j)
    rn0 = residual_norms(r0, obs_j, sqrt_info)
    from hso_tpu.ba.local_ba import huber_chi2

    chi2_init = huber_chi2(rn0, obs_j["is_edgelet"], obs_j["valid"], *deltas)
    thresh = jnp.where(
        obs_j["is_edgelet"], 0.6 * strip_px / focal, strip_px / focal
    )
    obs_inlier = obs_j["valid"] & (rn_f <= thresh)

    return {
        "T_kf": T_f,
        "idist": idist_out,
        "obs_inlier": obs_inlier,
        "chi2_init": chi2_init,
        "chi2_final": chi2_final,
        "deltas": deltas,
    }


def shard_obs(obs: dict, mesh: Mesh, axis: str = "pts") -> dict:
    """Place observation arrays sharded over the mesh axis."""
    out = {}
    for k, v in obs.items():
        out[k] = jax.device_put(v, NamedSharding(mesh, P(axis)))
    return out


def shard_problem(obs, idist, point_valid, n_dev: int):
    """Host-side partitioner: dense (P, K) problem → point-block layout.

    With the dense grid, sharding is pure padding: point slot s belongs to
    device ``s // p_local`` and every observation cell already sits on its
    point's row.  Nothing moves, nothing is dropped.

    Returns (obs_padded, idist_padded, point_valid_padded, p_local);
    arrays are numpy, ready for ``shard_obs``/``device_put``.
    """
    import numpy as np

    obs = {k: np.asarray(v) for k, v in obs.items()}
    idist = np.asarray(idist)
    point_valid = np.asarray(point_valid)
    p_total = idist.shape[0]
    p_local = -(-p_total // n_dev)
    pad_p = n_dev * p_local - p_total

    idist_s = np.pad(idist, (0, pad_p))
    pv_s = np.pad(point_valid, (0, pad_p))
    out = {k: np.pad(v, [(0, pad_p)] + [(0, 0)] * (v.ndim - 1))
           for k, v in obs.items()}
    return out, idist_s, pv_s, p_local
