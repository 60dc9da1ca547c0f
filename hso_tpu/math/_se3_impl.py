"""SE(3) rigid transforms, templated over the array namespace.

A transform is a ``(..., 3, 4)`` array ``[R | t]`` mapping points from the
source frame into the destination frame: ``p_dst = R @ p_src + t``.  The
tangent ordering is ``xi = [rho (translation), phi (rotation)]`` — the same
convention as the Sophus ``SE3::exp`` the reference uses for every pose
(/root/reference/thirdparty/Sophus/sophus/se3.h).

``_make_se3(xp)`` builds the full function set for a namespace; it is
instantiated twice: ``hso_tpu.math.se3`` (jax.numpy — jit/vmap-able, used
inside device kernels) and ``hso_tpu.math.se3np`` (numpy float64 — used by the
host-side pipeline bookkeeping where sequential double-precision pose chains
are cheap and device dispatch would dominate).

All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import types


def _make_se3(xp, float_dtype) -> types.SimpleNamespace:
    eps = 1e-8 if float_dtype_name(float_dtype) == "float64" else 1e-6

    def identity(batch_shape=()):
        I = xp.concatenate(
            [xp.eye(3, dtype=float_dtype), xp.zeros((3, 1), dtype=float_dtype)], axis=-1
        )
        out = xp.broadcast_to(I, tuple(batch_shape) + (3, 4))
        return out.copy() if xp.__name__ == "numpy" else out

    def from_Rt(R, t):
        t = xp.asarray(t, dtype=float_dtype)
        R = xp.asarray(R, dtype=float_dtype)
        return xp.concatenate([R, t[..., :, None]], axis=-1)

    def rotation(T):
        return T[..., :3, :3]

    def translation(T):
        return T[..., :3, 3]

    # NOTE: all small contractions below are written as broadcast
    # multiply+sum rather than einsum/@: full f32 arithmetic on every
    # backend (a GPU may run an f32 matmul in TF32), and XLA fuses the
    # broadcast form into elementwise code instead of micro matmuls.
    def _mv(R, v):
        return xp.sum(R * v[..., None, :], axis=-1)

    def _mm(A, B):
        return xp.sum(A[..., :, :, None] * B[..., None, :, :], axis=-2)

    def mul(A, B):
        """Compose: (A*B) maps via B first, then A."""
        R = _mm(rotation(A), rotation(B))
        t = _mv(rotation(A), translation(B)) + translation(A)
        return from_Rt(R, t)

    def inv(T):
        Rt = xp.swapaxes(rotation(T), -1, -2)
        t = -_mv(Rt, translation(T))
        return from_Rt(Rt, t)

    def apply(T, p):
        """Transform points ``p`` (..., 3)."""
        return _mv(rotation(T), p) + translation(T)

    def rotate(T, p):
        return _mv(rotation(T), p)

    def hat(phi):
        """so(3) hat: (...,3) -> (...,3,3)."""
        x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
        zero = xp.zeros_like(x)
        rows = xp.stack(
            [
                xp.stack([zero, -z, y], axis=-1),
                xp.stack([z, zero, -x], axis=-1),
                xp.stack([-y, x, zero], axis=-1),
            ],
            axis=-2,
        )
        return rows

    def so3_exp(phi):
        """Rodrigues formula with small-angle Taylor guard."""
        theta2 = xp.sum(phi * phi, axis=-1)
        theta = xp.sqrt(theta2 + eps * eps) - eps  # smooth, ~theta for large
        # series-safe coefficients
        small = theta2 < eps
        theta2s = xp.where(small, xp.ones_like(theta2), theta2)
        thetas = xp.sqrt(theta2s)
        sin_t = xp.sin(thetas)
        cos_t = xp.cos(thetas)
        a = xp.where(small, 1.0 - theta2 / 6.0, sin_t / thetas)
        b = xp.where(small, 0.5 - theta2 / 24.0, (1.0 - cos_t) / theta2s)
        K = hat(phi)
        I = xp.eye(3, dtype=float_dtype)
        I = xp.broadcast_to(I, K.shape)
        return I + a[..., None, None] * K + b[..., None, None] * _mm(K, K)

    def so3_log(R):
        """Inverse Rodrigues; returns (...,3)."""
        trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
        cos_theta = xp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
        theta = xp.arccos(cos_theta)
        vee = xp.stack(
            [
                R[..., 2, 1] - R[..., 1, 2],
                R[..., 0, 2] - R[..., 2, 0],
                R[..., 1, 0] - R[..., 0, 1],
            ],
            axis=-1,
        )
        small = theta < eps
        sin_theta = xp.sin(theta)
        sin_safe = xp.where(small, xp.ones_like(sin_theta), sin_theta)
        # theta/(2 sin(theta)), -> 1/2 + theta^2/12 for small angle
        scale = xp.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_safe))
        # NOTE: near theta == pi the vee form degrades; the windowed VO never
        # composes ~pi relative rotations in one step, and tests cover to ~3.1.
        near_pi = theta > 3.1415
        if xp.__name__ == "numpy":
            if bool(xp.any(near_pi)):
                return _log_near_pi(R, theta, vee, scale)
        return scale[..., None] * vee

    def _log_near_pi(R, theta, vee, scale):
        # numpy-only exact fallback for rotations near pi (host bookkeeping).
        out = scale[..., None] * vee
        it = xp.nditer(theta, flags=["multi_index"])
        for th in it:
            if th <= 3.1415:
                continue
            idx = it.multi_index
            Ri = R[idx]
            # axis from the largest diagonal of (R + I)/2
            B = (Ri + xp.eye(3)) * 0.5
            k = int(xp.argmax(xp.diagonal(B)))
            axis = B[:, k] / xp.sqrt(max(B[k, k], 1e-12))
            axis = axis / xp.linalg.norm(axis)
            # fix sign with vee
            if xp.dot(axis, vee[idx]) < 0:
                axis = -axis
            out[idx] = axis * float(th)
        return out

    def _V(phi):
        """Left Jacobian of SO(3) (the 'V' matrix in SE3 exp)."""
        theta2 = xp.sum(phi * phi, axis=-1)
        small = theta2 < eps
        theta2s = xp.where(small, xp.ones_like(theta2), theta2)
        theta = xp.sqrt(theta2s)
        b = xp.where(small, 0.5 - theta2 / 24.0, (1.0 - xp.cos(theta)) / theta2s)
        c = xp.where(
            small, 1.0 / 6.0 - theta2 / 120.0, (theta - xp.sin(theta)) / (theta2s * theta)
        )
        K = hat(phi)
        I = xp.broadcast_to(xp.eye(3, dtype=float_dtype), K.shape)
        return I + b[..., None, None] * K + c[..., None, None] * _mm(K, K)

    def _V_inv(phi):
        theta2 = xp.sum(phi * phi, axis=-1)
        small = theta2 < eps
        theta2s = xp.where(small, xp.ones_like(theta2), theta2)
        theta = xp.sqrt(theta2s)
        half = theta * 0.5
        # 1/theta^2 (1 - theta sin / (2(1-cos)))  -> 1/12 + theta^2/720 small
        cot = xp.where(
            small,
            1.0 / 12.0 + theta2 / 720.0,
            (1.0 - half * xp.cos(half) / xp.sin(half)) / theta2s,
        )
        K = hat(phi)
        I = xp.broadcast_to(xp.eye(3, dtype=float_dtype), K.shape)
        return I - 0.5 * K + cot[..., None, None] * _mm(K, K)

    def exp(xi):
        """xi (...,6) = [rho, phi] -> (...,3,4)."""
        xi = xp.asarray(xi, dtype=float_dtype)
        rho, phi = xi[..., :3], xi[..., 3:]
        R = so3_exp(phi)
        t = _mv(_V(phi), rho)
        return from_Rt(R, t)

    def log(T):
        phi = so3_log(rotation(T))
        rho = _mv(_V_inv(phi), translation(T))
        return xp.concatenate([rho, phi], axis=-1)

    def adjoint(T):
        """Adj so that exp(Adj(T) xi) * T == T * exp(xi); ordering [rho, phi]."""
        R = rotation(T)
        tK = hat(translation(T))
        top = xp.concatenate([R, _mm(tK, R)], axis=-1)
        bot = xp.concatenate([xp.zeros_like(R), R], axis=-1)
        return xp.concatenate([top, bot], axis=-2)

    def normalize(T):
        """Re-orthonormalise R by SVD (host hygiene after long compositions)."""
        U, _, Vt = xp.linalg.svd(rotation(T))
        det = xp.linalg.det(_mm(U, Vt))
        D = xp.broadcast_to(xp.eye(3, dtype=float_dtype), U.shape).copy() \
            if xp.__name__ == "numpy" else xp.broadcast_to(xp.eye(3, dtype=float_dtype), U.shape)
        if xp.__name__ == "numpy":
            D[..., 2, 2] = det
        else:
            D = D.at[..., 2, 2].set(det)
        return from_Rt(_mm(_mm(U, D), Vt), translation(T))

    return types.SimpleNamespace(
        identity=identity,
        from_Rt=from_Rt,
        rotation=rotation,
        translation=translation,
        mul=mul,
        inv=inv,
        apply=apply,
        rotate=rotate,
        hat=hat,
        so3_exp=so3_exp,
        so3_log=so3_log,
        exp=exp,
        log=log,
        adjoint=adjoint,
        normalize=normalize,
        dtype=float_dtype,
    )


def float_dtype_name(dt) -> str:
    return getattr(dt, "__name__", None) or str(dt)
