"""Online photometric calibration: camera response, vignette, exposure.

The reference ships a ``PhotomatricCalibration`` module implementing
Bergmann/Wang/Cremers "Online Photometric Calibration of Auto Exposure Video
for Realtime Visual Odometry and SLAM" (RA-L 2018), but it is compiled out
everywhere (/root/reference/CMakeLists.txt:100,
/root/reference/src/frame_handler_mono.cpp:53-56); only the exposure-*ratio*
estimate inside the coarse tracker is live.  For TUM MonoVO-class sequences
(auto-exposure, strong vignette) full calibration is required, so this module
provides it, batched: the whole estimation is one masked solve over
a dense observation table instead of the reference's per-point C++ loops.

Model (same as RA-L'18):  O = f( e_j · V(r) · L_p )  — observed intensity O
of scene point p in frame j with exposure e_j, vignette V at normalized
radius r, radiance L_p, camera response f.  Taking logs of the inverse
response U = f⁻¹:

    log U(O_{jp}) = log e_j + log V(r_{jp}) + log L_p

with parameterizations keeping everything positive/monotone:

  * log U(x) = log x + Σ_k c_k φ_k(x),  φ_k(x) = xᵏ(1-x) on x = O/255 —
    so U(255) = 255 (scale gauge) and U ≈ identity for c = 0,
  * log V(R) = v₁R + v₂R² + v₃R³ on R = r²/r²_max — so V(0) = 1,
  * gauge: log e of the first frame = 0.

The joint problem is bilinear; it is solved by masked alternating
closed-form updates (radiances ← exposures ← response+vignette coefficients,
the last a (K+3)-dim ridge-regularized normal solve), with Huber IRLS
reweighting.  All steps are dense masked array ops — one jit, no loops over
points or frames.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

N_RESP = 4            #: response basis size (RA-L uses 4 EMoR components)
N_VIG = 3             #: vignette polynomial order (RA-L: radial poly in r²)
INT_LO = 3.0          #: usable intensity range (saturation exclusion)
INT_HI = 252.0
_RIDGE = 1e-4
_HI = jax.lax.Precision.HIGHEST


def _resp_basis(x_norm: jnp.ndarray) -> jnp.ndarray:
    """φ_k(x) = x^k (1-x), k=1..N_RESP → (..., N_RESP)."""
    feats = [x_norm ** k * (1.0 - x_norm) for k in range(1, N_RESP + 1)]
    return jnp.stack(feats, axis=-1)


def _vig_basis(r2_norm: jnp.ndarray) -> jnp.ndarray:
    """R^m, m=1..N_VIG → (..., N_VIG)."""
    return jnp.stack([r2_norm ** m for m in range(1, N_VIG + 1)], axis=-1)


def log_inverse_response(intensity: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """log U(O) for O in [0, 255] (clamped to the usable range)."""
    x = jnp.clip(intensity, 1e-3, 255.0) / 255.0
    return jnp.log(x * 255.0) + jnp.dot(_resp_basis(x), c, precision=_HI)


def log_vignette(r2_norm: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    return jnp.dot(_vig_basis(r2_norm), v, precision=_HI)


@functools.partial(jax.jit, static_argnames=("n_rounds",))
def solve_photometric(
    obs_int,            # (F, M) raw intensities
    obs_r2,             # (F, M) normalized squared radii in [0, 1]
    obs_valid,          # (F, M) bool
    n_rounds: int = 40,
    huber: float = 0.1,
):
    """Alternating masked solve of the RA-L'18 energy.

    Returns dict(c (N_RESP,), v (N_VIG,), log_e (F,), log_L (M,),
    rms_before, rms_after, n_obs).
    """
    f_n, m_n = obs_int.shape
    valid = obs_valid & (obs_int > INT_LO) & (obs_int < INT_HI)
    w_base = valid.astype(jnp.float32)

    phi = _resp_basis(jnp.clip(obs_int, 1e-3, 255.0) / 255.0)   # (F, M, K)
    psi = _vig_basis(obs_r2)                                    # (F, M, 3)
    log_o = jnp.log(jnp.clip(obs_int, 1e-3, 255.0))

    def residual(c, v, log_e, log_l):
        lu = log_o + jnp.dot(phi, c, precision=_HI)
        lv = jnp.dot(psi, v, precision=_HI)
        return lu - lv - log_e[:, None] - log_l[None, :]

    def masked_mean(x, w, axis):
        return jnp.sum(x * w, axis=axis) / jnp.maximum(jnp.sum(w, axis=axis), 1e-9)

    def body(_, carry):
        c, v, log_e, log_l = carry
        # Huber IRLS weights from the current residual
        r = residual(c, v, log_e, log_l)
        w = w_base * jnp.minimum(1.0, huber / jnp.maximum(jnp.abs(r), 1e-9))

        lu = log_o + jnp.dot(phi, c, precision=_HI)
        lv = jnp.dot(psi, v, precision=_HI)
        # 1. radiances
        log_l = masked_mean(lu - lv - log_e[:, None], w, axis=0)
        # 2. exposures (gauge: first frame = 0)
        log_e = masked_mean(lu - lv - log_l[None, :], w, axis=1)
        log_e = log_e - log_e[0]
        # 3. response + vignette coefficients: joint (K+3) ridge LS on
        #    Φc - Ψv = y,  y = log_e + log_L - log O
        y = log_e[:, None] + log_l[None, :] - log_o
        A = jnp.concatenate([phi, -psi], axis=-1)               # (F, M, K+3)
        Aw = A * w[..., None]
        H = jnp.einsum("fmi,fmj->ij", Aw, A, precision=_HI) + _RIDGE * jnp.eye(N_RESP + N_VIG)
        g = jnp.einsum("fmi,fm->i", Aw, y, precision=_HI)
        sol = jnp.linalg.solve(H, g)
        return (sol[:N_RESP], sol[N_RESP:], log_e, log_l)

    c0 = jnp.zeros((N_RESP,), jnp.float32)
    v0 = jnp.zeros((N_VIG,), jnp.float32)
    le0 = jnp.zeros((f_n,), jnp.float32)
    ll0 = jnp.sum(log_o * w_base, 0) / jnp.maximum(jnp.sum(w_base, 0), 1e-9)
    r0 = residual(c0, v0, le0, ll0)
    rms_before = jnp.sqrt(
        jnp.sum(r0 * r0 * w_base) / jnp.maximum(jnp.sum(w_base), 1e-9)
    )
    c, v, log_e, log_l = jax.lax.fori_loop(
        0, n_rounds, body, (c0, v0, le0, ll0)
    )
    r1 = residual(c, v, log_e, log_l)
    rms_after = jnp.sqrt(
        jnp.sum(r1 * r1 * w_base) / jnp.maximum(jnp.sum(w_base), 1e-9)
    )
    return {
        "c": c, "v": v, "log_e": log_e, "log_L": log_l,
        "rms_before": rms_before, "rms_after": rms_after,
        "n_obs": jnp.sum(w_base),
    }


@jax.jit
def correct_image(img, c, v, r2_norm_img):
    """Photometrically linearize a frame:  I_corr = U(I) / V(r) · g.

    Analytic application (exp/log elementwise) — no LUT gather.  The gauge
    factor g = 128 / U(128) keeps mid-grey fixed: the model's scale gauge
    is U(255)=255, so a strong response estimate (e.g. inverting γ≈0.5)
    would otherwise crush most of the intensity range toward black and
    starve the gradient-based detector/tracker of contrast; the tracker's
    per-frame exposure-ratio estimate absorbs the global gain.  I = 0 maps
    to 0; output clipped to [0, 255].
    """
    img_f = img.astype(jnp.float32)
    lu = log_inverse_response(img_f, c)
    lv = log_vignette(r2_norm_img, v)
    lg = jnp.log(128.0) - log_inverse_response(jnp.float32(128.0), c)
    out = jnp.exp(lu - lv + lg)
    out = jnp.where(img_f <= 0.0, 0.0, out)
    return jnp.clip(out, 0.0, 255.0)


def inverse_response_curve(c, n: int = 256) -> np.ndarray:
    """U over [0, 255] as a host array (diagnostics / export)."""
    x = jnp.linspace(0.0, 255.0, n)
    u = jnp.exp(log_inverse_response(x, jnp.asarray(c, jnp.float32)))
    u = jnp.where(x <= 0.0, 0.0, u)
    return np.asarray(u)


def vignette_map(v, height: int, width: int, cx: float, cy: float) -> np.ndarray:
    """V(r) over the image plane, normalized by the max corner radius."""
    yy, xx = np.mgrid[0:height, 0:width]
    r2 = (xx - cx) ** 2 + (yy - cy) ** 2
    r2max = max(
        (0 - cx) ** 2 + (0 - cy) ** 2,
        (width - 1 - cx) ** 2 + (0 - cy) ** 2,
        (0 - cx) ** 2 + (height - 1 - cy) ** 2,
        (width - 1 - cx) ** 2 + (height - 1 - cy) ** 2,
    )
    r2n = jnp.asarray(r2 / r2max, jnp.float32)
    return np.asarray(jnp.exp(log_vignette(r2n, jnp.asarray(v, jnp.float32))))


class OnlinePhotometricCalibrator:
    """Host-side orchestration: sample tracked-point intensities from raw
    frames, periodically run :func:`solve_photometric` over a sliding window,
    and linearize incoming images with the current estimate.

    The pipeline samples observations from RAW images (so estimates do not
    compound with the applied correction), exactly as the RA-L'18 online
    formulation prescribes.
    """

    def __init__(self, cam, window: int = 48, solve_every: int = 16,
                 min_frames: int = 12, max_points: int = 384):
        self.cam = cam
        self.window = window
        self.solve_every = solve_every
        self.min_frames = min_frames
        self.max_points = max_points
        self.cx, self.cy = float(cam.cx), float(cam.cy)
        self.r2_max = max(
            (0 - self.cx) ** 2 + (0 - self.cy) ** 2,
            (cam.width - 1 - self.cx) ** 2 + (0 - self.cy) ** 2,
            (0 - self.cx) ** 2 + (cam.height - 1 - self.cy) ** 2,
            (cam.width - 1 - self.cx) ** 2 + (cam.height - 1 - self.cy) ** 2,
        )
        yy, xx = np.mgrid[0:cam.height, 0:cam.width]
        self._r2_img = jnp.asarray(
            ((xx - self.cx) ** 2 + (yy - self.cy) ** 2) / self.r2_max,
            jnp.float32,
        )
        self.frames: list[dict] = []   # each: {pid: (M,), inten: (M,), r2: (M,)}
        self.c = np.zeros(N_RESP, np.float32)
        self.v = np.zeros(N_VIG, np.float32)
        self.calibrated = False
        self.last_rms = (0.0, 0.0)
        self._since_solve = 0

    # ---------------------------------------------------------------- ingest
    def add_frame_samples(self, raw_img: np.ndarray, obs: dict) -> None:
        """Record raw intensities of this frame's matched points.

        ``raw_img`` is the UNcorrected u8/float image; ``obs`` the frame's
        observation table (px + point_id + valid).
        """
        sel = obs["valid"] & (obs["point_id"] >= 0)
        if sel.sum() < 8:
            return
        px = obs["px"][sel]
        u = np.clip(px[:, 0], 0, raw_img.shape[1] - 2)
        v = np.clip(px[:, 1], 0, raw_img.shape[0] - 2)
        u0 = u.astype(np.int64)
        v0 = v.astype(np.int64)
        fu = (u - u0).astype(np.float32)
        fv = (v - v0).astype(np.float32)
        img = raw_img.astype(np.float32)
        inten = (
            img[v0, u0] * (1 - fu) * (1 - fv)
            + img[v0, u0 + 1] * fu * (1 - fv)
            + img[v0 + 1, u0] * (1 - fu) * fv
            + img[v0 + 1, u0 + 1] * fu * fv
        )
        r2 = ((px[:, 0] - self.cx) ** 2 + (px[:, 1] - self.cy) ** 2) / self.r2_max
        self.frames.append({
            "pid": obs["point_id"][sel].copy(),
            "inten": inten,
            "r2": r2.astype(np.float32),
        })
        if len(self.frames) > self.window:
            self.frames.pop(0)
        self._since_solve += 1
        if self._since_solve >= self.solve_every and len(self.frames) >= self.min_frames:
            self.solve()
            self._since_solve = 0

    # ----------------------------------------------------------------- solve
    def solve(self) -> dict | None:
        if len(self.frames) < self.min_frames:
            return None
        # points observed in >= 3 window frames, most-observed first
        counts: dict[int, int] = {}
        for fr in self.frames:
            for p in fr["pid"]:
                counts[int(p)] = counts.get(int(p), 0) + 1
        pids = [p for p, n in counts.items() if n >= 3]
        if len(pids) < 16:
            return None
        pids.sort(key=lambda p: -counts[p])
        pids = pids[: self.max_points]
        col = {p: i for i, p in enumerate(pids)}

        f_n, m_n = len(self.frames), len(pids)
        inten = np.zeros((f_n, m_n), np.float32)
        r2 = np.zeros((f_n, m_n), np.float32)
        valid = np.zeros((f_n, m_n), bool)
        for j, fr in enumerate(self.frames):
            for p, o, r in zip(fr["pid"], fr["inten"], fr["r2"]):
                i = col.get(int(p))
                if i is not None:
                    inten[j, i] = o
                    r2[j, i] = r
                    valid[j, i] = True

        out = solve_photometric(
            jnp.asarray(inten), jnp.asarray(r2), jnp.asarray(valid)
        )
        c_new = np.asarray(out["c"])
        v_new = np.asarray(out["v"])
        rms_b, rms_a = float(out["rms_before"]), float(out["rms_after"])
        self.last_rms = (rms_b, rms_a)
        # ---- adoption gates: a mis-fit under occlusion/noise must never
        # poison tracking (correct() feeds every downstream stage).  Require
        # (a) finite, (b) a genuinely better fit than the identity model,
        # (c) a small absolute residual, (d) sane correction magnitudes:
        # vignette within [0.25, 1.3] at the corners, response deviation
        # |Σ c φ| < 1.2 in log space over the usable range. ----
        ok = (np.all(np.isfinite(c_new)) and np.all(np.isfinite(v_new))
              and rms_a < 0.85 * rms_b and rms_a < 0.15)
        if ok:
            x = np.linspace(0.05, 0.99, 64)
            resp_dev = sum(c_new[k - 1] * x ** k * (1 - x)
                           for k in range(1, N_RESP + 1))
            vig_corner = np.exp(np.sum(v_new * np.ones(N_VIG)))
            # the fitted inverse response must be a plausible camera curve:
            # bounded deviation, strictly monotone, and with a bounded
            # dynamic range of slopes (a true gamma≈0.5 curve has slope
            # ratio ~15 over this interval; oscillatory runaway fits — the
            # failure mode under heavy noise+occlusion — have negative or
            # wildly varying slopes long before their residual degrades)
            log_u = np.log(x) + resp_dev
            du = np.diff(log_u) / np.diff(np.log(x))   # d logU / d log x
            ok = (np.max(np.abs(resp_dev)) < 1.2
                  and 0.25 < vig_corner < 1.3
                  and np.all(du > 0.05)
                  and np.max(du) / max(np.min(du), 1e-6) < 25.0)
        if ok:
            if self.calibrated:
                # smooth coefficient updates: per-solve jumps in the applied
                # response shape look like global illumination steps to the
                # tracker between consecutive frames
                self.c = 0.7 * self.c + 0.3 * c_new
                self.v = 0.7 * self.v + 0.3 * v_new
            else:
                self.c, self.v = c_new, v_new
            self.calibrated = True
        return {k: np.asarray(v) for k, v in out.items()}

    # ---------------------------------------------------------------- apply
    def correct(self, img: np.ndarray):
        """Linearized image (device array) — identity until calibrated."""
        if not self.calibrated:
            return img
        return correct_image(
            jnp.asarray(img), jnp.asarray(self.c), jnp.asarray(self.v),
            self._r2_img,
        )
