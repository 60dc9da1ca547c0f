"""Photometric-calibration must-win artifact: curve recovery.

VERDICT r4 item 6: the torture A/B (boxseq_hard) showed the exposure-ratio
+ ZMNCC machinery absorbs static radiometry for TRACKING — so this artifact
measures the thing online calibration actually deliverables in the
TUM-MonoVO protocol (Bergmann/Wang/Cremers RA-L'18): the RECOVERED inverse
response and vignette curves against ground truth.

Chain: every rendered frame (treated as the linear radiance field L) is
observed as  O = f( e_j · V(r) · L )  with

  * f = U⁻¹ for a ground-truth inverse response U drawn from the
    estimator's own basis span, scaled to be strongly nonlinear yet
    admissible under the adoption gates (the RA-L protocol likewise fits
    within an EMoR basis; an out-of-class gamma run is reported too so
    basis-capacity bias is visible),
  * a strong polynomial vignette (corner falloff ≈ 0.65),
  * an auto-exposure random walk with step flicker (±0.45 log range).

The pipeline runs photo=0 and photo=1; the artifact records scale-aligned
ATE for both (honest in both directions) plus the photo=1 recovery errors:
inverse-response RMSE (fraction of full scale over the usable range),
vignette-curve RMSE, and the correlation of per-frame exposure estimates
with ground truth.

    python scripts/make_photo_curve_artifact.py [n=400] [out=artifacts/photo_curve_recovery.json]
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

import jax

from hso_tpu.utils.jax_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from bench import bench_camera, bench_scene, trajectory
from hso_tpu.config import Config
from hso_tpu.math import se3np
from hso_tpu.photometric.online_calib import (
    N_RESP,
    N_VIG,
    _resp_basis,
    _vig_basis,
)
from hso_tpu.pipeline.frame_handler import RESULT_FAILURE, FrameHandler
from hso_tpu.utils.evaluate import ate

#: ground-truth inverse response coefficients (basis x^k (1-x), k=1..4):
#: the ridge fit of an inverse-gamma-0.6 curve inside the basis span —
#: log-log slope ratio 3.4 over the usable range (a strongly nonlinear
#: consumer-camera curve) while monotone and inside the estimator's own
#: adoption gates (a GT curve the estimator would REJECT as implausible
#: could never be adopted, so admissibility is a prerequisite, not a
#: concession)
C_GT = np.array([-2.097, -0.002, 0.269, 0.258], np.float32)
#: ground-truth log-vignette polynomial in R = r²/r²max: corner ≈ 0.65
V_GT = np.array([-0.35, -0.05, -0.03], np.float32)


def log_u_gt(x):
    """log U(255·x) for x in (0, 1]."""
    return np.log(np.maximum(x, 1e-6) * 255.0) + _resp_basis(
        np.asarray(x, np.float32)) @ C_GT


def response_lut():
    """f = U⁻¹ as a 0..255 → 0..255 lookup (O = f(y): smallest O with
    U(O) ≥ y)."""
    o_grid = np.linspace(1e-3, 1.0, 4096)
    u_vals = np.exp(log_u_gt(o_grid))          # U over O grid, in [~0, 255]
    y_grid = np.arange(256, dtype=np.float64)
    o_of_y = np.interp(y_grid, u_vals, o_grid * 255.0)
    return o_of_y.astype(np.float32)           # index by clipped linear y


def main() -> None:
    args = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    n = int(args.get("n", 400))
    out_path = args.get(
        "out", os.path.join(ROOT, "artifacts", "photo_curve_recovery.json"))

    cam = bench_camera()
    scene = bench_scene(cam)
    poses = trajectory(n)
    rng = np.random.default_rng(7)

    # exposure walk with steps
    log_e = np.cumsum(rng.uniform(-0.05, 0.05, n))
    for k in rng.integers(40, n - 1, max(2, n // 60)):
        log_e[k:] += rng.uniform(-0.2, 0.2)
    log_e = np.clip(log_e - log_e[0], -0.45, 0.45)

    yy, xx = np.mgrid[0:cam.height, 0:cam.width]
    r2max = max((0 - cam.cx) ** 2 + (0 - cam.cy) ** 2,
                (cam.width - 1 - cam.cx) ** 2 + (cam.height - 1 - cam.cy) ** 2)
    r2n = ((xx - cam.cx) ** 2 + (yy - cam.cy) ** 2) / r2max
    vig = np.exp(_vig_basis(np.asarray(r2n, np.float32)) @ V_GT)
    lut = response_lut()

    print(f"rendering + corrupting {n} frames ...", file=sys.stderr)
    frames = []
    for k in range(n):
        L = scene.render(poses[k]).astype(np.float32)
        # widen the radiance coverage (the box textures are mid-heavy;
        # a response curve is only identifiable where samples exist —
        # TUM-MonoVO-class footage spans deep shadow to near-saturation)
        L = np.clip(1.7 * (L - 120.0) + 120.0, 2.0, 253.0)
        y = np.clip(np.exp(log_e[k]) * vig * L, 0.0, 255.0)
        frames.append(lut[np.round(y).astype(np.int64)].astype(np.uint8))

    results = {}
    curves = {}
    for photo in (False, True):
        cfg = Config(photometric_calib=photo)
        vo = FrameHandler(cam, cfg)
        if photo:
            vo.photo.solve_every = 8
            vo.photo.min_frames = 8
        n_fail = 0
        t0 = time.perf_counter()
        for k, img in enumerate(frames):
            res = vo.add_image(img, ts=float(k))
            n_fail += res.status == RESULT_FAILURE
        wall = time.perf_counter() - t0
        est = np.stack([se3np.translation(se3np.inv(se3np.normalize(T)))
                        for _, T in vo.trajectory])
        gt = np.stack([se3np.translation(se3np.inv(T)) for T in poses])
        r = ate(est[10:], gt[10:], with_scale=True)
        key = "photo_on" if photo else "photo_off"
        results[key] = {
            "ate_rmse_m": round(float(r.rmse), 5),
            "n_failed_frames": int(n_fail),
            "final_stage": vo.stage,
            "wall_s": round(wall, 1),
        }
        if photo:
            # ---- curve recovery (the RA-L'18 deliverable) ----
            assert vo.photo.calibrated, "calibrator never adopted a solution"

            def curve_errs(c_est, v_est):
                x = np.linspace(5.0 / 255.0, 250.0 / 255.0, 200)
                u_est = np.exp(np.log(x * 255.0) + _resp_basis(
                    np.asarray(x, np.float32)) @ np.asarray(c_est))
                u_gt = np.exp(log_u_gt(x))
                R = np.linspace(0, 1, 100)
                vg_est = np.exp(_vig_basis(np.asarray(R, np.float32))
                                @ np.asarray(v_est))
                vg_gt = np.exp(_vig_basis(np.asarray(R, np.float32)) @ V_GT)
                return {
                    "inverse_response_rmse_frac": round(float(np.sqrt(
                        np.mean(((u_est - u_gt) / 255.0) ** 2))), 5),
                    "inverse_response_max_frac": round(float(np.max(
                        np.abs(u_est - u_gt) / 255.0)), 5),
                    "identity_response_rmse_frac": round(float(np.sqrt(
                        np.mean(((x * 255.0 - u_gt) / 255.0) ** 2))), 5),
                    "vignette_rmse": round(float(np.sqrt(
                        np.mean((vg_est - vg_gt) ** 2))), 5),
                    "identity_vignette_rmse": round(float(np.sqrt(
                        np.mean((1.0 - vg_gt) ** 2))), 5),
                    "c_est": [round(float(v), 4) for v in np.asarray(c_est)],
                    "v_est": [round(float(v), 4) for v in np.asarray(v_est)],
                }

            # sample-intensity coverage: the estimator can only recover the
            # curve where it saw data — report the 5th-95th percentile range
            samples = np.concatenate([fr["inten"] for fr in vo.photo.frames])
            lo_p, hi_p = np.percentile(samples, [5, 95])

            def curve_errs_cov(c_est, v_est):
                d = curve_errs(c_est, v_est)
                xr = np.linspace(max(lo_p, 5.0) / 255.0,
                                 min(hi_p, 250.0) / 255.0, 200)
                u_est = np.exp(np.log(xr * 255.0) + _resp_basis(
                    np.asarray(xr, np.float32)) @ np.asarray(c_est))
                u_gt = np.exp(log_u_gt(xr))
                d["inverse_response_rmse_frac_coverage"] = round(float(
                    np.sqrt(np.mean(((u_est - u_gt) / 255.0) ** 2))), 5)
                d["identity_rmse_frac_coverage"] = round(float(np.sqrt(
                    np.mean(((xr * 255.0 - u_gt) / 255.0) ** 2))), 5)
                return d

            # (a) the APPLIED estimate (temporally smoothed across solves —
            # what correct() uses), (b) the final-window raw solve (the
            # batch estimate the RA-L protocol reports)
            curves = {"applied_smoothed": curve_errs_cov(vo.photo.c, vo.photo.v),
                      "sample_intensity_p5_p95": [round(float(lo_p), 1),
                                                  round(float(hi_p), 1)]}
            fin = vo.photo.solve()
            if fin is not None:
                curves["final_window_solve"] = curve_errs_cov(fin["c"],
                                                              fin["v"])
                if "log_e" in fin:
                    le = np.asarray(fin["log_e"])
                    k0 = len(frames) - len(le)
                    gt_e = log_e[k0:k0 + len(le)]
                    curves["exposure_corr_final_window"] = round(float(
                        np.corrcoef(le - le.mean(),
                                    gt_e - gt_e.mean())[0, 1]), 4)
            curves["c_gt"] = [round(float(v), 4) for v in C_GT]
            curves["v_gt"] = [round(float(v), 4) for v in V_GT]
        print(f"{key}: {results[key]}", file=sys.stderr)

    # out-of-class check: how well can the basis itself express a gamma-0.6
    # camera (capacity bound, reported for honesty — the estimator cannot
    # beat it on real out-of-class footage)
    x = np.linspace(5.0 / 255.0, 250.0 / 255.0, 200)
    target = np.log(255.0) + np.log(x) / 0.6
    A = np.asarray(_resp_basis(np.asarray(x, np.float32)))
    c_fit, *_ = np.linalg.lstsq(A, target - np.log(x * 255.0), rcond=None)
    cap = np.sqrt(np.mean(((np.exp(np.log(x * 255.0) + A @ c_fit)
                            - np.exp(target)) / 255.0) ** 2))

    doc = {
        "artifact": "photometric curve recovery (RA-L'18 protocol deliverable)",
        "n_frames": n,
        "chain": "O = Uinv(e_j * V(r) * L); response in-basis (inverse-gamma"
                 "-0.6 ridge fit, log-log slope ratio 3.4), vignette corner "
                 "0.65, exposure walk +-0.45 log",
        **results,
        "curve_recovery": curves,
        "basis_capacity_rmse_gamma06": round(float(cap), 5),
        "date": time.strftime("%Y-%m-%d"),
    }
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc, indent=1))


if __name__ == "__main__":
    main()
