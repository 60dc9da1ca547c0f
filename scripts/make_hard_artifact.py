"""Adversarial photometric validation artifact (``boxseq_hard``).

Real datasets are unreachable in this image (no network — VERDICT r3), and
the clean synthetic scenes never exercise the robust machinery.  This run
renders the bench Box sequence through a photometric torture chain that
mirrors what TUM MonoVO-class footage does to a direct method
(the reference's PhotomatricCalibration rationale,
/root/reference/src/frame_handler_mono.cpp:53-56):

  * non-linear camera response (gamma),
  * strong radial vignette,
  * auto-exposure walk with step flicker,
  * Gaussian read noise + Poisson shot noise,
  * motion blur along the image velocity on fast frames,
  * a moving textured foreground occluder.

The pipeline runs twice — online photometric calibration OFF and ON — and
the artifact records scale-aligned ATE RMSE, failure/relocalization counts
for both.  Passing bar: 0 unrecovered failures and calibration improving
(or at least not hurting) ATE.

    python scripts/make_hard_artifact.py [n=400] [out=artifacts/boxseq_hard.json]
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

import cv2

from bench import bench_camera, bench_scene, trajectory
from hso_tpu.config import Config
from hso_tpu.math import se3np
from hso_tpu.pipeline.frame_handler import RESULT_FAILURE, FrameHandler
from hso_tpu.utils.evaluate import ate

#: torture levels: (gamma, vignette poly, exposure walk/step scale)
LEVELS = {
    "hard": dict(gamma=0.72, vig=(-0.42, -0.18), e_walk=0.05, e_step=0.18,
                 e_clip=0.45),
    "extreme": dict(gamma=0.52, vig=(-0.95, -0.35), e_walk=0.08, e_step=0.30,
                    e_clip=0.75),
}


class Torture:
    """Deterministic photometric + structural corruption chain."""

    def __init__(self, cam, n, level, seed=11):
        self.p = LEVELS[level]
        rng = np.random.default_rng(seed)
        # auto-exposure: smooth walk plus step flicker every ~40 frames
        w, st_, cl = self.p["e_walk"], self.p["e_step"], self.p["e_clip"]
        log_e = np.cumsum(rng.uniform(-w, w, n))
        steps = np.zeros(n)
        for k in rng.integers(30, n - 1, max(2, n // 40)):
            steps[k:] += rng.uniform(-st_, st_)
        self.log_e = np.clip(log_e - log_e[0] + steps, -cl, cl)
        yy, xx = np.mgrid[0:cam.height, 0:cam.width]
        r2max = cam.cx ** 2 + cam.cy ** 2
        self.r2n = ((xx - cam.cx) ** 2 + (yy - cam.cy) ** 2) / r2max
        vig = self.p["vig"]
        self.vig = np.exp(vig[0] * self.r2n + vig[1] * self.r2n ** 2)
        self.rng = rng
        # occluder: textured patch orbiting the image centre
        self.occ_tex = rng.integers(10, 90, (90, 110)).astype(np.float32)
        self.occ_tex = cv2.GaussianBlur(self.occ_tex, (0, 0), 1.5)
        self.cam = cam

    def __call__(self, img_u8, k, px_vel):
        img = img_u8.astype(np.float32)
        # motion blur along image velocity when fast
        speed = float(np.hypot(*px_vel))
        if speed > 1.5:
            L = int(np.clip(speed, 2, 7))
            kern = np.zeros((L, L), np.float32)
            c = (L - 1) / 2.0
            d = np.array(px_vel) / max(speed, 1e-6)
            for t in np.linspace(-c, c, 2 * L):
                x, y = int(round(c + t * d[0])), int(round(c + t * d[1]))
                kern[np.clip(y, 0, L - 1), np.clip(x, 0, L - 1)] += 1.0
            kern /= kern.sum()
            img = cv2.filter2D(img, -1, kern)
        # occluder
        h, w = img.shape
        ocy = int(h / 2 + 0.30 * h * np.sin(0.05 * k))
        ocx = int(w / 2 + 0.38 * w * np.cos(0.033 * k))
        oh, ow = self.occ_tex.shape
        y0, x0 = max(0, ocy - oh // 2), max(0, ocx - ow // 2)
        y1, x1 = min(h, y0 + oh), min(w, x0 + ow)
        img[y0:y1, x0:x1] = self.occ_tex[: y1 - y0, : x1 - x0]
        # radiometric chain: exposure, vignette, shot+read noise, response
        y = np.exp(self.log_e[k]) * self.vig * img
        y = y + self.rng.normal(0.0, 2.0, y.shape) \
            + self.rng.normal(0.0, 1.0, y.shape) * np.sqrt(np.maximum(y, 0) / 16.0)
        y = np.clip(y, 0.0, 255.0)
        out = 255.0 * (y / 255.0) ** self.p["gamma"]
        return np.clip(out, 0, 255).astype(np.uint8)


def run_once(frames, poses, photo: bool) -> dict:
    cam = bench_camera()
    cfg = Config(photometric_calib=photo)
    vo = FrameHandler(cam, cfg)
    if photo:
        vo.photo.solve_every = 8
        vo.photo.min_frames = 8
    n_fail = n_reloc = 0
    t0 = time.perf_counter()
    for k, img in enumerate(frames):
        res = vo.add_image(img, ts=float(k))
        if res.status == RESULT_FAILURE:
            n_fail += 1
            if vo.stage != "default":
                n_reloc += 1
    wall = time.perf_counter() - t0
    est = np.stack([se3np.translation(se3np.inv(se3np.normalize(T)))
                    for _, T in vo.trajectory])
    gt = np.stack([se3np.translation(se3np.inv(T)) for T in poses])
    # evaluate the tracked segment (everything after bootstrap)
    res_ate = ate(est[10:], gt[10:], with_scale=True)
    return {
        "photometric_calib": photo,
        "ate_rmse_m": round(float(res_ate.rmse), 5),
        "n_failed_frames": n_fail,
        "n_reloc_entries": n_reloc,
        "final_stage": vo.stage,
        "n_points_final": int(vo.points.valid.sum()),
        "wall_s": round(wall, 1),
    }


def main() -> None:
    args = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    n = int(args.get("n", 400))
    out_path = args.get("out", os.path.join(ROOT, "artifacts", "boxseq_hard.json"))

    cam = bench_camera()
    scene = bench_scene(cam)
    poses = trajectory(n)
    print(f"rendering clean frames ...", file=sys.stderr)
    clean = [scene.render(T) for T in poses]
    cs = [se3np.translation(se3np.inv(T)) for T in poses]
    vels = [np.zeros(2)] + [cam.focal_mean * (cs[i] - cs[i - 1])[:2] / 2.0
                            for i in range(1, n)]

    levels = {}
    for level in ("hard", "extreme"):
        torture = Torture(cam, n, level)
        frames = [torture(img, k, vels[k]) for k, img in enumerate(clean)]
        print(f"running {level} ...", file=sys.stderr)
        levels[level] = {
            "torture": dict(LEVELS[level],
                            exposure_range_log=[float(torture.log_e.min()),
                                                float(torture.log_e.max())],
                            noise="gauss sigma=2 + shot sigma=sqrt(I/16)",
                            motion_blur="directional, up to 7 px",
                            occluder="90x110 textured patch, orbiting"),
            "results": [run_once(frames, poses, photo)
                        for photo in (False, True)],
        }
    doc = {
        "sequence": "boxseq_hard",
        "n_frames": n,
        "levels": levels,
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(doc, fh, indent=1)
    print(json.dumps({k: v["results"] for k, v in levels.items()}))


if __name__ == "__main__":
    main()
