"""A/B experiment: recency vs closest-angle patch-source selection.

The reference re-selects each map point's reference patch per match by
viewing angle (``Point::getCloseViewObs``, /root/reference/src/point.cpp:
97-137); this framework memoizes ONE view refreshed at each observing
keyframe (recency) — fine under smooth forward motion, to be checked under
view-revisiting motion.  ``Config.patch_source=
"closest"`` adds the host view as a second candidate and picks the smaller
viewing angle per match inside the fused step.

This harness runs a pendulum trajectory (the camera sweeps far to one side
and swings back through earlier viewpoints, with yaw oscillation — the
exact case where the most recent view is NOT the closest) under both
settings and records ATE, match counts and failures.

    python scripts/ab_patch_source.py [n=300] [out=artifacts/patch_source_ab.json]
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

from bench import bench_camera, bench_scene
from hso_tpu.config import Config
from hso_tpu.math import se3np
from hso_tpu.pipeline.frame_handler import RESULT_FAILURE, FrameHandler
from hso_tpu.utils.evaluate import ate


def pendulum_trajectory(n):
    """Wide lateral sweep with slow period + yaw: revisits early viewpoints
    from frame ~n/2 on, twice per period."""
    poses = []
    for k in range(n):
        t = k / 18.0
        xi = np.r_[
            1.3 * np.sin(0.35 * t),            # wide, slow lateral pendulum
            0.10 * np.sin(0.9 * t),
            0.15 * np.sin(0.25 * t),
            0.03 * np.sin(0.7 * t),
            -0.22 * np.sin(0.35 * t),          # yaw swinging with the sweep
            0.02 * np.sin(0.5 * t),
        ]
        poses.append(se3np.exp(xi))
    return poses


def run(frames, poses, mode: str) -> dict:
    cam = bench_camera()
    vo = FrameHandler(cam, Config(patch_source=mode))
    n_fail = 0
    matches = []
    t0 = time.perf_counter()
    for k, img in enumerate(frames):
        res = vo.add_image(img, ts=float(k))
        if res.status == RESULT_FAILURE:
            n_fail += 1
        elif vo.stage == "default" and res.n_matches:
            matches.append(res.n_matches)
    wall = time.perf_counter() - t0
    est = np.stack([se3np.translation(se3np.inv(se3np.normalize(T)))
                    for _, T in vo.trajectory])
    gt = np.stack([se3np.translation(se3np.inv(T)) for T in poses])
    r = ate(est[10:], gt[10:], with_scale=True)
    return {
        "patch_source": mode,
        "ate_rmse_m": round(float(r.rmse), 5),
        "mean_matches": round(float(np.mean(matches)), 1),
        "p10_matches": int(np.percentile(matches, 10)),
        "n_failed_frames": n_fail,
        "final_stage": vo.stage,
        "wall_s": round(wall, 1),
    }


def main() -> None:
    args = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    n = int(args.get("n", 300))
    out_path = args.get("out",
                        os.path.join(ROOT, "artifacts", "patch_source_ab.json"))
    cam = bench_camera()
    scene = bench_scene(cam)
    poses = pendulum_trajectory(n)
    print(f"rendering {n} frames ...", file=sys.stderr)
    frames = [scene.render(T) for T in poses]

    results = [run(frames, poses, m) for m in ("recency", "closest")]
    doc = {"trajectory": "pendulum (wide lateral sweep + yaw, revisits "
                         "early viewpoints)", "n_frames": n,
           "results": results}
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(doc, fh, indent=1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
