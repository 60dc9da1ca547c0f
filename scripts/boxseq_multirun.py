"""Multi-run boxseq-2200 protocol (VERDICT r4 item 3).

The reference runs every sequence 10× because its tracker/mapper race makes
single runs untrustworthy (/root/reference/test/euroc_batch.sh).  This
framework is synchronous and deterministic by design — so this script both
(a) runs the full 2200-frame box sequence N times and reports per-run ATE
stats (median/min/max RMSE and max excursion), and (b) tests run-to-run
IDENTITY by comparing keyframe trajectories bitwise across runs.  Non-
identity would implicate the only nondeterminism source we know of: XLA
executables loaded from a persistent compile cache built on a different
machine generation (the cpu_aot_loader machine-feature warnings) — so runs
here share one process and one freshly-warmed executable set.

    python scripts/boxseq_multirun.py [data=/tmp/boxseq2200] [n_runs=5]
        [out=artifacts/boxseq_2200_ate.json]
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

from hso_tpu.config import Config
from hso_tpu.io.calib import parse_calib
from hso_tpu.io.image_reader import ImageReader
from hso_tpu.math import se3np
from hso_tpu.pipeline.frame_handler import FrameHandler
from hso_tpu.utils.device import hardware_label
from hso_tpu.utils.evaluate import ate


def run_once(reader, cam, gt_xyz) -> dict:
    vo = FrameHandler(cam, Config())
    n_fail = 0
    t0 = time.perf_counter()
    for i in range(len(reader)):
        img = reader.read_image(i)
        res = vo.add_image(img, ts=float(i))
        n_fail += res.status == "failure"
    wall = time.perf_counter() - t0
    # keyframe trajectory (the reference's evaluation set)
    kf_ts = [kf.timestamp for kf in vo.kfs.frames]
    kf_xyz = np.stack([se3np.translation(se3np.inv(kf.T_f_w))
                       for kf in vo.kfs.frames])
    gt = gt_xyz[np.asarray(kf_ts, int)]
    r = ate(kf_xyz, gt, with_scale=True)
    return {
        "ate_rmse_m": float(r.rmse),
        "ate_max_m": float(r.max),
        "n_keyframes": len(kf_ts),
        "n_failures": int(n_fail),
        "fps": round(len(reader) / wall, 2),
        "kf_xyz": kf_xyz,
        "kf_ts": kf_ts,
    }


def main() -> None:
    args = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    data = args.get("data", "/tmp/boxseq2200")
    n_runs = int(args.get("n_runs", 5))
    out_path = args.get(
        "out", os.path.join(ROOT, "artifacts", "boxseq_2200_ate.json"))

    cam = parse_calib(os.path.join(data, "calib.txt"))
    reader = ImageReader(os.path.join(data, "images"),
                         (cam.width, cam.height),
                         os.path.join(data, "times.txt"))
    gt = np.loadtxt(os.path.join(data, "groundtruth.txt"))
    gt_xyz = gt[:, 1:4]

    runs = []
    for k in range(n_runs):
        r = run_once(reader, cam, gt_xyz)
        print(f"run {k}: rmse={r['ate_rmse_m']*1e3:.1f} mm "
              f"max={r['ate_max_m']*1e3:.1f} mm kfs={r['n_keyframes']} "
              f"fail={r['n_failures']} fps={r['fps']}", file=sys.stderr)
        runs.append(r)

    # run-to-run identity: same keyframe set and bitwise-equal positions?
    base = runs[0]
    identical = all(
        r["kf_ts"] == base["kf_ts"]
        and r["kf_xyz"].shape == base["kf_xyz"].shape
        and np.array_equal(r["kf_xyz"], base["kf_xyz"])
        for r in runs[1:]
    )
    rmses = [r["ate_rmse_m"] for r in runs]
    maxes = [r["ate_max_m"] for r in runs]
    doc = {
        "sequence": data,
        "protocol": f"{n_runs} full runs (the reference's 10-run "
                    "euroc_batch.sh methodology); deterministic synchronous "
                    "pipeline -> identity expected and tested",
        "n_frames": len(reader),
        "n_runs": n_runs,
        "runs_identical_bitwise": bool(identical),
        "ate_rmse_m": {"median": round(float(np.median(rmses)), 5),
                       "min": round(float(np.min(rmses)), 5),
                       "max": round(float(np.max(rmses)), 5)},
        "ate_max_excursion_m": {"median": round(float(np.median(maxes)), 5),
                                "min": round(float(np.min(maxes)), 5),
                                "max": round(float(np.max(maxes)), 5)},
        "n_keyframes": base["n_keyframes"],
        "n_failures": [r["n_failures"] for r in runs],
        "host_loop_fps": [r["fps"] for r in runs],
        "hardware": hardware_label(),
        "date": time.strftime("%Y-%m-%d"),
    }
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc, indent=1))


if __name__ == "__main__":
    main()
