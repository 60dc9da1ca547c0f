"""Per-frame host-side wall-time attribution for the live ``add_image``
loop (VERDICT r4 weak #2 / next #4): where each steady-state frame's
~100 ms goes — host prep, the async fused-step dispatch, the one packed
sync, sparse-frame writebacks, keyframe events, trailing host bookkeeping.

Runs the bench's host-loop segment with the FrameHandler stage timers
enabled (frame_handler.TRACE_TIMERS), then prints median/p90 per stage for
non-keyframe frames and totals for keyframe frames, and writes
``artifacts/host_breakdown.json``.

    timeout 580 python scripts/profile_host_loop.py
"""

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

from bench import BOOT_NPZ, bench_camera, bench_scene, trajectory
from hso_tpu.config import Config
from hso_tpu.pipeline.frame_handler import FrameHandler
from hso_tpu.utils.checkpoint import load_checkpoint

N_WARM_KF = 3
N_TIMED = 40


def main() -> None:
    cam = bench_camera()
    cfg = Config()
    scene = bench_scene(cam)
    vo = FrameHandler(cam, cfg)
    load_checkpoint(vo, BOOT_NPZ, resume_stage="default")
    start = vo.frame_count
    poses = trajectory(start + 24 + 2 * N_TIMED + 2)
    frames = [scene.render(T) for T in poses[start:]]

    # warm through a few keyframe events (lazy executable loads)
    k, nkf = 0, 0
    while k < 24:
        res = vo.add_image(frames[k], ts=float(start + k))
        k += 1
        if res.status == "keyframe":
            nkf += 1
            if nkf >= N_WARM_KF:
                break

    vo.enable_tracing(trace_name="host_breakdown", trace_dir="/tmp")
    t0 = time.perf_counter()
    for j in range(k, k + N_TIMED):
        vo.add_image(frames[j], ts=float(start + j))
    fps = N_TIMED / (time.perf_counter() - t0)
    k += N_TIMED

    # pipelined loop (lag-1): dispatch overlaps the previous frame's sync
    vo.monitor = None
    n_pipe = min(N_TIMED, len(frames) - k - 1)
    t0 = time.perf_counter()
    for j in range(k, k + n_pipe):
        vo.add_image_pipelined(frames[j], ts=float(start + j))
    vo.flush()
    fps_pipe = n_pipe / (time.perf_counter() - t0)
    print(f"pipelined host loop: {fps_pipe:.2f} fps over {n_pipe} frames")

    rows = np.genfromtxt("/tmp/host_breakdown.csv", delimiter=",", names=True)
    is_kf = rows["log_is_keyframe"] > 0.5
    stages = ["host_prep", "fused_dispatch", "sync_packed", "writeback",
              "seed_rescue", "kf_event", "tot_time"]
    out = {"fps": round(fps, 2), "fps_pipelined": round(fps_pipe, 2),
           "n_frames": int(len(rows)),
           "n_keyframes": int(is_kf.sum()), "stages_ms": {}}
    print(f"host loop: {fps:.2f} fps over {len(rows)} frames "
          f"({int(is_kf.sum())} keyframes)")
    print(f"{'stage':>16} {'med(all)':>9} {'p90(all)':>9} {'med(non-kf)':>11}")
    for s in stages:
        col = rows[f"timer_{s}"] * 1e3
        med, p90 = np.median(col), np.percentile(col, 90)
        mednk = np.median(col[~is_kf]) if (~is_kf).any() else float("nan")
        print(f"{s:>16} {med:9.2f} {p90:9.2f} {mednk:11.2f}")
        out["stages_ms"][s] = {"median": round(float(med), 3),
                               "p90": round(float(p90), 3),
                               "median_nonkf": round(float(mednk), 3)}
    # unattributed = tot - sum of attributed blocks, per non-kf frame
    attributed = sum(rows[f"timer_{s}"] for s in stages[:-1])
    resid = (rows["timer_tot_time"] - attributed) * 1e3
    mr = float(np.median(resid[~is_kf])) if (~is_kf).any() else float("nan")
    print(f"{'unattributed':>16} {np.median(resid)*1:9.2f} "
          f"{np.percentile(resid, 90):9.2f} {mr:11.2f}")
    out["stages_ms"]["unattributed"] = {
        "median": round(float(np.median(resid)), 3),
        "p90": round(float(np.percentile(resid, 90)), 3),
        "median_nonkf": round(mr, 3)}
    path = os.path.join(ROOT, "artifacts", "host_breakdown.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("written:", path)


if __name__ == "__main__":
    main()
