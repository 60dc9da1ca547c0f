"""Dataset runner — the ``test_dataset`` CLI equivalent
(/root/reference/test/test_dataset.cpp): same key=value arguments, same
TUM-format keyframe trajectory output for evo evaluation.

    python scripts/run_dataset.py image=<dir> calib=<file> [times=<file>]
        [start=<n>] [end=<n>] [name=<result name>] [cpu=1] [photo=1]
        [trace=1] [gt=<file>] [live=<N>]

``photo=1`` enables online photometric calibration (response + vignette +
exposure; for TUM MonoVO-class auto-exposure sequences).
``trace=1`` writes per-frame stage timings to result/<name>_trace.csv (the
reference's HSO_TRACE CSV).  ``gt=<groundtruth>`` prints scale-aligned ATE
after the run (TUM or EuRoC csv format).  ``live=N`` refreshes
result/live/{tracking,map}.png every N frames while the run executes — the
reference Pangolin viewer / tracking-overlay analogue
(hso_tpu/utils/live_view.py).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main() -> None:
    args = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    if "image" not in args or "calib" not in args:
        print(__doc__)
        sys.exit(1)

    if args.get("cpu"):
        import jax

        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from hso_tpu.io.calib import parse_calib
    from hso_tpu.io.image_reader import ImageReader
    from hso_tpu.io.trajectory import save_keyframe_trajectory
    from hso_tpu.pipeline.frame_handler import FrameHandler

    cam = parse_calib(args["calib"])
    reader = ImageReader(args["image"], (cam.width, cam.height), args.get("times"))
    # prefer the native prefetching decoder when built
    from hso_tpu.io import native_reader as nr

    native = None
    if nr.native_available() and not args.get("no_native"):
        native = nr.NativeImageReader(args["image"], (cam.width, cam.height))
    start = int(args.get("start", 0))
    end = min(int(args.get("end", len(reader))), len(reader))
    name = args.get("name", "KeyFrameTrajectory")

    undistort = getattr(cam, "undistort_image", False)
    if undistort:
        import jax.numpy as jnp

        from hso_tpu.image.pyramid import remap_bilinear

        mx, my = cam.undistort_remap()
        mx_j, my_j = jnp.asarray(mx), jnp.asarray(my)
        cam_pipeline = cam.ideal()
    else:
        cam_pipeline = cam

    from hso_tpu.config import Config

    cfg = Config(photometric_calib=bool(int(args.get("photo", "0"))))
    vo = FrameHandler(cam_pipeline, cfg)
    if args.get("trace"):
        os.makedirs("result", exist_ok=True)
        vo.enable_tracing(trace_name=f"{args.get('name', 'KeyFrameTrajectory')}_trace",
                          trace_dir="result")
    viewer = None
    if args.get("live"):
        from hso_tpu.utils.live_view import LiveViewer

        viewer = LiveViewer(out_dir="result/live", every=int(args["live"]))
    t0 = time.time()
    n_fail = 0
    if native is not None:
        native.start(start, end)
        stream = iter(native)
    for i in range(start, end):
        if native is not None:
            _, img = next(stream)
        else:
            img = reader.read_image(i)
        if undistort:
            img = np.asarray(remap_bilinear(jnp.asarray(img), mx_j, my_j)).astype(
                np.uint8
            )
        res = vo.add_image(img, ts=float(i))
        if viewer is not None:
            viewer.update(vo, img)
        if vo.last_frame is not None:
            vo.last_frame.stamp_str = reader.read_stamp(i)
        n_fail += res.status == "failure"
        if (i - start) % 50 == 0:
            el = time.time() - t0
            print(
                f"[{i}/{end}] {res.status:12s} inl={res.n_inliers:3d} "
                f"kfs={len(vo.kfs.frames)} pts={int(vo.points.valid.sum())} "
                f"fps={max(i - start, 1) / el:.1f}"
            )

    dt = time.time() - t0
    out = os.path.join("result", f"{name}.txt")
    n_kf = save_keyframe_trajectory(vo, out)
    print(
        f"done: {end - start} frames in {dt:.1f}s ({(end - start) / dt:.1f} fps), "
        f"{n_kf} keyframes -> {out}, {n_fail} failures"
    )
    if vo.monitor is not None:
        vo.monitor.close()
        print(f"trace -> result/{vo.monitor.trace_name}.csv")
    if args.get("gt"):
        from hso_tpu.utils.evaluate import associate, ate, load_tum
        from hso_tpu.utils.device import hardware_label

        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from evaluate_ate import load_any

        st_e, rows_e = load_tum(out)
        st_g, xyz_g = load_any(args["gt"])
        ia, ib = associate(st_e, st_g, max_dt=float(args.get("max_dt", 0.02)))
        if len(ia) >= 3:
            r = ate(rows_e[ia, :3], xyz_g[ib])
            print(r)
            if args.get("ate_json"):
                import json
                import datetime

                with open(args["ate_json"], "w") as fh:
                    json.dump({
                        "sequence": args["image"],
                        "protocol": "scripts/run_dataset.py (the reference's "
                                    "test_dataset protocol, /root/reference/"
                                    "test/euroc_batch.sh analogue)",
                        "n_frames": end - start,
                        "n_keyframes": n_kf,
                        "n_failures": n_fail,
                        "ate_rmse_m": round(float(r.rmse), 4),
                        "ate_mean_m": round(float(r.mean), 4),
                        "ate_median_m": round(float(r.median), 4),
                        "ate_max_m": round(float(r.max), 4),
                        "gt_pairs": len(ia),
                        "scale": round(float(r.scale), 4),
                        "host_loop_fps": round((end - start) / dt, 2),
                        "hardware": hardware_label(),
                        "date": datetime.date.today().isoformat(),
                    }, fh, indent=1)
                print(f"ate json -> {args['ate_json']}")
        else:
            print(f"ATE: only {len(ia)} associated pairs — skipped")


if __name__ == "__main__":
    main()
