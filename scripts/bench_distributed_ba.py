"""Weak-scaling benchmark of the distributed sliding-window BA.

BASELINE target: ≥80% weak-scaling efficiency at ≥2 hosts for the
point-block-sharded Schur BA (v3 layout: the dense (P, K) observation grid
partitioned across the mesh along the point axis, camera-camera Hessian
psum).  This harness keeps the per-device landmark/observation load
constant while growing the mesh, and reports step time and efficiency per
device count.

    python scripts/bench_distributed_ba.py [devices=1,2,4,8] [pts_per_dev=640]
        [kf=12] [iters=10] [cpu=1] [out=weak_scaling.json]

On virtual CPU meshes (``--xla_force_host_platform_device_count``) the
numbers validate the harness and the collective layout, not interconnect
bandwidth; run on real devices for a reportable figure.  Prints one JSON line per device count and
a final summary line; with ``out=`` also writes the full result object.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main() -> None:
    args = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    dev_counts = [int(x) for x in args.get("devices", "1,2,4,8").split(",")]
    pts_per_dev = int(args.get("pts_per_dev", 640))
    n_kf = int(args.get("kf", 12))
    n_iter = int(args.get("iters", 10))

    max_dev = max(dev_counts)
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={max_dev}"
    )

    import jax

    if args.get("cpu", "1") != "0":
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    sys.path.insert(
        0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests")
    )
    from test_local_ba import FOCAL, make_ba_problem

    from hso_tpu.ba.distributed import (
        make_distributed_ba,
        shard_obs,
        shard_problem,
    )
    from hso_tpu.ba.local_ba import compute_deltas

    devs = jax.devices()
    print(f"# backend={devs[0].platform} n_devices={len(devs)}", file=sys.stderr)

    results = []
    collectives = None
    for nd in dev_counts:
        if nd > len(devs):
            print(f"# skipping {nd} devices (have {len(devs)})", file=sys.stderr)
            continue
        mesh = Mesh(np.array(devs[:nd]), axis_names=("pts",))
        # weak scaling: landmark count grows with the mesh, per-device block
        # constant; every point is observed in ~(kf-1) target frames
        n_pts = pts_per_dev * nd
        prob = make_ba_problem(n_kf=n_kf, n_pts=n_pts, K=n_kf, P=n_pts,
                               noise_px=0.3, seed=7)
        obs_s, idist_s, pv_s, p_local = shard_problem(
            prob["obs"], prob["idist"], prob["point_valid"], nd)
        deltas = compute_deltas(prob["T_kf"], prob["idist"], prob["obs"], FOCAL)
        step = make_distributed_ba(mesh, n_kf=prob["K"], n_pts_local=p_local,
                                   n_iter=n_iter)
        obs_dev = shard_obs({k: jnp.asarray(v) for k, v in obs_s.items()}, mesh)
        idist_d = jnp.asarray(idist_s)
        pv_d = jnp.asarray(pv_s)

        def run():
            return step(prob["T_kf"], prob["free"], idist_d, pv_d,
                        obs_dev, *deltas)

        def timed(fn):
            out = fn()
            jax.block_until_ready(out)
            t0 = time.perf_counter()
            reps = 5
            for _ in range(reps):
                out = fn()
            jax.block_until_ready(out)
            return (time.perf_counter() - t0) / reps, out

        dt, out = timed(run)

        if nd == max(dev_counts):
            # MEASURED collective inventory: parse every all-reduce the
            # compiled HLO actually contains (shape -> byte size, count).
            # The LM loop is one `while`; all-reduces inside its body fire
            # once per iteration.
            import re

            txt = step.lower(prob["T_kf"], prob["free"], idist_d, pv_d,
                             obs_dev, *deltas).compile().as_text()
            inv = []
            body_bytes = init_bytes = 0
            # XLA emits tuple-shaped all-reduces:
            #   %all-reduce.N = (f32[72,72]{..}, f32[72]{..}) all-reduce(...)
            for m in re.finditer(
                    r"%all-reduce[.\d]* = \((.*?)\) all-reduce\(.*", txt):
                line = m.group(0)
                shapes = re.findall(r"(\w+)\[([\d,]*)\]", m.group(1))
                nbytes = 0
                for dt_name, dims in shapes:
                    b = 4 if dt_name in ("f32", "s32", "u32", "pred") else 8
                    for d in dims.split(","):
                        if d:
                            b *= int(d)
                    nbytes += b
                in_body = "while/body" in line
                inv.append({
                    "shapes": [f"{t}[{d}]" for t, d in shapes],
                    "bytes": nbytes,
                    "where": "lm_loop_body" if in_body else "initial_build",
                })
                if in_body:
                    body_bytes += nbytes
                else:
                    init_bytes += nbytes
            collectives = {
                "hlo_all_reduces": inv,
                "payload_bytes_per_lm_iteration": body_bytes,
                "lm_iterations": n_iter,
                "payload_bytes_per_solve": body_bytes * n_iter + init_bytes,
                "note": (
                    "parsed from the compiled HLO of the n-device step; "
                    "loop-body all-reduces fire once per LM iteration"),
            }

        # distribution-overhead control: the SAME total problem solved on a
        # 1-device mesh (all landmarks in one block, no collectives at scale).
        # On a virtual CPU mesh all "devices" share one physical socket, so
        # classic weak scaling (constant time under growing total work) is
        # physically impossible there; `overhead_efficiency` = t_1dev / t_dist
        # isolates what the partitioning + psum machinery costs, which IS
        # measurable on shared hardware.
        mesh1 = Mesh(np.array(devs[:1]), axis_names=("pts",))
        obs_s1, idist_s1, pv_s1, p_local1 = shard_problem(
            prob["obs"], prob["idist"], prob["point_valid"], 1)
        step1 = make_distributed_ba(mesh1, n_kf=prob["K"],
                                    n_pts_local=p_local1, n_iter=n_iter)
        obs_dev1 = shard_obs({k: jnp.asarray(v) for k, v in obs_s1.items()},
                             mesh1)
        idist_d1 = jnp.asarray(idist_s1)
        pv_d1 = jnp.asarray(pv_s1)
        dt1, _ = timed(lambda: step1(prob["T_kf"], prob["free"], idist_d1,
                                     pv_d1, obs_dev1, *deltas))

        chi2 = float(out[2])
        n_obs = int(np.asarray(prob["obs"]["valid"]).sum())
        row = {
            "devices": nd, "pts_total": n_pts, "pts_per_dev": p_local,
            "obs_total": n_obs,
            "step_ms": round(dt * 1e3, 3),
            "step_ms_1dev_same_problem": round(dt1 * 1e3, 3),
            "overhead_efficiency": round(dt1 / dt, 3),
            "chi2": chi2,
        }
        results.append(row)
        print(json.dumps(row))

    if results:
        t1 = results[0]["step_ms"]
        for row in results:
            row["weak_scaling_efficiency"] = round(t1 / row["step_ms"], 3)
            print(json.dumps({
                "metric": "weak_scaling_efficiency", "devices": row["devices"],
                "value": row["weak_scaling_efficiency"],
                "overhead_efficiency": row["overhead_efficiency"],
            }))
        if collectives:
            print(json.dumps({"collectives": collectives}))

        out_path = args.get("out")
        if out_path:
            with open(out_path, "w") as fh:
                json.dump({
                    "collectives_measured": collectives,
                    "backend": devs[0].platform,
                    "note": (
                        "virtual CPU mesh (all 'devices' share one physical "
                        "socket) — validates the collective layout and "
                        "measures partitioning+psum overhead, not real "
                        "bandwidth.  Classic weak scaling (constant step "
                        "time while total work grows with the mesh) is "
                        "physically impossible on shared hardware: total "
                        "FLOPs grow n-fold with no added silicon, so "
                        "step_ms rising with n is the socket saturating, "
                        "not the algorithm.  The meaningful figure is "
                        "overhead_efficiency = t(1 device, same total "
                        "problem)/t(n devices): >= 1.0 everywhere means the "
                        "point-block sharding + psum of the (6K,6K) camera "
                        "system costs nothing.  On real devices, "
                        "per-device work is constant by construction and "
                        "the only added cost is the psum'd camera system "
                        "(37 KB at K=16), so link-bound efficiency follows "
                        "overhead_efficiency, not the socket-bound "
                        "weak_scaling_efficiency column."),
                    "n_kf": n_kf, "n_iter": n_iter,
                    "results": results,
                }, fh, indent=1)
            print(f"# wrote {out_path}", file=sys.stderr)


if __name__ == "__main__":
    main()
