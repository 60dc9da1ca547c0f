"""Worker for the two-process ``jax.distributed`` BA dryrun.

Each process contributes 4 virtual CPU devices to an 8-device global mesh
and runs the point-block-sharded windowed BA (hso_tpu/ba/distributed.py) on
the committed pipeline-captured window (artifacts/bench_ba.npz), asserting
agreement with the single-device solver computed locally.  This exercises
the process-boundary mechanics the single-process 8-device dryrun cannot:
``jax.distributed.initialize``, cross-process ``psum`` (the DCN-path
analogue), global-array construction from per-process shards, and
addressable-shard readback.  Target: BASELINE config 5 (≥2 hosts).

Launched by scripts/dryrun_multiproc.sh or tests/test_multiproc_ba.py:

    python scripts/_dryrun_multiproc_worker.py <pid> <nproc> <port> [out.json]
"""

import json
import os
import sys

PID = int(sys.argv[1])
NPROC = int(sys.argv[2])
PORT = int(sys.argv[3])
OUT = sys.argv[4] if len(sys.argv) > 4 else None

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import jax

jax.config.update("jax_platforms", "cpu")
from hso_tpu.utils.jax_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.distributed.initialize(f"localhost:{PORT}", num_processes=NPROC,
                           process_id=PID)

import time

import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bench import BA_NPZ, load_ba_problem
from hso_tpu.ba.distributed import make_distributed_ba, shard_problem
from hso_tpu.ba.local_ba import compute_deltas, local_bundle_adjustment

args, kw = load_ba_problem(BA_NPZ)
T_kf, free, idist, pvalid, obs = args

# single-device reference, computed identically in every process
ref = local_bundle_adjustment(T_kf, free, idist, pvalid, obs, **kw)

devs = jax.devices()
assert len(devs) == 4 * NPROC, f"expected {4*NPROC} global devices, got {len(devs)}"
mesh = Mesh(np.array(devs), axis_names=("pts",))

obs_np = {k: np.asarray(v) for k, v in obs.items()}
obs_s, idist_s, pv_s, p_local = shard_problem(
    obs_np, np.asarray(idist), np.asarray(pvalid), len(devs))
deltas = compute_deltas(T_kf, idist, obs, kw["focal"])

shard = NamedSharding(mesh, P("pts"))
repl = NamedSharding(mesh, P())


def g_shard(x):
    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, shard, lambda idx: x[idx])


def g_repl(x):
    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, repl, lambda idx: x[idx])


dba = make_distributed_ba(mesh, n_kf=kw["n_kf"], n_pts_local=p_local,
                          n_iter=kw.get("n_iter", 10))
inputs = (g_repl(np.asarray(T_kf, np.float32)), g_repl(np.asarray(free)),
          g_shard(idist_s), g_shard(pv_s),
          {k: g_shard(v) for k, v in obs_s.items()},
          g_repl(np.asarray(deltas[0])), g_repl(np.asarray(deltas[1])))

T_d, id_d, chi2_d, _rn = dba(*inputs)
jax.block_until_ready(chi2_d)
t0 = time.perf_counter()
T_d, id_d, chi2_d, _rn = dba(*inputs)
jax.block_until_ready(chi2_d)
solve_ms = (time.perf_counter() - t0) * 1e3

T_d_np = np.asarray(T_d.addressable_data(0))
chi2_d_f = float(np.asarray(chi2_d.addressable_data(0)).reshape(()))
chi2_ref = float(ref["chi2_final"])
T_ref = np.asarray(ref["T_kf"])
id_ref = np.asarray(ref["idist"])
pv_np = np.asarray(pvalid)

# --- agreement gates (tolerances of tests/test_distributed_ba.py) ---
assert np.isfinite(chi2_d_f)
assert abs(chi2_d_f - chi2_ref) <= 0.1 * abs(chi2_ref) + 1e-5, \
    (chi2_d_f, chi2_ref)
t_diff = float(np.max(np.abs(T_d_np - T_ref)))
assert t_diff < 5e-3, t_diff

# this process's landmark shards vs the reference slice
id_diff = 0.0
for s in id_d.addressable_shards:
    lo = s.index[0].start or 0
    hi = s.index[0].stop or len(id_ref)
    sel = pv_np[lo:min(hi, len(id_ref))]
    a = np.asarray(s.data)[: len(sel)][sel]
    b = id_ref[lo:min(hi, len(id_ref))][sel]
    if len(a):
        id_diff = max(id_diff, float(np.max(np.abs(a - b) / (np.abs(b) + 1e-3))))
assert id_diff < 0.05, id_diff

print(f"[pid {PID}] 2-process distributed BA OK: chi2={chi2_d_f:.4e} "
      f"(single-device {chi2_ref:.4e}), max|dT|={t_diff:.2e}, "
      f"max rel d(idist)={id_diff:.2e}, solve {solve_ms:.0f} ms", flush=True)

if OUT and PID == 0:
    with open(OUT, "w") as f:
        json.dump({
            "ok": True, "n_processes": NPROC, "n_devices_global": len(devs),
            "chi2_distributed": chi2_d_f, "chi2_single_device": chi2_ref,
            "max_T_diff": t_diff, "max_rel_idist_diff": id_diff,
            "solve_ms_cpu": round(solve_ms, 1),
            "problem": "pipeline-captured window (artifacts/bench_ba.npz)",
        }, f, indent=1)

jax.distributed.shutdown()
