"""ATE evaluator: exact recovery of a known Sim3 offset, association, CLI."""

import os
import subprocess
import sys

import numpy as np

from hso_tpu.utils.evaluate import associate, ate, evaluate_tum_files, umeyama


def _traj(n=60, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, n)
    xyz = np.stack([np.cos(t), np.sin(t), 0.1 * t], axis=1)
    return xyz + 0.0 * rng.standard_normal((n, 3))


def _random_sim3(seed=1):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((3, 3))
    Q, _ = np.linalg.qr(A)
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    s = 2.37
    t = rng.standard_normal(3) * 5.0
    return s, Q, t


def test_umeyama_exact_recovery():
    xyz = _traj()
    s, R, t = _random_sim3()
    dst = (s * (R @ xyz.T)).T + t
    s2, R2, t2 = umeyama(xyz, dst, with_scale=True)
    assert abs(s2 - s) < 1e-9
    assert np.abs(R2 - R).max() < 1e-9
    assert np.abs(t2 - t).max() < 1e-9


def test_ate_zero_after_alignment():
    xyz = _traj()
    s, R, t = _random_sim3(seed=2)
    est = (s * (R @ xyz.T)).T + t
    res = ate(est, xyz, with_scale=True)
    assert res.rmse < 1e-9
    assert abs(res.scale - 1.0 / s) < 1e-9


def test_ate_detects_noise():
    xyz = _traj()
    rng = np.random.default_rng(3)
    est = xyz + 0.05 * rng.standard_normal(xyz.shape)
    res = ate(est, xyz, with_scale=True)
    assert 0.02 < res.rmse < 0.1


def test_associate_nearest_and_one_to_one():
    a = np.array([0.0, 1.0, 2.0, 3.0])
    b = np.array([0.005, 1.4, 2.002, 2.006])
    ia, ib = associate(a, b, max_dt=0.02)
    # 0→0.005, 2→2.002 match; 1 has nothing within 20ms; 3 has nothing;
    # 2.006 must NOT also pair with 2.0 (1:1)
    assert list(ia) == [0, 2]
    assert list(b[ib]) == [0.005, 2.002]


def test_tum_files_and_cli(tmp_path):
    xyz = _traj(40)
    s, R, t = _random_sim3(seed=4)
    est = (s * (R @ xyz.T)).T + t
    f_est = tmp_path / "est.txt"
    f_gt = tmp_path / "gt.txt"
    for path, arr in ((f_est, est), (f_gt, xyz)):
        with open(path, "w") as fh:
            fh.write("# stamp tx ty tz qx qy qz qw\n")
            for i, p in enumerate(arr):
                fh.write(f"{i*0.1:.6f} {p[0]} {p[1]} {p[2]} 0 0 0 1\n")
    res = evaluate_tum_files(str(f_est), str(f_gt))
    assert res.rmse < 1e-9 and res.n_pairs == 40

    out = subprocess.run(
        [sys.executable, "scripts/evaluate_ate.py", str(f_est), str(f_gt),
         "--json"],
        capture_output=True, text=True, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, out.stderr
    import json

    d = json.loads(out.stdout)
    assert d["ate_rmse"] < 1e-9
