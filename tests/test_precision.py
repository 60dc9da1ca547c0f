"""Every f32 matmul and convolution on the main path states its precision.

A GPU may run an f32 ``dot_general`` or ``conv_general_dilated`` at DEFAULT
precision in TF32 (10 mantissa bits), which cannot hold pixel coordinates
above 512 px to a quarter pixel or integer ids above 2048.  These tests walk
the traced programs of the fused per-frame step, the windowed BA solve and
the keyframe seed work, and fail on any f32 contraction left at DEFAULT.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hso_tpu.cameras import PinholeCamera
from hso_tpu.config import Config

_CONTRACTIONS = ("dot_general", "conv_general_dilated")


def _sub_jaxprs(params):
    for v in params.values():
        for sub in (v if isinstance(v, (list, tuple)) else [v]):
            if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                yield sub.jaxpr
            elif hasattr(sub, "eqns"):
                yield sub


def default_f32_contractions(jaxpr) -> list[str]:
    """Source locations of f32 contractions at DEFAULT precision, found by
    walking ``jaxpr`` and every nested jaxpr (jit, loops, conds)."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in _CONTRACTIONS:
            f32 = any(v.aval.dtype == jnp.float32 for v in eqn.invars)
            prec = eqn.params.get("precision")
            if isinstance(prec, tuple):
                default = all(p in (None, jax.lax.Precision.DEFAULT) for p in prec)
            else:
                default = prec in (None, jax.lax.Precision.DEFAULT)
            if f32 and default:
                tb = eqn.source_info.traceback
                frames = [f for f in (tb.frames if tb else [])
                          if "hso_tpu" in f.file_name]
                where = (f"{frames[0].file_name}:{frames[0].line_num}"
                         if frames else "?")
                found.append(f"{eqn.primitive.name} at {where}")
        for sub in _sub_jaxprs(eqn.params):
            found += default_f32_contractions(sub)
    return found


def test_walker_flags_a_default_dot():
    def f(a, b):
        return a @ b, jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)

    x = jnp.ones((4, 4), jnp.float32)
    found = default_f32_contractions(jax.make_jaxpr(f)(x, x).jaxpr)
    assert len(found) == 1, found
    # integer contractions are exact at any precision
    xi = jnp.ones((4, 4), jnp.int32)
    assert default_f32_contractions(
        jax.make_jaxpr(lambda a: jax.lax.while_loop(
            lambda c: c[0, 0] < 3, lambda c: c @ a, a))(xi).jaxpr) == []


@pytest.fixture(scope="module")
def handler():
    from hso_tpu.pipeline.frame_handler import FrameHandler

    cam = PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)
    return FrameHandler(cam, Config())


def test_fused_step_pins_precision(handler):
    vo = handler
    img = np.zeros((vo.cam.height, vo.cam.width), np.uint8)
    fr = vo._make_frame(img, 0.0)
    T = jnp.eye(3, 4, dtype=jnp.float32)
    args = (jnp.asarray(img), fr.data["pyr"], jnp.float32(0.0), T,
            vo._prev_obs_dev(fr), jnp.float32(1.0), jnp.float32(1.0), T,
            vo._snapshot(), vo.seeds, jnp.float32(1e-3),
            jnp.zeros((2, vo.points.p_max), jnp.int32))
    jaxpr = jax.make_jaxpr(vo._fused_step())(*args).jaxpr
    assert default_f32_contractions(jaxpr) == []


def test_ba_solve_pins_precision():
    from hso_tpu.ba.local_ba import local_bundle_adjustment
    from test_local_ba import make_ba_problem

    prob = make_ba_problem(n_kf=4, n_pts=32, K=4, P=64)
    jaxpr = jax.make_jaxpr(
        lambda T, free, idist, pv, obs: local_bundle_adjustment(
            T, free, idist, pv, obs, n_kf=prob["K"], n_pts=64, n_iter=2)
    )(prob["T_kf"], prob["free"], prob["idist"], prob["point_valid"],
      prob["obs"]).jaxpr
    assert default_f32_contractions(jaxpr) == []


def test_seed_work_pins_precision(handler):
    from hso_tpu.mapping.depth_filter import harvest_and_prune, update_seeds

    vo = handler
    img = np.zeros((vo.cam.height, vo.cam.width), np.uint8)
    d = vo._make_frame(img, 0.0).data
    snap = vo._snapshot()
    T = jnp.eye(3, 4, dtype=jnp.float32)
    sweep = jax.make_jaxpr(
        lambda seeds: update_seeds(
            seeds, snap["ring_T"], snap["ring_exp"], d["pyr"], d["sobel_x"],
            d["sobel_y"], T, jnp.float32(1.0), jnp.float32(1e-3), vo.cam)
    )(vo.seeds).jaxpr
    harvest = jax.make_jaxpr(
        lambda seeds: harvest_and_prune(seeds, jnp.int32(0), snap["ring_T"])
    )(vo.seeds).jaxpr
    assert default_f32_contractions(sweep) == []
    assert default_f32_contractions(harvest) == []
