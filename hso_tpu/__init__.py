"""hso_tpu — a JAX hybrid sparse monocular visual-odometry framework.

A from-scratch re-design of the capabilities of HSO ("Hybrid Sparse Monocular
Visual Odometry with Online Photometric Calibration", IJRR 2022; reference in
C++) for one accelerator, an NVIDIA GPU:

* all O(N·patch) math is batched, statically-shaped JAX (XLA) code,
* the branchy per-frame state machine is thin host Python,
* the sliding-window bundle adjustment is a purpose-built Schur-complement
  Levenberg-Marquardt solver that shards keyframe/point blocks over a
  ``jax.sharding.Mesh`` and reduces camera-camera Hessian blocks with ``psum``
  (replacing the reference's g2o),
* the reference's SSE kernels (Accumulator7, ZMSSD, align2D_SSE2, halfSample)
  map onto fused XLA/Pallas device kernels.

Where the reference spreads work over threads (tracking thread + mapping
thread + 4 reduce workers), this framework is deterministic and synchronous by
default: the "mapping thread" work is a batched device kernel that runs after
tracking each frame.
"""

__version__ = "0.1.0"

from hso_tpu.config import Config  # noqa: F401
