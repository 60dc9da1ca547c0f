"""Drive the hso_tpu foundation through its public surface.

Builds a synthetic camera scene, then exercises: frame pyramid construction on
device, camera project/backproject, SE3 pose chains, and whole-image
undistortion — printing observable numbers. Run with the default (GPU)
backend to validate the real target, or JAX_PLATFORMS=cpu for a quick check.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax
import jax.numpy as jnp

from hso_tpu.cameras import PinholeCamera
from hso_tpu.image.pyramid import build_frame_pyramids, remap_bilinear
from hso_tpu.math import se3np

print("backend devices:", jax.devices())

# synthetic textured image (float in [0,255])
rng = np.random.default_rng(0)
img = rng.integers(0, 256, size=(480, 752)).astype(np.uint8)
import cv2

img = cv2.GaussianBlur(img, (7, 7), 2.0)

t0 = time.time()
out = build_frame_pyramids(jnp.asarray(img))
jax.block_until_ready(out)
t1 = time.time()
out = build_frame_pyramids(jnp.asarray(img))
jax.block_until_ready(out)
t2 = time.time()
print(f"pyramid: compile+run {t1-t0:.2f}s, steady-state {1e3*(t2-t1):.2f}ms")
print("  levels:", [p.shape for p in out["pyr"]])
print(f"  grad_mean={float(out['grad_mean']):.3f} intensity_mean={float(out['intensity_mean']):.2f}")

cam = PinholeCamera(752, 480, 458.654, 457.296, 367.215, 248.375,
                    -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)
px = np.array([[100.0, 100.0], [376.0, 240.0], [700.0, 450.0]])
f = cam.cam2world(px)
px_back = cam.world2cam(f * 2.5)
print("camera roundtrip err (px):", np.abs(px_back - px).max())

# SE3: walk a circle and return
T = se3np.identity()
for k in range(8):
    T = se3np.mul(T, se3np.exp(np.r_[0.1, 0, 0, 0, 0, np.pi / 4]))
print("8-step circular walk returns to identity, err:",
      np.abs(T - se3np.identity()).max())

mx, my = cam.undistort_remap()
t0 = time.time()
rect = remap_bilinear(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my))
jax.block_until_ready(rect)
print(f"undistort remap on device: {time.time()-t0:.2f}s, out shape {rect.shape}, "
      f"mean {float(rect.mean()):.2f}")
print("OK")
