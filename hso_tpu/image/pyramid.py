"""Image frontend: pyramid, Sobel pyramid, photometric frame statistics.

Batched replacement for the reference's frame construction
(/root/reference/src/frame.cpp:82-246 ``initFrame``/``prepareForFeatureDetect``
and /root/reference/src/vikit/vision.cpp:19-110 ``halfSampleSSE2``): one jitted
function produces the whole pyramid stack, Sobel-5 gradient pyramids, the mean
interior gradient magnitude (keyframe-criterion / detector threshold input) and
mean interior intensity (exposure-ratio prior) in a single device dispatch.

Images are float32 arrays in [0, 255] throughout (the reference keeps u8
pyramids and converts per-patch; here one upfront convert serves every later
gather).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

#: OpenCV ksize=5 separable Sobel taps: smooth ⊗ derivative
#: (cv::getDerivKernels(1, 0, 5) == [1 4 6 4 1] x [-1 -2 0 2 1]).
_SOBEL5_SMOOTH = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32)
_SOBEL5_DERIV = np.array([-1.0, -2.0, 0.0, 2.0, 1.0], np.float32)


def half_sample(img: jnp.ndarray) -> jnp.ndarray:
    """2x2 box-filter downsample (reference halfSample, vision.cpp:19-110).

    Implemented as a 2×2/stride-2 ``reduce_window`` (average pool), one
    fused op instead of four stride-2 slices."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    img = img[: 2 * h2, : 2 * w2]
    return jax.lax.reduce_window(
        img, 0.0, jax.lax.add, (2, 2), (2, 2), "VALID"
    ) * 0.25


def _sep_filter_replicate(img: jnp.ndarray, kv: np.ndarray, kh: np.ndarray) -> jnp.ndarray:
    """Separable 2D filter with edge-replicate padding (cv BORDER_REPLICATE).

    Implemented as shift-and-add over static stride-1 slices rather than
    ``conv_general_dilated``: the tap sum fuses into one elementwise pass
    and needs no matmul precision."""
    pad = len(kv) // 2
    h, w = img.shape
    x = jnp.pad(img, ((pad, pad), (0, 0)), mode="edge")
    acc = None
    for k, c in enumerate(kv):
        if c == 0.0:
            continue
        term = float(c) * x[k : k + h, :]
        acc = term if acc is None else acc + term
    x = jnp.pad(acc, ((0, 0), (pad, pad)), mode="edge")
    acc = None
    for k, c in enumerate(kh):
        if c == 0.0:
            continue
        term = float(c) * x[:, k : k + w]
        acc = term if acc is None else acc + term
    return acc


def sobel5(img: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(gx, gy) with OpenCV Sobel ksize=5 semantics (frame.cpp:216-220)."""
    gx = _sep_filter_replicate(img, _SOBEL5_SMOOTH, _SOBEL5_DERIV)
    gy = _sep_filter_replicate(img, _SOBEL5_DERIV, _SOBEL5_SMOOTH)
    return gx, gy


@functools.partial(jax.jit, static_argnames=("n_pyr_levels", "n_total_levels"))
def build_frame_pyramids(
    img_u8: jnp.ndarray, n_pyr_levels: int = 3, n_total_levels: int = 5
):
    """One dispatch: pyramid + Sobel pyramids + frame statistics.

    Returns a dict:
      ``pyr``       tuple of ``n_total_levels`` float32 images (level 0 full res)
      ``sobel_x/y`` tuples of ``n_pyr_levels`` gradient images
      ``grad_mean`` clipped mean interior |∇I| (frame.cpp:223-246: /30, clip [7,20])
      ``intensity_mean`` mean interior intensity ("integralImage_", exposure prior)
    """
    img0 = img_u8.astype(jnp.float32)
    pyr = [img0]
    for _ in range(1, n_total_levels):
        pyr.append(half_sample(pyr[-1]))

    sobel_x, sobel_y = [], []
    for lvl in range(n_pyr_levels):
        gx, gy = sobel5(pyr[lvl])
        sobel_x.append(gx)
        sobel_y.append(gy)

    # interior margin of 16px (frame.cpp:224-226); degrade gracefully for
    # images too small to have one (synthetic/unit-test sizes)
    m = 16 if min(img0.shape[0], img0.shape[1]) > 32 else 0
    interior = (slice(m, img0.shape[0] - m or None), slice(m, img0.shape[1] - m or None))
    gmag = jnp.sqrt(sobel_x[0][interior] ** 2 + sobel_y[0][interior] ** 2)
    grad_mean = jnp.clip(jnp.mean(gmag) / 30.0, 7.0, 20.0)
    intensity_mean = jnp.mean(img0[interior])

    return {
        "pyr": tuple(pyr),
        "sobel_x": tuple(sobel_x),
        "sobel_y": tuple(sobel_y),
        "grad_mean": grad_mean,
        "intensity_mean": intensity_mean,
    }


@jax.jit
def remap_bilinear(img: jnp.ndarray, map_x: jnp.ndarray, map_y: jnp.ndarray) -> jnp.ndarray:
    """Whole-image undistortion: out[i,j] = bilinear(img, map_x[i,j], map_y[i,j]).

    Device-side equivalent of cv::remap INTER_LINEAR (camera.cpp:127-131);
    out-of-range source pixels clamp to the border.
    """
    from hso_tpu.image.interp import bilinear

    vals = bilinear(img.astype(jnp.float32), map_x.reshape(-1), map_y.reshape(-1))
    return vals.reshape(map_x.shape)
