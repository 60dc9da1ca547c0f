"""Feature detection: FAST-9 corners + Shi-Tomasi, edgelets, grid selection.

Batched re-design of the reference's hybrid ``FeatureExtractor``
(/root/reference/src/feature_detection.cpp) and the machine-generated SSE
FAST library (/root/reference/thirdparty/fast): everything becomes dense
branch-free score maps over the pyramid plus a cell-grid argmax reduction.

Mapping from the reference:
  * ``fast_corner_detect_9_sse2`` + ``fast_corner_score_9`` + ``fast_nonmax_3x3``
    (feature_detection.cpp:518-545) → :func:`fast9_mask` (bitwise cyclic
    run-of-9 test over the 16-pixel Bresenham ring) with 3×3 NMS on the
    Shi-Tomasi response (the reference NMS-ranks by FAST score then *stores*
    the Shi-Tomasi score; we rank directly by Shi-Tomasi — a finer measure).
  * ``shiTomasiScore`` (vikit/vision.cpp:111-152) → :func:`shi_tomasi_map`
    (same 8×8 box, same normalisation, dense via box-filter convs).
  * Canny-on-Sobel edgelets (feature_detection.cpp:749-830) →
    :func:`edgelet_map`: gradient magnitude with along-gradient non-max
    suppression and the reference's high threshold (70·minThresh on the
    Sobel-5 magnitude); Canny's hysteresis step (a serial flood fill) is
    deliberately dropped — selection is per-cell max-gradient anyway.
  * ORB-SLAM quadtree distribution (``computeKeyPointsOctTree``,
    feature_detection.cpp:833-1124) → per-cell species-priority argmax over a
    static global cell grid + top-k by score: same spatial-uniformity goal,
    deterministic, O(1) depth, shape-static.

Corners win cells over edgelets; occupied cells (existing tracked features)
are suppressed — matching ``setExistingFeatures``/``setGridOccpuancy``.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

#: Bresenham circle radius-3 ring, clockwise from 12 o'clock (dx, dy)
FAST_RING = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    np.int32,
)


def _shift2d(img: jnp.ndarray, dx: int, dy: int) -> jnp.ndarray:
    """img shifted so out[y, x] = img[y + dy, x + dx] (zero padded)."""
    h, w = img.shape
    out = jnp.zeros_like(img)
    ys = slice(max(dy, 0), h + min(dy, 0))
    yd = slice(max(-dy, 0), h + min(-dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    xd = slice(max(-dx, 0), w + min(-dx, 0))
    return out.at[yd, xd].set(img[ys, xs])


def _box_sum(img: jnp.ndarray, lo: int, hi: int) -> jnp.ndarray:
    """Sum over the box offsets [lo, hi) in both axes as separable
    shifted-slice adds that fuse into one elementwise pass (as in
    image/pyramid._sep_filter_replicate)."""
    h, w = img.shape
    n = hi - lo
    x = jnp.pad(img, ((-lo, hi - 1), (0, 0)))
    acc = x[0:h, :]
    for k in range(1, n):
        acc = acc + x[k:k + h, :]
    x = jnp.pad(acc, ((0, 0), (-lo, hi - 1)))
    acc = x[:, 0:w]
    for k in range(1, n):
        acc = acc + x[:, k:k + w]
    return acc


def shi_tomasi_map(img: jnp.ndarray) -> jnp.ndarray:
    """Dense Shi-Tomasi (min structure-tensor eigenvalue), 8×8 box, matching
    vikit/vision.cpp:111-152 (raw right-left differences, /(2·box_area))."""
    dx = _shift2d(img, 1, 0) - _shift2d(img, -1, 0)
    dy = _shift2d(img, 0, 1) - _shift2d(img, 0, -1)
    # box covers y in [v-4, v+4), x offsets [x_min-? ] — the reference sums an
    # 8x8 box whose top-left is (u-4, v-4)
    dxx = _box_sum(dx * dx, -4, 4)
    dyy = _box_sum(dy * dy, -4, 4)
    dxy = _box_sum(dx * dy, -4, 4)
    norm = 1.0 / (2.0 * 64.0)
    dxx, dyy, dxy = dxx * norm, dyy * norm, dxy * norm
    disc = jnp.sqrt(jnp.maximum((dxx + dyy) ** 2 - 4.0 * (dxx * dyy - dxy * dxy), 0.0))
    score = 0.5 * (dxx + dyy - disc)
    # zero near the boundary (patch must fit: 5px margin, vision.cpp:126-127)
    h, w = img.shape
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    ok = (xx >= 5) & (xx < w - 5) & (yy >= 5) & (yy < h - 5)
    return jnp.where(ok, score, 0.0)


def fast9_mask(img: jnp.ndarray, thresh: float) -> jnp.ndarray:
    """FAST-9 segment test: ≥9 contiguous ring pixels all brighter than
    center+t or all darker than center−t (branch-free cyclic AND-of-rolls)."""
    rings = jnp.stack([_shift2d(img, int(dx), int(dy)) for dx, dy in FAST_RING])
    bright = rings > img[None] + thresh
    dark = rings < img[None] - thresh

    def has_run9(m):
        acc = m
        for k in range(1, 9):
            acc = acc & jnp.roll(m, -k, axis=0)
        return jnp.any(acc, axis=0)

    corner = has_run9(bright) | has_run9(dark)
    h, w = img.shape
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    ok = (xx >= 3) & (xx < w - 3) & (yy >= 3) & (yy < h - 3)
    return corner & ok


def nms3_keep(score: jnp.ndarray) -> jnp.ndarray:
    """True where score is the max of its 3×3 neighbourhood, with a
    lexicographic tie-break (ties go to the top-left-most pixel) so plateaus
    still yield exactly one winner."""
    keep = jnp.ones_like(score, dtype=bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            n = _shift2d(score, dx, dy)
            if (dy, dx) < (0, 0):  # neighbour precedes in scan order: it wins ties
                keep &= score > n
            else:
                keep &= score >= n
    return keep


def edgelet_map(sobel_x: jnp.ndarray, sobel_y: jnp.ndarray, min_thresh: float):
    """(edge_strength, gx, gy): gradient magnitude where it is a local max
    along the gradient direction and above the reference's Canny high
    threshold (70·minThresh, feature_detection.cpp:758)."""
    mag = jnp.sqrt(sobel_x**2 + sobel_y**2)
    # quantize direction into 4 bins; compare against the two neighbours
    ax = jnp.abs(sobel_x)
    ay = jnp.abs(sobel_y)
    tan22 = 0.4142135624
    tan67 = 2.4142135624
    ratio = ay / jnp.maximum(ax, 1e-6)
    horiz = ratio < tan22                      # gradient along x → neighbours x±1
    vert = ratio > tan67                       # gradient along y → neighbours y±1
    diag_main = (~horiz) & (~vert) & (jnp.sign(sobel_x) == jnp.sign(sobel_y))
    n1 = jnp.where(
        horiz, _shift2d(mag, 1, 0),
        jnp.where(vert, _shift2d(mag, 0, 1),
                  jnp.where(diag_main, _shift2d(mag, 1, 1), _shift2d(mag, 1, -1))),
    )
    n2 = jnp.where(
        horiz, _shift2d(mag, -1, 0),
        jnp.where(vert, _shift2d(mag, 0, -1),
                  jnp.where(diag_main, _shift2d(mag, -1, -1), _shift2d(mag, -1, 1))),
    )
    keep = (mag >= n1) & (mag > n2) & (mag > 70.0 * min_thresh)
    return jnp.where(keep, mag, 0.0), sobel_x, sobel_y


def _cell_argmax(score: jnp.ndarray, cell: int):
    """Per-cell max + (y, x) of the argmax. Pads to cell multiples.
    Returns (best (Cy, Cx), y (Cy, Cx), x (Cy, Cx))."""
    h, w = score.shape
    cy = -(-h // cell)
    cx = -(-w // cell)
    pad = jnp.pad(score, ((0, cy * cell - h), (0, cx * cell - w)))
    blocks = pad.reshape(cy, cell, cx, cell).transpose(0, 2, 1, 3).reshape(cy, cx, -1)
    best = jnp.max(blocks, axis=-1)
    idx = jnp.argmax(blocks, axis=-1)
    iy = idx // cell
    ix = idx % cell
    gy = jnp.arange(cy)[:, None] * cell + iy
    gx = jnp.arange(cx)[None, :] * cell + ix
    return best, gy, gx


# species codes (match Feature::FeatureType roles)
CORNER, EDGELET, GRADIENT = 0, 1, 2


@functools.partial(
    jax.jit, static_argnames=("n_levels", "cell0", "n_out", "border",
                              "with_gradient")
)
def detect_features(
    pyr,
    sobel_x,
    sobel_y,
    grad_mean,
    occupied,          # (Cy, Cx) bool — cells already holding tracked features
    n_levels: int = 3,
    cell0: int = 32,
    n_out: int = 384,
    border: int = 8,
    with_gradient: bool = True,
):
    """Hybrid detection over the pyramid → top-``n_out`` features.

    Returns a dict of (n_out,) arrays: ``px`` (level-0 coords, (n_out,2)),
    ``level``, ``species``, ``score``, ``grad`` (normalized edgelet normal),
    ``valid``.
    """
    h0, w0 = pyr[0].shape
    cy = -(-h0 // cell0)
    cx = -(-w0 // cell0)

    best_score = jnp.full((cy, cx), 0.0)
    best_meta = [jnp.zeros((cy, cx), jnp.float32) for _ in range(6)]
    # meta: x0, y0, level, species, gx, gy

    def merge(cond, score, x0, y0, level, species, gx, gy):
        nonlocal best_score, best_meta
        upd = cond & (score > best_score)
        best_score = jnp.where(upd, score, best_score)
        vals = [x0, y0, jnp.full_like(x0, level), jnp.full_like(x0, species), gx, gy]
        best_meta = [jnp.where(upd, v, m) for v, m in zip(vals, best_meta)]

    # pass 1: corners (priority species — an offset lifts them above edgelets)
    CORNER_PRIORITY = 1e6
    for lvl in range(n_levels):
        img = pyr[lvl]
        cell = max(cell0 >> lvl, 4)
        st = shi_tomasi_map(img)
        corner = fast9_mask(img, grad_mean)
        hl, wl = img.shape
        yy = jnp.arange(hl)[:, None]
        xx = jnp.arange(wl)[None, :]
        inb = (xx >= border) & (xx <= wl - border) & (yy >= border) & (yy <= hl - border)
        masked = jnp.where(corner & inb, st, 0.0)
        # NMS among corner candidates only (fast_nonmax_3x3 semantics:
        # non-corner neighbours don't compete)
        cscore = jnp.where(nms3_keep(masked), masked, 0.0)
        cbest, gy_l, gx_l = _cell_argmax(cscore, cell)
        cbest = _fit(cbest, cy, cx)
        gy_l, gx_l = _fit(gy_l, cy, cx), _fit(gx_l, cy, cx)
        scale = float(1 << lvl)
        merge(
            cbest > 0.0,
            cbest + CORNER_PRIORITY,
            gx_l.astype(jnp.float32) * scale,
            gy_l.astype(jnp.float32) * scale,
            float(lvl), float(CORNER), jnp.zeros_like(cbest), jnp.zeros_like(cbest),
        )

    # pass 2: edgelets (only beat empty cells — scores lack the priority offset)
    for lvl in range(n_levels):
        cell = max(cell0 >> lvl, 4)
        emag, sx, sy = edgelet_map(sobel_x[lvl], sobel_y[lvl], grad_mean)
        hl, wl = pyr[lvl].shape
        yy = jnp.arange(hl)[:, None]
        xx = jnp.arange(wl)[None, :]
        inb = (xx >= border) & (xx <= wl - border) & (yy >= border) & (yy <= hl - border)
        escore = jnp.where(inb, emag, 0.0)
        ebest, gy_l, gx_l = _cell_argmax(escore, cell)
        ebest = _fit(ebest, cy, cx)
        gy_l, gx_l = _fit(gy_l, cy, cx), _fit(gx_l, cy, cx)
        # fetch the gradient at the argmax via one-hot (small: per cell)
        exg = _gather_cells(sx, gy_l, gx_l)
        eyg = _gather_cells(sy, gy_l, gx_l)
        scale = float(1 << lvl)
        merge(
            ebest > 0.0,
            ebest,
            gx_l.astype(jnp.float32) * scale,
            gy_l.astype(jnp.float32) * scale,
            float(lvl), float(EDGELET), exg, eyg,
        )

    best_score = jnp.where(occupied, 0.0, best_score)

    # pass 3: gradient species (``gradDetectST``,
    # /root/reference/src/feature_detection.cpp:609-664): a cell that neither
    # a corner nor an edgelet claimed takes its max-|∇I| pixel when it clears
    # 20·minThresh — the third species that carries tracking in corner-poor,
    # edge-poor texture (smooth shading).  The reference's shipped detect()
    # has the call commented out (feature_detection.cpp:435-436) but all its
    # downstream plumbing (kGrad species → Feature::GRADIENT with a gradient
    # normal, feature_detection.cpp:465-473) is live; ours ships it behind
    # ``with_gradient`` (Config.use_gradient_features).  Unlike edgelets, no
    # along-gradient NMS is required — smooth shading has no ridge to thin.
    if with_gradient:
        gscore = jnp.zeros((cy, cx), jnp.float32)
        gmeta = [jnp.zeros((cy, cx), jnp.float32) for _ in range(6)]
        for lvl in range(n_levels):
            cell = max(cell0 >> lvl, 4)
            mag = jnp.sqrt(sobel_x[lvl] ** 2 + sobel_y[lvl] ** 2)
            hl, wl = pyr[lvl].shape
            yy = jnp.arange(hl)[:, None]
            xx = jnp.arange(wl)[None, :]
            inb = (xx >= border) & (xx <= wl - border) & (yy >= border) & (yy <= hl - border)
            gmag = jnp.where(inb & (mag > 20.0 * grad_mean), mag, 0.0)
            gbest, gy_l, gx_l = _cell_argmax(gmag, cell)
            gbest = _fit(gbest, cy, cx)
            gy_l, gx_l = _fit(gy_l, cy, cx), _fit(gx_l, cy, cx)
            gxg = _gather_cells(sobel_x[lvl], gy_l, gx_l)
            gyg = _gather_cells(sobel_y[lvl], gy_l, gx_l)
            scale = float(1 << lvl)
            upd = gbest > gscore
            gscore = jnp.where(upd, gbest, gscore)
            vals = [gx_l.astype(jnp.float32) * scale,
                    gy_l.astype(jnp.float32) * scale,
                    jnp.full_like(gbest, float(lvl)),
                    jnp.full_like(gbest, float(GRADIENT)), gxg, gyg]
            gmeta = [jnp.where(upd, v, m) for v, m in zip(vals, gmeta)]
        fill = (best_score <= 0.0) & ~occupied & (gscore > 0.0)
        best_score = jnp.where(fill, gscore, best_score)
        best_meta = [jnp.where(fill, g, m) for g, m in zip(gmeta, best_meta)]

    # Spatial-uniformity tiers (the quadtree-distribution analogue,
    # computeKeyPointsOctTree feature_detection.cpp:833-1124): a cell that
    # wins its 2×2-cell block outranks every runner-up, and a 4×4-block
    # winner outranks 2×2 winners — the budget spreads across the image
    # before it deepens into the sharpest-textured region.  Without this a
    # plain top-k clusters all n_out features wherever per-pixel contrast is
    # highest (e.g. the far wall of a corridor), starving near structure.
    def _block_winner(score, b):
        cyl, cxl = score.shape
        by, bx = -(-cyl // b), -(-cxl // b)
        pad = jnp.pad(score, ((0, by * b - cyl), (0, bx * b - cxl)))
        bmax = pad.reshape(by, b, bx, b).max(axis=(1, 3))
        up = jnp.repeat(jnp.repeat(bmax, b, 0), b, 1)[:cyl, :cxl]
        return (score >= up) & (score > 0.0)

    sel_score = (
        best_score
        + jnp.where(_block_winner(best_score, 2), 1e8, 0.0)
        + jnp.where(_block_winner(best_score, 4), 2e8, 0.0)
    )

    flat_score = best_score.reshape(-1)
    k = min(n_out, flat_score.shape[0])
    _, top_idx = jax.lax.top_k(sel_score.reshape(-1), k)
    top_scores = flat_score[top_idx]
    metas = [m.reshape(-1)[top_idx] for m in best_meta]
    x0, y0, level, species, gx, gy = metas
    valid = top_scores > 0.0
    gnorm = jnp.sqrt(gx * gx + gy * gy)
    grad = jnp.stack([gx, gy], axis=-1) / jnp.maximum(gnorm, 1e-6)[:, None]

    pad = n_out - k
    def padded(a):
        return jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)) if pad else a

    return {
        "px": padded(jnp.stack([x0, y0], axis=-1)),
        "level": padded(level.astype(jnp.int32)),
        "species": padded(species.astype(jnp.int32)),
        "score": padded(jnp.where(valid, top_scores - jnp.where(species == CORNER, 1e6, 0.0), 0.0)),
        "grad": padded(grad),
        "valid": padded(valid),
    }


def _fit(a: jnp.ndarray, cy: int, cx: int) -> jnp.ndarray:
    """Pad-or-crop a per-cell map to the global (cy, cx) grid (level grids can
    differ by one cell when image dims aren't divisible)."""
    ay, ax = a.shape
    a = a[: min(ay, cy), : min(ax, cx)]
    return jnp.pad(a, ((0, cy - a.shape[0]), (0, cx - a.shape[1])))


def _gather_cells(img: jnp.ndarray, gy: jnp.ndarray, gx: jnp.ndarray) -> jnp.ndarray:
    """Read img at per-cell argmax positions — small (Cy*Cx) gather."""
    h, w = img.shape
    flat = img.reshape(-1)
    idx = jnp.clip(gy, 0, h - 1) * w + jnp.clip(gx, 0, w - 1)
    return jnp.take(flat, idx.reshape(-1), axis=0).reshape(gy.shape).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("h", "w", "cell0"))
def occupancy_grid(px, valid, h: int, w: int, cell0: int):
    """Mark cells containing existing features (setExistingFeatures analogue).

    px: (N, 2) level-0 coords. Returns (Cy, Cx) bool.  Scatter-free: a
    (N, C) cell-membership comparison reduced over N — XLA CPU's scatter
    lowering for the 2-D ``.at[iy, ix].max`` form costs SECONDS to compile
    (and the eager form recompiled per input length); the dense compare is
    a trivially-vectorized reduction at these sizes (N ≤ n_fts_max,
    C ≤ ~300).  Callers must pass a FIXED-length px/valid pair (pad with
    valid=False) so the trace is reused."""
    cy = -(-h // cell0)
    cx = -(-w // cell0)
    ix = jnp.clip((px[:, 0] // cell0).astype(jnp.int32), 0, cx - 1)
    iy = jnp.clip((px[:, 1] // cell0).astype(jnp.int32), 0, cy - 1)
    cidx = iy * cx + ix
    hit = (cidx[:, None] == jnp.arange(cy * cx, dtype=jnp.int32)[None, :])
    return (hit & valid[:, None]).any(axis=0).reshape(cy, cx)
