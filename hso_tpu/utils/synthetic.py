"""Synthetic planar scene renderer — ground-truth data for tests and benches.

Renders views of a textured plane (world z = z0) for any camera pose with
known per-pixel depth, giving every estimator a closed-loop oracle: the
reference has no unit tests at all (SURVEY.md §4); this is the foundation of
ours.  Pure host-side numpy/scipy — not part of the measured compute path.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter, map_coordinates

from hso_tpu.math import se3np


def _texture(rng, size: int, blur: float) -> np.ndarray:
    """Blurred uniform noise renormalised to grey levels [15, 235].  The
    blur reflects at the border without repeating the edge pixel and spans
    4σ, as OpenCV's ``GaussianBlur`` does on float input."""
    t = rng.integers(0, 256, size=(size, size)).astype(np.float32)
    t = gaussian_filter(t, blur, mode="mirror", truncate=4.0)
    return (t - t.min()) / (t.max() - t.min()) * 220.0 + 15.0


class PlaneScene:
    def __init__(self, cam, z0: float = 2.0, extent: float = 2.0,
                 tex_size: int = 2048, seed: int = 0, blur: float = 2.0,
                 tex=None):
        self.cam = cam
        self.z0 = float(z0)
        self.extent = float(extent)  # plane spans [-extent, extent] in x and y
        if tex is None:
            tex = _texture(np.random.default_rng(seed), tex_size, blur)
        else:
            tex = np.asarray(tex, np.float32)
            tex_size = tex.shape[0]
        self.tex = tex
        self.tex_size = tex_size

    def _world_to_tex(self, x, y):
        s = self.tex_size / (2.0 * self.extent)
        return (x + self.extent) * s, (y + self.extent) * s

    def render(self, T_c_w=None, exposure: float = 1.0) -> np.ndarray:
        """Render the uint8 view from camera pose ``T_c_w`` (world→camera)."""
        if T_c_w is None:
            T_c_w = se3np.identity()
        T_w_c = se3np.inv(T_c_w)
        h, w = self.cam.height, self.cam.width
        v, u = np.mgrid[0:h, 0:w].astype(np.float64)
        px = np.stack([u.reshape(-1), v.reshape(-1)], axis=-1)
        f_cam = self.cam.cam2world(px)                      # (HW, 3) unit rays
        f_w = se3np.rotate(T_w_c, f_cam)
        t_w = se3np.translation(T_w_c)
        lam = (self.z0 - t_w[2]) / f_w[:, 2]
        p_w = t_w[None, :] + lam[:, None] * f_w
        tx, ty = self._world_to_tex(p_w[:, 0], p_w[:, 1])
        img = map_coordinates(
            self.tex, [ty.reshape(h, w), tx.reshape(h, w)], order=1,
            mode="constant", cval=0.0)
        behind = (lam <= 0).reshape(h, w)
        img = np.where(behind, 0.0, img) * exposure
        return np.clip(img, 0, 255).astype(np.uint8)

    def depth_along_ray(self, px: np.ndarray, T_c_w=None) -> np.ndarray:
        """Ground-truth distance along the bearing for pixels (N, 2)."""
        if T_c_w is None:
            T_c_w = se3np.identity()
        T_w_c = se3np.inv(T_c_w)
        f_cam = self.cam.cam2world(px)
        f_w = se3np.rotate(T_w_c, f_cam)
        t_w = se3np.translation(T_w_c)
        return (self.z0 - t_w[2]) / f_w[:, 2]

    def grid_features(self, step: int = 24, border: int = 24, T_c_w=None):
        """Regular grid of features: (px (N,2), f (N,3), dist (N,))."""
        h, w = self.cam.height, self.cam.width
        us = np.arange(border, w - border, step, dtype=np.float64)
        vs = np.arange(border, h - border, step, dtype=np.float64)
        uu, vv = np.meshgrid(us, vs)
        px = np.stack([uu.reshape(-1), vv.reshape(-1)], axis=-1)
        f = self.cam.cam2world(px)
        dist = self.depth_along_ray(px, T_c_w)
        return px, f, dist


class BoxScene:
    """Textured box interior (corridor): two side walls, floor, ceiling, and
    a back wall — genuine multi-depth structure with discontinuities, unlike
    :class:`PlaneScene`.  Camera at the origin looks down +z; the box spans
    x ∈ [-hw, hw], y ∈ [-hh, hh], z ∈ (-∞, depth]."""

    def __init__(self, cam, half_width: float = 2.0, half_height: float = 1.5,
                 depth: float = 6.0, tex_size: int = 2048, seed: int = 0,
                 blur: float = 2.0, stepped_back: bool = False):
        self.cam = cam
        rng = np.random.default_rng(seed)

        def tex():
            return _texture(rng, tex_size, blur)

        self.tex_size = tex_size
        hw, hh, d = float(half_width), float(half_height), float(depth)
        self.extent = max(hw, hh, d)
        m = 4.0  # texture margin beyond the nominal box, for camera excursions
        # entries: (p0, inward normal, u axis, v axis, (u_lo,u_hi) texture
        # range, (v_lo,v_hi), texture, hit_xlim) — per-plane texture ranges
        # keep texel density high on every wall; hit_xlim optionally bounds
        # accepted intersections in world x (for the stepped back wall)
        self.planes = [
            (np.r_[hw, 0, 0], np.r_[-1.0, 0, 0], np.r_[0, 0, 1.0], np.r_[0, 1.0, 0],
             (-m, d + m), (-hh - m, hh + m), tex(), None),
            (np.r_[-hw, 0, 0], np.r_[1.0, 0, 0], np.r_[0, 0, 1.0], np.r_[0, 1.0, 0],
             (-m, d + m), (-hh - m, hh + m), tex(), None),
            (np.r_[0, hh, 0], np.r_[0, -1.0, 0], np.r_[1.0, 0, 0], np.r_[0, 0, 1.0],
             (-hw - m, hw + m), (-m, d + m), tex(), None),
            (np.r_[0, -hh, 0], np.r_[0, 1.0, 0], np.r_[1.0, 0, 0], np.r_[0, 0, 1.0],
             (-hw - m, hw + m), (-m, d + m), tex(), None),
        ]
        if stepped_back:
            # near slab on the left half, far wall behind it: frontal
            # structure at two depths with an occlusion edge down the middle
            self.planes.append(
                (np.r_[0, 0, 0.55 * d], np.r_[0, 0, -1.0], np.r_[1.0, 0, 0],
                 np.r_[0, 1.0, 0], (-hw - m, hw + m), (-hh - m, hh + m),
                 tex(), (-np.inf, 0.0)))
            self.planes.append(
                (np.r_[0, 0, d], np.r_[0, 0, -1.0], np.r_[1.0, 0, 0],
                 np.r_[0, 1.0, 0], (-hw - m, hw + m), (-hh - m, hh + m),
                 tex(), None))
        else:
            self.planes.append(
                (np.r_[0, 0, d], np.r_[0, 0, -1.0], np.r_[1.0, 0, 0],
                 np.r_[0, 1.0, 0], (-hw - m, hw + m), (-hh - m, hh + m),
                 tex(), None))

    def _raycast(self, f_w: np.ndarray, t_w: np.ndarray):
        """Nearest positive plane hit per ray → (lam (N,), plane index)."""
        n = f_w.shape[0]
        lam_best = np.full(n, np.inf)
        idx_best = np.full(n, -1, np.int64)
        for i, plane in enumerate(self.planes):
            p0, nrm, xlim = plane[0], plane[1], plane[7]
            denom = f_w @ nrm
            with np.errstate(divide="ignore", invalid="ignore"):
                lam = ((p0 - t_w) @ nrm) / denom
            ok = (denom < -1e-9) & (lam > 1e-6) & (lam < lam_best)
            if xlim is not None:
                hit_x = t_w[0] + lam * f_w[:, 0]
                ok &= (hit_x >= xlim[0]) & (hit_x <= xlim[1])
            lam_best = np.where(ok, lam, lam_best)
            idx_best = np.where(ok, i, idx_best)
        return lam_best, idx_best

    def render(self, T_c_w=None, exposure: float = 1.0) -> np.ndarray:
        if T_c_w is None:
            T_c_w = se3np.identity()
        T_w_c = se3np.inv(T_c_w)
        h, w = self.cam.height, self.cam.width
        v, u = np.mgrid[0:h, 0:w].astype(np.float64)
        px = np.stack([u.reshape(-1), v.reshape(-1)], axis=-1)
        f_cam = self.cam.cam2world(px)
        f_w = se3np.rotate(T_w_c, f_cam)
        t_w = se3np.translation(T_w_c)
        lam, pidx = self._raycast(f_w, t_w)
        out = np.zeros(h * w, np.float32)
        for i, (p0, _nrm, axu, axv, ur, vr, tex, _xlim) in enumerate(self.planes):
            m = pidx == i
            if not m.any():
                continue
            hit = t_w[None, :] + lam[m, None] * f_w[m]
            tu = ((hit - p0) @ axu - ur[0]) / (ur[1] - ur[0]) * self.tex_size
            tv = ((hit - p0) @ axv - vr[0]) / (vr[1] - vr[0]) * self.tex_size
            tu = np.clip(tu, 0, self.tex_size - 1.001)
            tv = np.clip(tv, 0, self.tex_size - 1.001)
            u0 = tu.astype(np.int64)
            v0 = tv.astype(np.int64)
            fu = (tu - u0).astype(np.float32)
            fv = (tv - v0).astype(np.float32)
            out[m] = (
                tex[v0, u0] * (1 - fu) * (1 - fv)
                + tex[v0, u0 + 1] * fu * (1 - fv)
                + tex[v0 + 1, u0] * (1 - fu) * fv
                + tex[v0 + 1, u0 + 1] * fu * fv
            )
        img = out.reshape(h, w) * exposure
        return np.clip(img, 0, 255).astype(np.uint8)

    def depth_along_ray(self, px: np.ndarray, T_c_w=None) -> np.ndarray:
        if T_c_w is None:
            T_c_w = se3np.identity()
        T_w_c = se3np.inv(T_c_w)
        f_cam = self.cam.cam2world(px)
        f_w = se3np.rotate(T_w_c, f_cam)
        t_w = se3np.translation(T_w_c)
        lam, _ = self._raycast(f_w, t_w)
        return lam
