"""The per-frame pipeline state machine.

Batched re-design of ``FrameHandlerMono`` (HSO's src/
frame_handler_mono.cpp) — thin host orchestration over the batched device
kernels; the reference's tracking/mapping thread pair becomes a deterministic
synchronous sequence (tracking, then the mapping sweep, each one device
dispatch).

Stages (frame_handler_base.h:51-57): FIRST_FRAME → SECOND_FRAME →
DEFAULT_FRAME ⇄ RELOCALIZING.  The DEFAULT path per frame:

  coarse track (vs last frame) → reproject map into grid + batched direct
  matching → motion-only pose LM → tracking-quality gate → keyframe
  criterion → [KF: covisibility window + Schur BA + new seeds] →
  depth-filter observation sweep → motion model update.

Beyond the default path: TEMPORARY-point reprojection of unconverged seeds
on sparse frames, pre-frame seed backfill at keyframe creation (the mapping
thread's idle-time ``observeDepthWithPreviousFrameOnce``), per-point patch
source refresh at keyframes (``getCloseViewObs`` analogue), E-matrix vs
homography bootstrap model selection, and map-based relocalization.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time

import numpy as np
import jax.numpy as jnp

from hso_tpu.config import Config
from hso_tpu.image.pyramid import build_frame_pyramids
from hso_tpu.mapmodel.structures import (
    Frame,
    KeyframeWindow,
    PointTable,
    TYPE_CANDIDATE,
    TYPE_GOOD,
    TYPE_TEMPORARY,
    TYPE_UNKNOWN,
    crop_window,
    empty_obs,
)
from hso_tpu.mapping.depth_filter import (
    empty_seeds,
    harvest_and_prune,
    init_seeds,
    update_seeds,
)
from hso_tpu.math import se3np
from hso_tpu.math.epipolar_geometry import recover_pose_twoview, triangulate_midpoint
from hso_tpu.ops.detect import detect_features, occupancy_grid
from hso_tpu.ops.klt import track_klt
from hso_tpu.track.coarse_tracker import make_coarse_tracker
from hso_tpu.track.matcher import match_points, select_candidates
from hso_tpu.track.pose_optimizer import optimize_pose

STAGE_FIRST = "first"
STAGE_SECOND = "second"
STAGE_DEFAULT = "default"
STAGE_RELOC = "relocalizing"

RESULT_KEYFRAME = "keyframe"
RESULT_FRAME = "frame"
RESULT_FAILURE = "failure"
RESULT_NO_KEYFRAME = "no_keyframe"

SEED_RING = 8


@dataclasses.dataclass
class FrameResult:
    status: str
    T_f_w: np.ndarray
    n_matches: int = 0
    n_inliers: int = 0
    n_seeds_updated: int = 0
    err_px: float = 0.0


class FrameHandler:
    def __init__(self, cam, cfg: Config | None = None):
        self.cam = cam
        self.cfg = cfg or Config()
        self.points = PointTable(self.cfg.n_points_ba_max * 2)
        self.kfs = KeyframeWindow(k_all_max=self.cfg.max_n_kfs, recent=SEED_RING)
        self.points.kfs = self.kfs
        self.seeds = empty_seeds(self.cfg.n_seeds_max)
        self.seed_ring = np.full(SEED_RING, -1, np.int32)  # ring slot → kf idx
        self.batch_counter = 0
        self.stage = STAGE_FIRST
        self.motion_model = se3np.identity()
        self.last_frame: Frame | None = None
        self.first_frame: Frame | None = None
        self.frame_count = 0
        self.regular_counter = 0
        self.n_last_inliers = 0
        self.after_init = False
        self.tracking_bad = False
        self.reloc_fail_count = 0
        self.mean_converge_frames = 6.0
        self.px_error_angle = float(np.arctan(1.0 / (2.0 * cam.focal_mean)) * 2.0)
        self.trajectory: list[tuple[float, np.ndarray]] = []
        # static grid dims for the reprojector.  The reference sizes cells by
        # factor 0.6 (reprojector.cpp:53-56, ≈2.8·maxFts cells) and walks
        # cells serially until the match budget fills; here every candidate
        # cell is matched in ONE batched kernel, so the cell count must fit
        # the n_fts_max slot padding — factor 0.8 gives ≈1.6·maxFts cells
        # (≤ n_fts_max), trading the reference's deeper per-cell ranking for
        # a single fixed-shape dispatch (deliberate deviation).
        cell = max(int(np.sqrt(cam.width * cam.height / self.cfg.max_fts) * 0.8), 16)
        self._grid = (cell, -(-cam.height // cell), -(-cam.width // cell))
        # the fused step writes up to C kept matches into the frame's obs
        # slots and pads obs_next to the same count — size the tables to
        # whichever is larger so a small-cell grid can never overflow them
        self._n_obs_pad = max(self.cfg.n_fts_max, self._grid[1] * self._grid[2])
        self._occ_cell = 32
        self._init_px = None
        # retained recent frames for pre-frame seed backfill (the reference
        # keeps a frame_prior_ deque in DepthFilter, depth_filter.cpp:338-351)
        self.pre_frames: collections.deque = collections.deque(
            maxlen=self.cfg.pre_frames_max)
        # optional online photometric calibration (response/vignette; the
        # reference's PhotomatricCalibration is compiled out — see
        # hso_tpu/photometric/online_calib.py)
        self.photo = None
        if self.cfg.photometric_calib:
            from hso_tpu.photometric import OnlinePhotometricCalibrator

            self.photo = OnlinePhotometricCalibrator(cam)
        # fused-step snapshot cache (see _snapshot): heavy device uploads
        # happen only when a keyframe event bumps the map version
        self._map_version = 0
        self._snap_heavy = None
        self._snap_heavy_version = -1
        self._snap_light = None
        self._snap_light_version = -1
        # device-side point success/fail accumulators (2, p_max), drained at
        # keyframe events (_apply_lifecycle) — the per-frame host loop never
        # syncs them
        self._acc = None
        self._px_err_dev = None
        # rows whose patch/species data changed since the last heavy-snapshot
        # upload: the device mirror is patched with a row scatter instead of
        # re-uploading the full ~9 MB patch_win table every keyframe.  Every
        # writer of PointTable.patch_*/species MUST _mark_dirty its rows.
        self._dirty_rows: set[int] = set()
        # pipelined host loop (add_image_pipelined): the not-yet-finalized
        # frame, the latest dispatched seed branch, the device pose of the
        # frame before the pending one (for the on-device motion prior), the
        # pose of the most recently finalized frame, and the result queue
        self._pending = None
        self._seeds_spec = None
        self._motion_T_prev = None
        self._last_T_host = None
        self._due: collections.deque = collections.deque()
        # per-stage tracing (the reference's HSO_TRACE PerformanceMonitor,
        # frame_handler_base.cpp:54-81); enable via enable_tracing() or the
        # HSO_TRACE env var
        self.monitor = None
        if os.environ.get("HSO_TRACE"):
            self.enable_tracing(trace_dir=os.environ.get("HSO_TRACE_DIR", "/tmp"))

    #: the reference's registered timers + per-frame log values.  The
    #: per-frame stages are ONE fused dispatch (fused_frame_step subsumes
    #: pyramid_creation / sparse_img_align / reproject / pose_optimizer /
    #: seed_update); keyframe-time work keeps its own timers.
    TRACE_TIMERS = (
        "pyramid_creation", "fused_frame_step", "sparse_img_align",
        "reproject", "pose_optimizer", "local_ba", "seed_update",
        "feature_detection", "tot_time",
        # host-loop attribution (scripts/profile_host_loop.py): where each
        # steady-state frame's wall time goes — host prep, async dispatch,
        # the one packed sync, sparse-frame writebacks, keyframe events,
        # trailing host bookkeeping
        "host_prep", "fused_dispatch", "sync_packed", "writeback",
        "seed_rescue", "kf_event", "host_tail",
    )
    TRACE_LOGS = (
        "frame_id", "n_matches", "n_inliers", "n_seeds_updated", "n_kfs",
        "n_points", "is_keyframe", "err_px",
    )

    def enable_tracing(self, trace_name: str = "hso_tpu_trace",
                       trace_dir: str = "/tmp") -> None:
        from hso_tpu.utils.trace import PerformanceMonitor

        mon = PerformanceMonitor(trace_name, trace_dir)
        for t in self.TRACE_TIMERS:
            mon.add_timer(t)
        for l in self.TRACE_LOGS:
            mon.add_log(l)
        mon.init()
        self.monitor = mon

    def _t(self, name: str):
        """Stage-timer context (no-op when tracing is off).  Stage outputs are
        materialised to numpy inside each stage, so wall time is device time."""
        return self.monitor.timing(name) if self.monitor else contextlib.nullcontext()

    # ------------------------------------------------------------------ utils
    def _make_frame(self, img_u8: np.ndarray, ts: float) -> Frame:
        data = build_frame_pyramids(jnp.asarray(img_u8))
        f = Frame(
            frame_id=self.frame_count,
            timestamp=ts,
            T_f_w=se3np.identity(),
            data=data,
            obs=empty_obs(self._n_obs_pad),
        )
        f.grad_mean = float(data["grad_mean"])
        f.intensity_mean = float(data["intensity_mean"])
        return f

    def _detect(self, frame: Frame, occupied_px: np.ndarray | None,
                n_levels: int = 3, cell0: int = 32):
        h, w = self.cam.height, self.cam.width
        cy, cx = -(-h // cell0), -(-w // cell0)
        if occupied_px is None or len(occupied_px) == 0:
            occ = jnp.zeros((cy, cx), bool)
        else:
            # pad to a fixed slot count: a per-keyframe occupied count would
            # retrace occupancy_grid every call
            n_pad = self._n_obs_pad * 2
            px = np.zeros((n_pad, 2), np.float32)
            n = min(len(occupied_px), n_pad)
            px[:n] = occupied_px[:n]
            vmask = np.arange(n_pad) < n
            occ = occupancy_grid(
                jnp.asarray(px), jnp.asarray(vmask), h, w, cell0,
            )
        d = frame.data
        return detect_features(
            d["pyr"][:3], d["sobel_x"], d["sobel_y"], d["grad_mean"], occ,
            n_levels=n_levels, cell0=cell0, n_out=self.cfg.n_fts_max,
            with_gradient=bool(self.cfg.use_gradient_features),
        )

    # ------------------------------------------------------------------ stages
    def add_image(self, img_u8: np.ndarray, ts: float = 0.0) -> FrameResult:
        t_start = time.perf_counter()
        if self.monitor is not None:
            self.monitor.new_frame()
        img_in = img_u8
        if self.photo is not None:
            img_in = self.photo.correct(img_u8)  # linearize (identity until calibrated)
        if self.stage == STAGE_DEFAULT:
            # pyramid construction happens inside the fused step
            frame = Frame(
                frame_id=self.frame_count, timestamp=ts,
                T_f_w=se3np.identity(), data=None,
                obs=empty_obs(self._n_obs_pad),
            )
            res = self._process_default(frame, img_in)
        else:
            with self._t("pyramid_creation"):
                frame = self._make_frame(img_in, ts)
            if self.stage == STAGE_FIRST:
                res = self._process_first(frame)
            elif self.stage == STAGE_SECOND:
                res = self._process_second(frame)
            else:
                res = self._relocalize(frame)
        self.last_frame = frame
        self.frame_count += 1
        self.trajectory.append((ts, frame.T_f_w.copy()))
        if self.photo is not None and frame.obs is not None:
            # calibration samples come from the RAW image so the estimate
            # does not compound with the applied correction
            self.photo.add_frame_samples(np.asarray(img_u8), frame.obs)
        if self.monitor is not None:
            m = self.monitor
            m.set_timer("tot_time", time.perf_counter() - t_start)
            m.log("frame_id", self.frame_count - 1)
            m.log("n_matches", res.n_matches)
            m.log("n_inliers", res.n_inliers)
            m.log("n_seeds_updated", res.n_seeds_updated)
            m.log("n_kfs", len(self.kfs.frames))
            m.log("n_points", int(self.points.valid.sum()))
            m.log("is_keyframe", res.status == RESULT_KEYFRAME)
            m.log("err_px", res.err_px)
            m.update_finished()
        return res

    # ---------------------------------------------------------- pipelined
    def add_image_pipelined(self, img_u8: np.ndarray,
                            ts: float = 0.0) -> FrameResult | None:
        """Lag-1 pipelined ``add_image``: dispatch THIS frame's fused step
        immediately, then finalize the PREVIOUS frame's result while this
        one computes, so the host's work on one frame overlaps the device's
        work on the next.

        Semantics vs the synchronous loop: keyframe map/seed updates land
        one frame later (the next frame was already dispatched against the
        pre-keyframe snapshot — exactly the lag the reference's asynchronous
        mapping thread exhibits, depth_filter.cpp:242-328), and the motion
        prior is the last FINALIZED relative motion (one frame stale).
        Tracking failures discard the one speculative dispatch and reprocess
        the frame through the synchronous relocalization path.

        Returns the previous frame's result (None while the pipeline fills);
        call :meth:`flush` after the last frame.  Requires
        ``photometric_calib=False`` (its per-frame sampling is synchronous).
        """
        assert self.photo is None, \
            "add_image_pipelined requires photometric_calib=False"
        if self.stage != STAGE_DEFAULT:
            if self._pending is not None:
                pf, pout, _pimg, pts_ = self._pending
                self._pending = None
                self._due.append(self._finalize_pipelined(pf, pout, pts_))
                self._seeds_spec = None
                self._motion_T_prev = None
            self._due.append(self.add_image(img_u8, ts))
            return self._due.popleft() if self._due else None

        if self.monitor is not None:
            self.monitor.new_frame()
        t_start = time.perf_counter()
        if self._last_T_host is None:
            self._last_T_host = self.last_frame.T_f_w.copy()
        frame = Frame(
            frame_id=self.frame_count, timestamp=ts,
            T_f_w=se3np.identity(), data=None,
            obs=empty_obs(self._n_obs_pad),
        )
        seeds_in = self._seeds_spec if self._seeds_spec is not None else self.seeds
        # motion prior: the last FINALIZED relative motion (one frame stale —
        # smooth motion makes it an excellent prior; composing raw device
        # poses instead couples tracking noise frame-to-frame and was
        # measured to feed back geometrically)
        I_rel = jnp.asarray(self.motion_model, jnp.float32)
        acc_before = self._acc
        out = self._dispatch_default(frame, img_u8, seeds_in, I_rel)
        # start the device→host copy NOW — jax only transfers on demand, so
        # without this the round-trip latency lands inside next call's
        # finalize instead of overlapping this frame's compute
        try:
            out["packed"].copy_to_host_async()
        except AttributeError:  # pragma: no cover - non-jax array backend
            pass

        if self._pending is not None:
            pf, pout, pimg, pts_ = self._pending
            self._pending = None
            res_prev = self._finalize_pipelined(pf, pout, pts_)
            self._due.append(res_prev)
            if self.stage != STAGE_DEFAULT:
                # the speculative dispatch chained off a failed frame —
                # discard it and reprocess this image synchronously (reloc)
                self._acc = acc_before
                self._seeds_spec = None
                self._motion_T_prev = None
                self._due.append(self.add_image(img_u8, ts))
                return self._due.popleft()

        self._pending = (frame, out, img_u8, ts)
        self._seeds_spec = out["seeds"]
        self.last_frame = frame
        self.frame_count += 1
        if self.monitor is not None:
            self.monitor.set_timer("tot_time", time.perf_counter() - t_start)
            self.monitor.update_finished()
        return self._due.popleft() if self._due else None

    def flush(self) -> list[FrameResult]:
        """Drain the pipelined loop: finalize the pending frame (if any) and
        return it together with any queued results, oldest first."""
        if self._pending is not None:
            pf, pout, _pimg, pts_ = self._pending
            self._pending = None
            self._due.append(self._finalize_pipelined(pf, pout, pts_))
            self._seeds_spec = None
            self._motion_T_prev = None
        out = list(self._due)
        self._due.clear()
        return out

    def _finalize_pipelined(self, frame: Frame, out, ts: float) -> FrameResult:
        res = self._finalize_default(frame, out, self._last_T_host,
                                     pipelined=True)
        self.trajectory.append((ts, frame.T_f_w.copy()))
        return res

    def _process_first(self, frame: Frame) -> FrameResult:
        det = self._detect(frame, None, n_levels=1, cell0=16)
        n = int(np.asarray(det["valid"]).sum())
        if n < 100:
            return FrameResult(RESULT_NO_KEYFRAME, frame.T_f_w)
        frame.exposure = 1.0
        self.first_frame = frame
        self._init_px = np.asarray(det["px"])[np.asarray(det["valid"])]
        self._init_px_prior = self._init_px.copy()
        self.stage = STAGE_SECOND
        return FrameResult(RESULT_KEYFRAME, frame.T_f_w)

    def _process_second(self, frame: Frame) -> FrameResult:
        cfg = self.cfg
        px_ref = self._init_px
        n = len(px_ref)
        tr = track_klt(
            self.first_frame.data["pyr"], frame.data["pyr"],
            jnp.asarray(px_ref, jnp.float32), jnp.ones(n, bool),
            px_prior=jnp.asarray(self._init_px_prior, jnp.float32),
        )
        ok = np.asarray(tr["ok"])
        px_cur = np.asarray(tr["px_cur"])
        # incremental prior for the next attempt (reference keeps px_cur_
        # across bootstrap frames, initialization.cpp:60-75)
        self._init_px_prior = np.where(ok[:, None], px_cur, self._init_px_prior)
        if ok.sum() < cfg.init_min_tracked:
            self._restart()
            return FrameResult(RESULT_FAILURE, frame.T_f_w)
        disp = np.linalg.norm(px_cur[ok] - px_ref[ok], axis=-1)
        if np.median(disp) < cfg.init_min_disparity:
            return FrameResult(RESULT_NO_KEYFRAME, frame.T_f_w)

        f1 = self.cam.cam2world(px_ref[ok])
        f2 = self.cam.cam2world(px_cur[ok])
        rec = recover_pose_twoview(f1, f2, self.cam.focal_mean)
        if rec is None or rec["n_inliers"] < cfg.init_min_inliers:
            self._restart()
            return FrameResult(RESULT_FAILURE, frame.T_f_w)

        inl = rec["inliers"]
        T_21 = rec["T_21"]
        p1, z1 = triangulate_midpoint(T_21, f1[inl], f2[inl])
        good = z1 > 1e-6
        depth_med = np.median(np.asarray(se3np.apply(T_21, p1[good]))[:, 2])
        scale = cfg.map_scale / max(depth_med, 1e-9)
        T_21s = T_21.copy()
        T_21s[..., :3, 3] *= scale
        p1 = p1 * scale

        # register keyframes
        self.first_frame.T_f_w = se3np.identity()
        self.first_frame.exposure = 1.0
        kf0 = self.kfs.add(self.first_frame)
        frame.T_f_w = T_21s
        frame.exposure = 1.0
        kf1 = self.kfs.add(frame)

        # create points hosted in KF0 (level-0 bootstrap features)
        px_ok = px_ref[ok][inl][good]
        px_cur_ok = px_cur[ok][inl][good]
        f1g = f1[inl][good]
        f2g = f2[inl][good]
        dist1 = np.linalg.norm(p1[good], axis=-1)
        idx = self.points.alloc(len(px_ok))
        m = len(idx)
        self.points.valid[idx] = True
        self.points.type[idx] = TYPE_UNKNOWN
        self.points.host_kf[idx] = kf0
        self.points.host_px[idx] = px_ok[:m]
        self.points.host_f[idx] = f1g[:m]
        self.points.host_level[idx] = 0
        self.points.species[idx] = 0
        self.points.idist[idx] = 1.0 / np.maximum(dist1[:m], 1e-9)
        # memoize host windows
        from hso_tpu.ops.gatherless import clip_anchor, extract_windows

        img0 = self.first_frame.data["pyr"][0]
        au, av = clip_anchor(
            jnp.asarray(px_ok[:m, 0]), jnp.asarray(px_ok[:m, 1]), 24, 0,
            *img0.shape,
        )
        wins = extract_windows(img0, au, av, 24)
        self.points.host_win[idx] = np.asarray(wins)
        self.points.host_anchor[idx] = np.stack(
            [np.asarray(au), np.asarray(av)], axis=-1
        )
        self.points.init_patch_from_host(idx)
        self._mark_dirty(idx)

        # observations in both keyframes
        for kf_frame, px_obs, f_obs in (
            (self.first_frame, px_ok[:m], f1g[:m]),
            (frame, px_cur_ok[:m], f2g[:m]),
        ):
            o = kf_frame.obs
            o["valid"][:m] = True
            o["px"][:m] = px_obs
            o["f"][:m] = f_obs
            o["level"][:m] = 0
            o["species"][:m] = 0
            o["point_id"][:m] = idx
        self.points.last_obs_kf[idx] = kf1
        for kf_frame in (self.first_frame, frame):
            self.points.register_obs(kf_frame)

        # seed the depth filter from the second keyframe; the first keyframe
        # serves as a pre-frame so new seeds get an immediate wide-baseline
        # backfill observation
        self.pre_frames.append(self.first_frame)
        self._add_keyframe_seeds(frame, depth_mean=cfg.map_scale,
                                 depth_min=float(dist1.min() * 0.5),
                                 converge_thresh=cfg.seed_converge_sigma2_thresh)
        self.stage = STAGE_DEFAULT
        self.n_last_inliers = m
        self.regular_counter = 0
        self.after_init = True
        self._bump_map_version()
        return FrameResult(RESULT_KEYFRAME, frame.T_f_w, n_matches=m, n_inliers=m)

    # ------------------------------------------------------------------ default
    def _process_default(self, frame: Frame, img=None) -> FrameResult:
        """The default per-frame path: ONE fused device dispatch (pyramid,
        coarse track, grid select + two-pass matching, pose LM, depth-filter
        sweep — hso_tpu/pipeline/fused_step.py) followed by host-only
        bookkeeping.  The reference's analogue is one tracking-thread pass,
        frame_handler_mono.cpp:173-355.

        Host↔device traffic per steady-state frame is ONE sync (the 24-float
        ``packed`` scalar vector) plus the async image upload: per-slot match
        results are fetched lazily at keyframe/sparse events
        (``_writeback_obs``) and point success/fail counters accumulate on
        device until a keyframe drains them (``_apply_lifecycle``).

        Split into :meth:`_dispatch_default` (device dispatch, no sync) and
        :meth:`_finalize_default` (packed fetch + host bookkeeping) so the
        pipelined host loop (:meth:`add_image_pipelined`) can overlap frame
        k+1's dispatch with frame k's result latency."""
        out = self._dispatch_default(
            frame, img, self.seeds, jnp.asarray(self.motion_model, jnp.float32))
        return self._finalize_default(frame, out, self.last_frame.T_f_w)

    def _dispatch_default(self, frame: Frame, img, seeds_in, I_rel):
        """Dispatch the fused per-frame step (async — nothing on the host
        blocks) and attach the device-side handles to ``frame``."""
        last = self.last_frame
        if img is None:
            img = frame.data["pyr"][0]      # reloc path: pre-built frame

        with self._t("host_prep"):
            step = self._fused_step()
            snap = self._snapshot()
            prev_obs = self._prev_obs_dev(last)
            T_prev = getattr(last, "T_dev", None)
            if T_prev is None:
                T_prev = jnp.asarray(last.T_f_w, jnp.float32)
            prev_gm = getattr(last, "grad_mean_dev", None)
            if prev_gm is None:
                prev_gm = jnp.float32(last.grad_mean)
            prev_it = getattr(last, "intensity_dev", None)
            if prev_it is None:
                prev_it = jnp.float32(last.intensity_mean)
            exp_prev = getattr(last, "exp_dev", None)
            if exp_prev is None:
                exp_prev = jnp.float32(last.exposure)
            if self._px_err_dev is None:
                self._px_err_dev = jnp.float32(self.px_error_angle)
            if self._acc is None:
                self._acc = jnp.zeros((2, self.points.p_max), jnp.int32)

        with self._t("fused_dispatch"):
            out = step(
                jnp.asarray(img), last.data["pyr"], prev_gm, T_prev,
                prev_obs, prev_it, exp_prev, I_rel, snap,
                seeds_in, self._px_err_dev, self._acc,
            )

        self._acc = out["acc"]
        frame.data = out["data"]
        frame.grad_mean_dev = out["data"]["grad_mean"]
        frame.intensity_dev = out["data"]["intensity_mean"]
        frame.T_dev = out["T_new"]
        frame.obs_dev = out["obs_next"]
        frame.exp_dev = out["exposure"]
        return out

    def _finalize_default(self, frame: Frame, out, prev_T_host,
                          pipelined: bool = False) -> FrameResult:
        """Consume the fused step's results: the one packed sync, quality
        gates, sparse-frame rescues, the keyframe event, and the trailing
        host bookkeeping."""
        cfg = self.cfg
        with self._t("sync_packed"):
            packed = np.asarray(out["packed"], np.float64)  # the ONE sync

        frame.T_f_w = se3np.normalize(packed[:12].reshape(3, 4))
        frame.exposure = float(packed[12])
        frame.grad_mean = float(packed[22])
        frame.intensity_mean = float(packed[23])

        n_matches = int(packed[13])
        n_inliers = int(packed[14])
        err_px = float(packed[15])

        synced = False
        if n_matches < 100 or self.photo is not None:
            with self._t("writeback"):
                self._writeback_obs(frame, out)
            synced = True

        if n_matches < 100:
            # sparse frame: also match unconverged depth-filter seeds,
            # creating TEMPORARY points (Reprojector::reprojectorSeeds,
            # reprojector.cpp:309-328,431-502), then refine the pose over the
            # combined observation set (extra dispatches on sparse frames
            # only; the in-step seed sweep used the pre-refinement pose).
            # The seed rescue runs BEFORE the quality gate — it exists
            # precisely to rescue feature-starved frames.
            with self._t("seed_rescue"):
                n_temp = self._reproject_seeds(frame, n_matches)
                if n_temp:
                    n_matches += n_temp
                    n_inliers, err_px = self._pose_refine_host(frame)
                    frame.T_dev = None
                    frame.obs_dev = None

        if n_matches < cfg.quality_min_fts or n_inliers < cfg.quality_min_fts:
            frame.T_f_w = np.asarray(prev_T_host).copy()
            self._last_T_host = frame.T_f_w
            self.stage = STAGE_RELOC
            return FrameResult(RESULT_FAILURE, frame.T_f_w, n_matches, n_inliers)
        self.tracking_bad = (
            min(self.n_last_inliers, cfg.max_fts) - n_inliers
            > cfg.quality_max_drop_fts
        )
        self.n_last_inliers = n_inliers

        depth_mean = float(packed[16]) if np.isfinite(packed[16]) else 1.0
        depth_min = float(packed[17]) if np.isfinite(packed[17]) else 0.1
        distance_mean = float(packed[18]) if np.isfinite(packed[18]) else 1.0

        # seed sweep results (accepted only on non-failure paths, like the
        # reference mapping queue that never sees failed frames)
        self.seeds = out["seeds"]
        n_upd = int(packed[19])

        # ---- keyframe decision ----  (the frame right after bootstrap is
        # forced to be a keyframe: afterInit_, frame_handler_mono.cpp:275-294)
        is_kf = self.after_init or self._need_new_kf(frame, distance_mean)
        self.after_init = False
        result = RESULT_FRAME
        if is_kf:
            result = RESULT_KEYFRAME
            self.regular_counter = 0
            with self._t("kf_event"):
                # sparse frames get a laxer convergence bar (ref: 100 vs 200)
                base_th = cfg.seed_converge_sigma2_thresh
                thresh = base_th / 2.0 if n_inliers <= 70 else base_th
                if pipelined and self._seeds_spec is not None:
                    # a newer frame's sweep output is already in flight —
                    # graft the keyframe's harvest + new seed batch onto THAT
                    # branch so the next dispatch sees both (the reference's
                    # asynchronous mapping thread has the same ordering)
                    self.seeds = self._seeds_spec
                # dispatch ALL keyframe device work before any host fetch
                with self._t("feature_detection"):
                    kf_dev = self._kf_map_dispatch(
                        frame, out, distance_mean,
                        0.5 * max(depth_min, 1e-3), thresh)
                self._kf_sync(frame, out, already_synced=synced)
                kf_idx = self.kfs.add(frame)
                # CANDIDATE points observed here become UNKNOWN (addCandidatePointToFrame)
                o = frame.obs
                seen = o["point_id"][o["valid"]]
                cand = seen[self.points.type[seen] == TYPE_CANDIDATE]
                self.points.type[cand] = TYPE_UNKNOWN
                # observed points re-memoize their appearance from this view
                # (getCloseViewObs analogue: recency ≈ closest viewing angle)
                self._refresh_patch_sources(
                    frame, buf=kf_dev["refresh_buf"],
                    slot_rows=getattr(frame, "_slot_rows", None))
                self.points.register_obs(frame)
                # release points that left the field of view (bounded slot
                # usage on long sequences; see PointTable.gc_stale)
                self.points.gc_stale(kf_idx)
                with self._t("local_ba"):
                    self._run_ba(frame)
                with self._t("feature_detection"):
                    self._kf_map_finish(kf_dev)
                self._bump_map_version()
        else:
            self.regular_counter += 1

        if pipelined and is_kf:
            self._seeds_spec = self.seeds
        self.motion_model = se3np.mul(
            frame.T_f_w, se3np.inv(np.asarray(prev_T_host, np.float64)))
        self._last_T_host = frame.T_f_w
        self.pre_frames.append(frame)
        return FrameResult(result, frame.T_f_w, n_matches, n_inliers, n_upd,
                           err_px)

    def _kf_sync(self, frame: Frame, out, already_synced: bool) -> None:
        """Keyframe-event device sync: ONE transfer of the fused step's
        ``kf_pack`` buffer covers the per-slot match results, the lifecycle
        accumulators and the seed match statistics."""
        C = self._grid[1] * self._grid[2]
        P = self.points.p_max
        S = int(self.seeds["valid"].shape[0])
        kp = np.asarray(out["kf_pack"])
        sp = kp[: C * 11].reshape(C, 11)
        acc = kp[C * 11: C * 11 + 2 * P].reshape(2, P).astype(np.int64)
        off = C * 11 + 2 * P
        self._last_seed_match_px = kp[off: off + 2 * S].reshape(S, 2)
        self._last_seed_matched = kp[off + 2 * S: off + 3 * S] > 0.5
        if not already_synced:
            self._writeback_obs(frame, out, sp=sp)
        self._apply_lifecycle(frame, acc=acc)

    def _writeback_obs(self, frame: Frame, out, sp=None) -> None:
        """Fetch the fused step's packed per-slot results (ONE transfer) and
        fill the frame's host observation table with the kept matches."""
        if sp is None:
            sp = np.asarray(out["slot_pack"])
        flags = sp[:, 10].astype(np.int32)
        keep = (flags & 3) == 3          # success & inlier
        w = np.where(keep)[0]
        frame._slot_rows = w             # obs row i ↔ fused-step slot w[i]
        o = frame.obs
        rows = slice(0, len(w))
        o["valid"][rows] = True
        o["px"][rows] = sp[w, 0:2]
        o["f"][rows] = sp[w, 2:5]
        o["level"][rows] = sp[w, 7].astype(np.int32)
        o["species"][rows] = sp[w, 8].astype(np.int32)
        o["grad"][rows] = sp[w, 5:7]
        o["point_id"][rows] = sp[w, 9].astype(np.int32)

    def _apply_lifecycle(self, frame: Frame | None = None, acc=None) -> None:
        """Drain the device success/fail accumulators into the host point
        table and apply the lifecycle rules (reprojector.cpp:373-387:
        TEMPORARY dies after >3 failures, UNKNOWN after >15; UNKNOWN with
        >10 successes becomes GOOD).  Deferred to keyframe events so the
        per-frame host loop never syncs the counters — the same lag the
        reference's asynchronous mapping thread exhibits."""
        if self._acc is None:
            return
        if acc is None:
            acc = np.asarray(self._acc)
        pts = self.points
        if acc.any():
            pts.n_succ += acc[0]
            pts.n_fail += acc[1]
            touched = acc[1] > 0
            kill = np.nonzero(touched & pts.valid & (
                ((pts.type == TYPE_TEMPORARY) & (pts.n_fail > 3))
                | ((pts.type == TYPE_UNKNOWN) & (pts.n_fail > 15))))[0]
            pts.release(kill)
            promote = np.nonzero((acc[0] > 0) & pts.valid
                                 & (pts.type == TYPE_UNKNOWN)
                                 & (pts.n_succ > 10))[0]
            pts.type[promote] = TYPE_GOOD
            self._acc = jnp.zeros((2, pts.p_max), jnp.int32)
            # scrub obs rows of the current frame that reference points the
            # drain just released (its rows are not yet in the inverted
            # index, so release() could not invalidate them)
            if frame is not None and frame.obs is not None:
                o = frame.obs
                pid = np.where(o["point_id"] >= 0, o["point_id"], 0)
                bad = o["valid"] & ~pts.valid[pid]
                o["valid"][bad] = False
                o["point_id"][bad] = -1

    def _fused_step(self):
        from hso_tpu.pipeline.fused_step import make_frame_step

        cfg = self.cfg
        return make_frame_step(
            self.cam, self._grid, cfg.klt_max_level, cfg.klt_min_level,
            cfg.coarse_n_iter, cfg.coarse_pattern_offset,
            cfg.poseoptim_thresh, n_obs_pad=self._n_obs_pad,
            edgelet_cos_angle=cfg.edgelet_angle,
            align_max_iter=cfg.align_max_iter,
            patch_closest=(cfg.patch_source == "closest"))

    def _bump_map_version(self) -> None:
        self._map_version += 1

    def _mark_dirty(self, rows) -> None:
        """Record point rows whose patch/species data changed (scattered into
        the device snapshot mirror at the next _snapshot)."""
        self._dirty_rows.update(np.atleast_1d(np.asarray(rows, np.int64)).tolist())

    def _pt_pack_rows(self, idx, host: bool = False) -> np.ndarray:
        """Packed per-point patch-source rows for the device mirror (layout:
        fused_step.PT_COLS — flattened window then px/f/anchor/level/grad/
        species/kf)."""
        pts = self.points
        if host:
            win, px, f = pts.host_win, pts.host_px, pts.host_f
            anc, lvl, grad, kf = (pts.host_anchor, pts.host_level, pts.grad,
                                  pts.host_kf)
        else:
            win, px, f = pts.patch_win, pts.patch_px, pts.patch_f
            anc, lvl, grad, kf = (pts.patch_anchor, pts.patch_level,
                                  pts.patch_grad, pts.patch_kf)
        return np.concatenate([
            win[idx].reshape(len(idx), -1), px[idx], f[idx],
            anc[idx], lvl[idx, None], grad[idx],
            pts.species[idx, None], kf[idx, None],
        ], axis=1).astype(np.float32)

    def _snapshot(self) -> dict:
        """Device-side map snapshot for the fused step: heavy members are
        refreshed only when the map changed (keyframe events bump
        ``_map_version``) — and then INCREMENTALLY: small members (positions,
        keyframe poses) re-upload whole, while the packed per-point table
        (``pt_pack``, ~9 MB) is patched with a fixed-width row scatter over
        the rows marked dirty since the last refresh (a keyframe touches a
        few hundred rows)."""
        from hso_tpu.pipeline.fused_step import pack_light, scatter_rows

        pts = self.points
        closest = self.cfg.patch_source == "closest"
        all_rows = np.arange(pts.p_max)
        if self._snap_heavy is not None and self._snap_heavy_version != self._map_version:
            heavy = dict(self._snap_heavy)
            heavy["pos_w"] = jnp.asarray(
                pts.positions(self.kfs.poses).astype(np.float32))
            heavy["kf_poses"] = jnp.asarray(self.kfs.poses.astype(np.float32))
            heavy["kf_exposure"] = jnp.asarray(self.kfs.exposure)
            heavy["ring_T"] = jnp.asarray(self._ring_poses())
            heavy["ring_exp"] = jnp.asarray(np.array(
                [self.kfs.exposure[i] if i >= 0 else 1.0
                 for i in self.seed_ring], np.float32))
            rows = np.fromiter(self._dirty_rows, np.int64,
                               len(self._dirty_rows))
            rows.sort()
            width = self._n_obs_pad
            for lo in range(0, len(rows), width):
                sel = rows[lo:lo + width]
                idx_pad = np.full(width, sel[0], np.int32)
                idx_pad[: len(sel)] = sel
                idx_dev = jnp.asarray(idx_pad)
                heavy["pt_pack"] = scatter_rows(
                    heavy["pt_pack"], idx_dev,
                    jnp.asarray(self._pt_pack_rows(idx_pad)))
                heavy["species"] = scatter_rows(
                    heavy["species"], idx_dev,
                    jnp.asarray(pts.species[idx_pad]))
                if closest:
                    heavy["host_pack"] = scatter_rows(
                        heavy["host_pack"], idx_dev,
                        jnp.asarray(self._pt_pack_rows(idx_pad, host=True)))
            self._dirty_rows.clear()
            self._snap_heavy = heavy
            self._snap_heavy_version = self._map_version
        elif self._snap_heavy is None:
            self._snap_heavy = {
                "pos_w": jnp.asarray(
                    pts.positions(self.kfs.poses).astype(np.float32)),
                "kf_poses": jnp.asarray(self.kfs.poses.astype(np.float32)),
                "kf_exposure": jnp.asarray(self.kfs.exposure),
                "ring_T": jnp.asarray(self._ring_poses()),
                "ring_exp": jnp.asarray(np.array(
                    [self.kfs.exposure[i] if i >= 0 else 1.0
                     for i in self.seed_ring], np.float32)),
                "pt_pack": jnp.asarray(self._pt_pack_rows(all_rows)),
                "species": jnp.asarray(pts.species),
            }
            if closest:
                self._snap_heavy["host_pack"] = jnp.asarray(
                    self._pt_pack_rows(all_rows, host=True))
            self._dirty_rows.clear()
            self._snap_heavy_version = self._map_version
        if self._snap_light is None or self._snap_light_version != self._map_version:
            self._snap_light = jnp.asarray(pack_light(pts.type, pts.valid))
            self._snap_light_version = self._map_version
        snap = dict(self._snap_heavy)
        snap["light"] = self._snap_light
        return snap

    def _prev_obs_dev(self, last: Frame) -> dict:
        od = getattr(last, "obs_dev", None)
        if od is not None:
            return od
        o = last.obs
        ov = o["valid"] & (o["point_id"] >= 0)
        return {
            "px": jnp.asarray(o["px"], jnp.float32),
            "f": jnp.asarray(o["f"], jnp.float32),
            "pid": jnp.asarray(np.where(ov, o["point_id"], 0)),
            "valid": jnp.asarray(ov),
        }

    def _pose_refine_host(self, frame: Frame) -> tuple[int, float]:
        """Motion-only pose LM over the frame's full observation table (used
        after TEMPORARY-seed top-up changed the observation set)."""
        cfg = self.cfg
        o = frame.obs
        ov = o["valid"] & (o["point_id"] >= 0)
        pid = np.where(ov, o["point_id"], 0)
        p_world = self.points.positions(self.kfs.poses)[pid].astype(np.float32)
        pout = optimize_pose(
            jnp.asarray(frame.T_f_w, jnp.float32),
            jnp.asarray(p_world),
            jnp.asarray(o["f"], jnp.float32),
            jnp.asarray(o["level"]),
            jnp.asarray(o["grad"], jnp.float32),
            jnp.asarray(o["species"] == 1),
            jnp.asarray(self.points.type[pid] == TYPE_TEMPORARY),
            jnp.asarray(ov),
            focal=float(self.cam.focal_mean),
            reproj_thresh=cfg.poseoptim_thresh,
        )
        frame.T_f_w = se3np.normalize(np.asarray(pout["T_f_w"], np.float64))
        inlier = np.asarray(pout["inlier"])
        o["point_id"] = np.where(ov & ~inlier, -1, o["point_id"])
        o["valid"] &= o["point_id"] >= 0
        return int(inlier.sum()), float(pout["err_final_px"])

    # ------------------------------------------------------------------ blocks
    def _match_point_batch(self, frame: Frame, cand_idx: np.ndarray,
                           pos_w: np.ndarray) -> dict:
        """Batched direct matching of up to n_fts_max point candidates.

        Warps from each point's memoized patch SOURCE view (latest keyframe
        obs — the getCloseViewObs analogue), anchored by inverse distance in
        that view; host_* stays the BA anchor.  Returns numpy result arrays
        aligned with ``cand_idx``."""
        pts = self.points
        n_max = self.cfg.n_fts_max
        cand_idx = cand_idx[:n_max]
        pad = n_max - len(cand_idx)
        cidx = np.pad(cand_idx, (0, pad))
        pkf = pts.patch_kf[cidx]
        T_p = self.kfs.poses[pkf]
        p_in_patch = se3np.apply(T_p, pos_w[cidx].astype(np.float64))
        idist_p = (
            1.0 / np.maximum(np.linalg.norm(p_in_patch, axis=-1), 1e-9)
        ).astype(np.float32)
        cand = {
            "host_win": jnp.asarray(pts.patch_win[cidx]),
            "host_anchor": jnp.asarray(pts.patch_anchor[cidx]),
            "host_px": jnp.asarray(pts.patch_px[cidx]),
            "host_f": jnp.asarray(pts.patch_f[cidx]),
            "host_level": jnp.asarray(pts.patch_level[cidx]),
            "grad": jnp.asarray(pts.patch_grad[cidx]),
            "species": jnp.asarray(pts.species[cidx]),
            "idist": jnp.asarray(idist_p),
            "T_host_w": jnp.asarray(T_p, jnp.float32),
            "exposure_host": jnp.asarray(self.kfs.exposure[pkf]),
            "valid": jnp.asarray(np.arange(n_max) < len(cand_idx)),
        }
        d = frame.data
        mout = match_points(
            cand, d["pyr"], d["sobel_x"], d["sobel_y"],
            jnp.asarray(frame.T_f_w, jnp.float32), frame.exposure, self.cam,
            edgelet_cos_angle=self.cfg.edgelet_angle,
            align_max_iter=self.cfg.align_max_iter,
        )
        live = np.arange(n_max) < len(cand_idx)
        return {
            "cidx": cidx, "live": live,
            "success": np.asarray(mout["success"]) & live,
            "px": np.asarray(mout["px"]),
            "level": np.asarray(mout["level"]),
            "f_cur": np.asarray(mout["f_cur"]),
            "grad_cur": np.asarray(mout["grad_cur"]),
        }

    def _reproject(self, frame: Frame) -> int:
        cell, gh, gw = self._grid
        pos_w = self.points.positions(self.kfs.poses).astype(np.float32)
        priority = self.points.type.astype(np.int32)
        sel = select_candidates(
            jnp.asarray(pos_w), jnp.asarray(self.points.valid),
            jnp.asarray(priority), jnp.asarray(frame.T_f_w, jnp.float32),
            self.cam, cell=cell, grid_h=gh, grid_w=gw,
        )
        cell_valid = np.asarray(sel["cell_valid"])
        cand_idx = np.asarray(sel["cell_point"])[cell_valid]
        if len(cand_idx) == 0:
            return 0
        batches = [self._match_point_batch(frame, cand_idx, pos_w)]

        # pass 2 (budget scheduling, reprojector.cpp:257-330): cells whose
        # best candidate failed retry with their runner-up
        first_fail = ~batches[0]["success"][: len(cand_idx)]
        fail_cells = np.where(cell_valid)[0][first_fail[: len(cand_idx)]]
        cv2 = np.asarray(sel["cell_valid2"])
        retry_cells = fail_cells[cv2[fail_cells]]
        budget_left = self.cfg.max_fts - int(batches[0]["success"].sum())
        if len(retry_cells) and budget_left > 0:
            cand2 = np.asarray(sel["cell_point2"])[retry_cells][:budget_left]
            batches.append(self._match_point_batch(frame, cand2, pos_w))

        pts = self.points
        o = frame.obs
        n_filled = 0
        for b in batches:
            success, live, cidx = b["success"], b["live"], b["cidx"]
            good_ids = cidx[success]
            fail_ids = cidx[~success & live]
            pts.n_succ[good_ids] += 1
            pts.n_fail[fail_ids] += 1
            # deletions per reprojector.cpp:373-387 rules
            kill = fail_ids[
                (pts.type[fail_ids] == TYPE_TEMPORARY) & (pts.n_fail[fail_ids] > 3)
            ]
            self.points.release(kill)
            kill2 = fail_ids[
                (pts.type[fail_ids] == TYPE_UNKNOWN) & (pts.n_fail[fail_ids] > 15)
            ]
            self.points.release(kill2)
            promote = good_ids[
                (pts.type[good_ids] == TYPE_UNKNOWN) & (pts.n_succ[good_ids] > 10)
            ]
            pts.type[promote] = TYPE_GOOD

            w = np.where(success)[0]
            n_m = len(w)
            if n_m == 0:
                continue
            rows = slice(n_filled, n_filled + n_m)
            o["valid"][rows] = True
            o["px"][rows] = b["px"][w]
            o["f"][rows] = b["f_cur"][w]
            o["level"][rows] = b["level"][w]
            o["species"][rows] = pts.species[cidx[w]]
            o["grad"][rows] = b["grad_cur"][w]
            o["point_id"][rows] = cidx[w]
            n_filled += n_m
        return n_filled

    def _reproject_seeds(self, frame: Frame, n_have: int) -> int:
        """Match unconverged seeds into the frame; successful matches spawn
        TEMPORARY map points (half-weighted in pose optimization)."""
        sd = {k: np.asarray(v) for k, v in self.seeds.items()
              if k in ("valid", "host", "px", "f", "level", "species", "grad",
                       "mu", "host_win", "host_anchor", "temp_point")}
        alive = sd["valid"] & (sd["temp_point"] < 0) & (sd["mu"] > 1e-10)
        if alive.sum() == 0:
            return 0
        host_kf = self.seed_ring[sd["host"]]
        T_h = self.kfs.poses[host_kf]
        # parallax gate (findMatchSeed, matcher.cpp:442-449): cos angle > 0.5
        p_w = se3np.apply(se3np.inv(T_h), (sd["f"] / np.maximum(sd["mu"], 1e-10)[:, None]).astype(np.float64))
        host_pos = se3np.translation(se3np.inv(T_h))
        cur_pos = se3np.translation(se3np.inv(frame.T_f_w))
        d_ref = host_pos - p_w
        d_cur = cur_pos - p_w
        cosang = np.sum(d_ref * d_cur, -1) / np.maximum(
            np.linalg.norm(d_ref, axis=-1) * np.linalg.norm(d_cur, axis=-1), 1e-9
        )
        alive &= cosang > 0.5
        idxs = np.where(alive)[0]
        if len(idxs) == 0:
            return 0
        n_max = self.cfg.n_fts_max
        idxs = idxs[: n_max]
        cidx = np.pad(idxs, (0, n_max - len(idxs)))
        cand = {
            "host_win": jnp.asarray(sd["host_win"][cidx]),
            "host_anchor": jnp.asarray(sd["host_anchor"][cidx]),
            "host_px": jnp.asarray(sd["px"][cidx]),
            "host_f": jnp.asarray(sd["f"][cidx]),
            "host_level": jnp.asarray(sd["level"][cidx]),
            "grad": jnp.asarray(sd["grad"][cidx]),
            "species": jnp.asarray(sd["species"][cidx]),
            "idist": jnp.asarray(sd["mu"][cidx]),
            "T_host_w": jnp.asarray(T_h[cidx], jnp.float32),
            "exposure_host": jnp.asarray(self.kfs.exposure[host_kf[cidx]]),
            "valid": jnp.asarray(np.arange(n_max) < len(idxs)),
        }
        d = frame.data
        mout = match_points(
            cand, d["pyr"], d["sobel_x"], d["sobel_y"],
            jnp.asarray(frame.T_f_w, jnp.float32), frame.exposure, self.cam,
            edgelet_cos_angle=self.cfg.edgelet_angle,
            align_max_iter=self.cfg.align_max_iter,
        )
        success = np.asarray(mout["success"]) & (np.arange(n_max) < len(idxs))
        wsel = np.where(success)[0]
        # budget to the frame feature target, not the slot capacity
        # (reprojector.cpp:309-328 tops up to maxFts)
        budget = max(0, min(len(wsel), self.cfg.max_fts - n_have))
        wsel = wsel[:budget]
        if len(wsel) == 0:
            return 0
        pidx = self.points.alloc(len(wsel))
        m = len(pidx)
        wsel = wsel[:m]
        s_ids = cidx[wsel]
        pts = self.points
        pts.valid[pidx] = True
        pts.type[pidx] = TYPE_TEMPORARY
        pts.host_kf[pidx] = host_kf[s_ids]
        pts.host_px[pidx] = sd["px"][s_ids]
        pts.host_f[pidx] = sd["f"][s_ids]
        pts.host_level[pidx] = sd["level"][s_ids]
        pts.species[pidx] = sd["species"][s_ids]
        pts.grad[pidx] = sd["grad"][s_ids]
        pts.idist[pidx] = sd["mu"][s_ids]
        win_c, anch_c = crop_window(
            sd["host_win"][s_ids], sd["host_anchor"][s_ids],
            sd["px"][s_ids], sd["level"][s_ids],
        )
        pts.host_win[pidx] = win_c
        pts.host_anchor[pidx] = anch_c
        pts.last_obs_kf[pidx] = len(self.kfs.frames) - 1
        pts.init_patch_from_host(pidx)
        self._mark_dirty(pidx)
        # link seed → temp point
        self.seeds["temp_point"] = (
            self.seeds["temp_point"].at[jnp.asarray(s_ids)].set(jnp.asarray(pidx))
        )
        # observations
        o = frame.obs
        free = np.where(~o["valid"])[0][: m]
        px = np.asarray(mout["px"])[wsel]
        o["valid"][free] = True
        o["px"][free] = px
        o["f"][free] = np.asarray(mout["f_cur"])[wsel]
        o["level"][free] = np.asarray(mout["level"])[wsel]
        o["species"][free] = sd["species"][s_ids]
        o["grad"][free] = np.asarray(mout["grad_cur"])[wsel]
        o["point_id"][free] = pidx
        self._bump_map_version()          # new TEMPORARY landmarks
        return len(free)

    def _refresh_patch_sources(self, frame: Frame, buf=None,
                               slot_rows=None) -> None:
        """Re-memoize the appearance window of every point observed in this
        keyframe from the new view (Point::getCloseViewObs analogue — see
        mapmodel/structures.py).  One batched window extraction.

        ``buf``/``slot_rows``: pre-dispatched per-SLOT window buffer from
        :meth:`_kf_map_dispatch` (its copy has been in flight since before
        the kf_pack fetch) — valid only while the obs table is the pure
        slot write-back (a sparse-frame seed rescue appends rows the slot
        buffer does not cover, so those frames take the synchronous path).
        """
        from hso_tpu.ops.warp import memoize_level_windows_packed

        o = frame.obs
        sel = o["valid"] & (o["point_id"] >= 0)
        if not sel.any():
            return
        if buf is not None and slot_rows is not None \
                and sel.sum() == len(slot_rows):
            buf = np.asarray(buf)
            wins = buf[:, :-2].reshape(-1, 24, 24)[slot_rows]
            anchors = buf[:, -2:].astype(np.int32)[slot_rows]
            # write-back fills obs rows 0..len(w) in ascending slot order, so
            # buf[slot_rows] is already in obs-row order
            idxs = np.where(sel)[0]
            pid = o["point_id"][idxs]
            pts = self.points
            pts.patch_kf[pid] = frame.kf_index
            pts.patch_px[pid] = o["px"][idxs]
            pts.patch_f[pid] = o["f"][idxs]
            pts.patch_level[pid] = o["level"][idxs]
            pts.patch_grad[pid] = o["grad"][idxs]
            pts.patch_win[pid] = wins
            pts.patch_anchor[pid] = anchors
            self._mark_dirty(pid)
            return
        buf = np.asarray(memoize_level_windows_packed(
            frame.data["pyr"], jnp.asarray(o["px"], jnp.float32),
            jnp.asarray(o["level"]),
        ))
        wins = buf[:, :-2].reshape(-1, 24, 24)
        anchors = buf[:, -2:].astype(np.int32)
        idxs = np.where(sel)[0]
        pid = o["point_id"][idxs]
        pts = self.points
        pts.patch_kf[pid] = frame.kf_index
        pts.patch_px[pid] = o["px"][idxs]
        pts.patch_f[pid] = o["f"][idxs]
        pts.patch_level[pid] = o["level"][idxs]
        pts.patch_grad[pid] = o["grad"][idxs]
        pts.patch_win[pid] = wins[idxs]
        pts.patch_anchor[pid] = anchors[idxs]
        self._mark_dirty(pid)

    def _need_new_kf(self, frame: Frame, distance_mean: float) -> bool:
        # min 3 frames between keyframes (frame_handler_mono.cpp:430; the
        # reference's second gate `< min(3, 0.8·nMeanConvergeFrame_)` at :448
        # is inert — min(3, ·) ≤ 3 can never exceed a counter already ≥ 3 —
        # so it is not reproduced here.  The converge statistic's LIVE effect
        # is the seed-activation view threshold, see _harvest_seeds)
        if self.regular_counter < 3:
            return False
        last_kf = self.kfs.last()
        o = last_kf.obs
        ov = o["valid"] & (o["point_id"] >= 0)
        if ov.sum() < 5:
            return True
        pid = o["point_id"][ov]
        pos = self.points.positions(self.kfs.poses)[pid]
        p_ref = se3np.apply(last_kf.T_f_w, pos)
        dist = np.linalg.norm(p_ref, axis=-1)
        f = o["f"][ov].astype(np.float64)
        p_ref_ray = f * dist[:, None]

        T_full = se3np.mul(frame.T_f_w, se3np.inv(last_kf.T_f_w))
        T_nR = se3np.from_Rt(np.eye(3), se3np.translation(T_full))
        uv_full = self.cam.world2cam(se3np.apply(T_full, p_ref_ray))
        uv_nR = self.cam.world2cam(se3np.apply(T_nR, p_ref_ray))
        px_kf = o["px"][ov]
        flow_full = np.mean(np.sum((uv_full - px_kf) ** 2, axis=-1))
        if flow_full < 133.0:
            return False
        flow_full = np.sqrt(flow_full)
        flow_nR = np.sqrt(np.mean(np.sum((uv_nR - px_kf) ** 2, axis=-1)))

        default_res = 752 + 480
        max_shift_t = 0.04 * default_res
        max_shift_rt = 0.02 * default_res
        kf_weight = 0.75
        wh = self.cam.width + self.cam.height
        judgement = (
            kf_weight * max_shift_t * flow_nR / wh
            + kf_weight * max_shift_rt * flow_full / wh
        )
        return judgement > 1.0

    # ---------------------------------------------------------------- mapping
    def _ring_poses(self) -> np.ndarray:
        return np.stack(
            [
                self.kfs.poses[i] if i >= 0 else se3np.identity()
                for i in self.seed_ring
            ]
        ).astype(np.float32)

    def _kf_map_dispatch(self, frame: Frame, out, depth_mean, depth_min,
                         converge_thresh) -> dict:
        """Dispatch phase of the keyframe mapping work: every device kernel
        (patch-source refresh windows, seed harvest, hybrid detection from
        device-side occupancy, the new seed batch, pre-frame backfill) goes
        out asynchronously BEFORE any host fetch, so no early fetch waits
        on work queued behind it.
        Host-side completion runs in :meth:`_kf_map_finish` after the BA,
        by which time the async copies have landed."""
        from hso_tpu.ops.warp import memoize_level_windows_packed

        try:
            out["kf_pack"].copy_to_host_async()
        except AttributeError:  # pragma: no cover
            pass
        # per-slot patch-source windows (consumed by _refresh_patch_sources)
        refresh_buf = memoize_level_windows_packed(
            frame.data["pyr"], out["px"], out["level"])

        # seed harvest (adaptive activation threshold from the
        # convergence-rate statistic — nMeanConvergeFrame_,
        # depth_filter.cpp:772-776)
        seeds_before = self.seeds
        min_act = float(np.clip(0.7 * self.mean_converge_frames, 3.0, 8.0))
        self.seeds, bundle = harvest_and_prune(
            self.seeds, self.batch_counter, jnp.asarray(self._ring_poses()),
            self.cfg.max_seed_kf_batches, min_act, float(self.cam.focal_mean),
        )

        # detection with device-side occupancy (the step's kept matches +
        # matched seeds — setExistingFeatures/setGridOccpuancy analogue)
        px_occ = jnp.concatenate([out["px"], out["seed_match_px"]], axis=0)
        v_occ = jnp.concatenate([out["success"] & out["inlier"],
                                 out["seed_matched"]], axis=0)
        occ = occupancy_grid(px_occ, v_occ, self.cam.height, self.cam.width,
                             self._occ_cell)
        d = frame.data
        det = detect_features(
            d["pyr"][:3], d["sobel_x"], d["sobel_y"], d["grad_mean"], occ,
            n_out=self.cfg.n_fts_max,
            with_gradient=bool(self.cfg.use_gradient_features))
        f_det = self.cam.cam2world(det["px"]).astype(jnp.float32)

        # new seed batch hosted in this keyframe (its index is assigned by
        # the upcoming kfs.add — compute it prospectively)
        kf_idx = len(self.kfs.frames)
        self.batch_counter += 1
        ring_slot = kf_idx % SEED_RING
        self.seed_ring[ring_slot] = kf_idx
        self.seeds = init_seeds(
            self.seeds, det, frame.data["pyr"], f_det,
            ring_slot, self.batch_counter, float(depth_mean),
            float(max(depth_min, 1e-3)), float(converge_thresh),
        )
        # pre-frame backfill needs the new keyframe's pose in the ring —
        # kfs.add has not run yet, so patch the ring buffers directly
        ring_T = self._ring_poses()
        ring_T[ring_slot] = frame.T_f_w.astype(np.float32)
        ring_exp = np.array(
            [self.kfs.exposure[i] if 0 <= i < len(self.kfs.exposure) else 1.0
             for i in self.seed_ring], np.float32)
        ring_exp[ring_slot] = frame.exposure
        self._backfill_new_seeds(frame, ring_T=jnp.asarray(ring_T),
                                 ring_exp=jnp.asarray(ring_exp))
        try:
            bundle.copy_to_host_async()
            refresh_buf.copy_to_host_async()
        except AttributeError:  # pragma: no cover
            pass
        return {"bundle": bundle, "seeds_before": seeds_before,
                "refresh_buf": refresh_buf}

    def _kf_map_finish(self, kf_dev: dict) -> int:
        """Host-side completion of the keyframe seed harvest: fetch the
        (pre-copied) bundle, apply the TEMPORARY lifecycle, promote/activate
        converged seeds into the point table, and gather their appearance
        windows."""
        from hso_tpu.mapping.depth_filter import gather_seed_windows

        seeds_before = kf_dev["seeds_before"]
        b = np.asarray(kf_dev["bundle"])    # ONE device→host transfer
        conv = b[:, 0] > 0.5
        stale = b[:, 1] > 0.5
        temp_ids = b[:, 13].astype(np.int32)

        # stale seeds: their TEMPORARY points die with them (seedStates_ = -1)
        dead_tmp = temp_ids[stale & (temp_ids >= 0)]
        dead_tmp = dead_tmp[self.points.type[dead_tmp] == TYPE_TEMPORARY]
        self.points.release(dead_tmp)

        n_conv = int(conv.sum())
        if n_conv == 0:
            return 0
        # converge-rate statistic (nMeanConvergeFrame_)
        n_upd = b[conv, 14]
        if len(n_upd):
            self.mean_converge_frames = 0.7 * self.mean_converge_frames + 0.3 * float(
                np.mean(np.maximum(n_upd, 1.0))
            )

        # converged seeds with a live TEMPORARY point: promote it in place
        # (seedStates_ = +1 path) instead of creating a duplicate
        w_all = np.where(conv)[0]
        promote = w_all[(temp_ids[w_all] >= 0)]
        promoted = 0
        for s in promote:
            p = int(temp_ids[s])
            if self.points.valid[p] and self.points.type[p] == TYPE_TEMPORARY:
                self.points.type[p] = TYPE_CANDIDATE
                self.points.idist[p] = float(b[s, 12])
                promoted += 1
        w = np.array([s for s in w_all if temp_ids[s] < 0], dtype=int)

        idx = self.points.alloc(len(w))
        m = len(idx)
        if m == 0:
            return promoted
        w = w[:m]
        host_ring = b[w, 2].astype(np.int32)
        self.points.valid[idx] = True
        self.points.type[idx] = TYPE_CANDIDATE
        self.points.host_kf[idx] = self.seed_ring[host_ring]
        self.points.host_px[idx] = b[w, 3:5]
        self.points.host_f[idx] = b[w, 5:8]
        self.points.host_level[idx] = b[w, 8].astype(np.int32)
        self.points.species[idx] = b[w, 9].astype(np.int32)
        self.points.grad[idx] = b[w, 10:12]
        self.points.idist[idx] = b[w, 12]
        # fetch ONLY the converged rows' appearance windows (device-side
        # gather at a fixed padded width — the full seed window ring is
        # ~8 MB and would retrace per count)
        n_gather = 128
        wdim = int(seeds_before["host_win"].shape[1])
        wins_l, anchs_l = [], []
        for lo in range(0, m, n_gather):
            sel = w[lo:lo + n_gather]
            idx_pad = np.zeros(n_gather, np.int32)
            idx_pad[: len(sel)] = sel
            gbuf = np.asarray(gather_seed_windows(
                seeds_before["host_win"], seeds_before["host_anchor"],
                jnp.asarray(idx_pad)))[: len(sel)]
            wins_l.append(gbuf[:, :wdim * wdim].reshape(-1, wdim, wdim))
            anchs_l.append(gbuf[:, wdim * wdim:].astype(np.int32))
        win_c, anch_c = crop_window(
            np.concatenate(wins_l), np.concatenate(anchs_l),
            b[w, 3:5], b[w, 8].astype(np.int32),
        )
        self.points.host_win[idx] = win_c
        self.points.host_anchor[idx] = anch_c
        self.points.last_obs_kf[idx] = len(self.kfs.frames) - 1
        self.points.init_patch_from_host(idx)
        self._mark_dirty(idx)
        self.points.n_succ[idx] = 0
        self.points.n_fail[idx] = 0
        return m + promoted

    def _add_keyframe_seeds(self, frame: Frame, depth_mean, depth_min,
                            converge_thresh) -> None:
        # occupancy: current observations + matched seed positions
        occ_px = frame.obs["px"][frame.obs["valid"]]
        if getattr(self, "_last_seed_matched", None) is not None:
            sm = self._last_seed_match_px[self._last_seed_matched]
            if len(sm):
                occ_px = np.concatenate([occ_px, sm], axis=0)
        det = self._detect(frame, occ_px)
        f_det = self.cam.cam2world(np.asarray(det["px"])).astype(np.float32)

        self.batch_counter += 1
        ring_slot = frame.kf_index % SEED_RING
        self.seed_ring[ring_slot] = frame.kf_index
        self.seeds = init_seeds(
            self.seeds, det, frame.data["pyr"], jnp.asarray(f_det),
            ring_slot, self.batch_counter, float(depth_mean),
            float(max(depth_min, 1e-3)), float(converge_thresh),
        )
        self._backfill_new_seeds(frame)

    def _backfill_new_seeds(self, frame: Frame, ring_T=None,
                            ring_exp=None) -> None:
        """Sweep seeds against retained pre-frames — the mapping thread's
        idle-time backfill (``observeDepthWithPreviousFrameOnce``,
        depth_filter.cpp:677-726), done synchronously at keyframe creation.

        Two seed classes get the sweep: the just-created batch (pre-frames
        predate the host keyframe → immediate parallax), and older seeds
        that have never fused a single measurement (every live seed already
        sweeps every incoming frame once — the reference backfills
        continuously because its mapping thread DROPS frames under load,
        which the synchronous design never does — so a zero-update seed is
        exactly one whose attempts all failed; retrying those frames cannot
        double-fuse, while seeds with successes must be excluded or a
        pre-frame they already fused would be counted twice)."""
        new_mask = (
            (self.seeds["batch_id"] == self.batch_counter)
            | (self.seeds["n_updates"] < 0.5)
        ) & self.seeds["valid"]
        if ring_T is None:
            ring_T = jnp.asarray(self._ring_poses())
        if ring_exp is None:
            ring_exp = jnp.asarray(
                np.array(
                    [self.kfs.exposure[i] if i >= 0 else 1.0
                     for i in self.seed_ring],
                    np.float32,
                )
            )
        for pf in list(self.pre_frames):
            if pf is frame or pf.data is None or "sobel_x" not in pf.data:
                continue
            d = pf.data
            self.seeds, _ = update_seeds(
                self.seeds, ring_T, ring_exp,
                d["pyr"], d["sobel_x"], d["sobel_y"],
                jnp.asarray(pf.T_f_w, jnp.float32), pf.exposure,
                self.px_error_angle, self.cam, update_mask=new_mask,
            )

    # ---------------------------------------------------------------- BA
    def _run_ba(self, center: Frame) -> None:
        from hso_tpu.pipeline.ba_glue import run_local_ba

        run_local_ba(self, center)

    # ---------------------------------------------------------------- misc
    def _closest_keyframe(self, T_ref: np.ndarray) -> Frame | None:
        """Closest keyframe by camera distance among keyframes looking the
        same way — the ``Map::getClosestKeyframe`` analogue (map.cpp:193-230;
        the reference gates on 5-keypoint FoV overlap, here on optical-axis
        agreement, which the overlap test implies for forward-looking rigs).
        Only keyframes that still hold their image pyramid qualify (the
        coarse relocalizer needs one); falls back to the last keyframe."""
        pos = se3np.translation(se3np.inv(T_ref))
        axis = T_ref[:3, 2]  # camera z-axis in world = R row 2 of world→cam
        best, best_d = None, np.inf
        for kf in self.kfs.frames:
            if kf.data is None or "pyr" not in kf.data:
                continue
            cos = float(np.dot(axis, kf.T_f_w[:3, 2]))
            if cos < 0.5:
                continue
            d = float(np.linalg.norm(kf.pos() - pos))
            if d < best_d:
                best, best_d = kf, d
        if best is None and self.kfs.frames:
            last = self.kfs.last()
            best = last if last.data is not None else None
        return best

    def reset_all(self) -> None:
        """Full reset after prolonged tracking failure
        (``FrameHandlerMono::resetAll``, frame_handler_mono.cpp:409-417):
        wipe map, seeds and counters and re-enter the bootstrap."""
        cfg = self.cfg
        self.points = PointTable(cfg.n_points_ba_max * 2)
        self.kfs = KeyframeWindow(k_all_max=cfg.max_n_kfs, recent=SEED_RING)
        self.points.kfs = self.kfs
        self.seeds = empty_seeds(cfg.n_seeds_max)
        self.seed_ring = np.full(SEED_RING, -1, np.int32)
        self.batch_counter = 0
        self.stage = STAGE_FIRST
        self.motion_model = se3np.identity()
        self.first_frame = None
        self._init_px = None
        self.regular_counter = 0
        self.n_last_inliers = 0
        self.after_init = False
        self.reloc_fail_count = 0
        self.mean_converge_frames = 6.0
        self.pre_frames.clear()
        self._snap_heavy = None
        self._snap_light = None
        self._dirty_rows = set()
        self._acc = None
        if self.photo is not None:
            # a tracking collapse may have been CAUSED by a bad photometric
            # estimate — restart calibration from identity with the map
            from hso_tpu.photometric import OnlinePhotometricCalibrator

            solve_every, min_frames = self.photo.solve_every, self.photo.min_frames
            self.photo = OnlinePhotometricCalibrator(self.cam)
            self.photo.solve_every = solve_every
            self.photo.min_frames = min_frames
        self._last_seed_match_px = None
        self._last_seed_matched = None
        self._bump_map_version()

    RELOC_MAX_FAILURES = 30

    def _relocalize(self, frame: Frame) -> FrameResult:
        if not self.kfs.frames:
            return FrameResult(RESULT_FAILURE, frame.T_f_w)
        res = self._relocalize_attempt(frame)
        if res.status == RESULT_FAILURE:
            self.reloc_fail_count += 1
            if self.reloc_fail_count >= self.RELOC_MAX_FAILURES:
                self.reset_all()
        else:
            self.reloc_fail_count = 0
        return res

    def _relocalize_attempt(self, frame: Frame) -> FrameResult:
        ref = self._closest_keyframe(self.last_frame.T_f_w)
        if ref is None:
            # no stored pyramid (e.g. after checkpoint resume): relocalize
            # against the MAP — the memoized point windows make direct
            # matching possible without any keyframe image
            return self._relocalize_by_map(frame)
        frame.T_f_w = self.last_frame.T_f_w.copy()
        tracker = make_coarse_tracker(
            self.cam, max_level=self.cfg.klt_max_level,
            min_level=self.cfg.klt_min_level, n_iter=15, inverse=True,
        )
        ro = ref.obs
        valid_ref = ro["valid"] & (ro["point_id"] >= 0)
        pid = np.where(valid_ref, ro["point_id"], 0)
        pos_w = self.points.positions(self.kfs.poses)[pid]
        p_ref = se3np.apply(ref.T_f_w, pos_w)
        dist = np.where(valid_ref & (p_ref[:, 2] > 1e-5),
                        np.linalg.norm(p_ref, axis=-1), -1.0).astype(np.float32)
        tout = tracker(
            ref.data["pyr"], frame.data["pyr"],
            jnp.asarray(ro["px"], jnp.float32), jnp.asarray(ro["f"], jnp.float32),
            jnp.asarray(dist),
            jnp.asarray(se3np.mul(frame.T_f_w, se3np.inv(ref.T_f_w)), jnp.float32),
            1.0,
        )
        if int(tout["n_tracked"]) > 30:
            frame.T_f_w = se3np.normalize(
                se3np.mul(np.asarray(tout["T_cur_ref"], np.float64), ref.T_f_w)
            )
            self.stage = STAGE_DEFAULT
            # the keyframe's device caches are stale (poses BA-corrected
            # since, obs pids possibly recycled by gc) — drop them so the
            # fused step reads the live host state
            for a in ("T_dev", "obs_dev", "exp_dev", "grad_mean_dev",
                      "intensity_dev"):
                if hasattr(ref, a):
                    setattr(ref, a, None)
            self.last_frame = ref
            return self._process_default(frame)
        # escalate: photometric reloc against the chosen keyframe failed —
        # try the wider-basin map-based matcher before giving up this frame
        return self._relocalize_by_map(frame)

    def _relocalize_by_map(self, frame: Frame) -> FrameResult:
        """Match memoized point windows + pose LM, iterated: the first pass
        closes most of the pose gap, the second matches with the corrected
        prior (no keyframe image needed)."""
        frame.T_f_w = self.last_frame.T_f_w.copy()
        frame.exposure = getattr(self.last_frame, "exposure", 1.0)
        n = n_inl = 0
        for attempt in range(4):
            frame.obs = empty_obs(self._n_obs_pad)
            n = self._reproject(frame)
            if n < 8:
                return FrameResult(RESULT_FAILURE, frame.T_f_w, n_matches=n)
            o = frame.obs
            ov = o["valid"] & (o["point_id"] >= 0)
            pid = np.where(ov, o["point_id"], 0)
            p_world = self.points.positions(self.kfs.poses)[pid].astype(np.float32)
            pout = optimize_pose(
                jnp.asarray(frame.T_f_w, jnp.float32), jnp.asarray(p_world),
                jnp.asarray(o["f"], jnp.float32), jnp.asarray(o["level"]),
                jnp.asarray(o["grad"], jnp.float32), jnp.asarray(o["species"] == 1),
                jnp.asarray(self.points.type[pid] == TYPE_TEMPORARY),
                jnp.asarray(ov), focal=float(self.cam.focal_mean),
            )
            n_inl = int(pout["n_inliers"])
            # with a stale prior the NCC-verified matches are trustworthy even
            # when the inlier strip is harsh — adopt the LM pose and re-match
            frame.T_f_w = se3np.normalize(np.asarray(pout["T_f_w"], np.float64))
            if n_inl >= 30:
                break
        if n_inl < 30:
            return FrameResult(RESULT_FAILURE, frame.T_f_w, n_matches=n)
        self.stage = STAGE_DEFAULT
        self.motion_model = se3np.identity()
        self.n_last_inliers = n_inl
        self.regular_counter += 1
        return FrameResult(RESULT_FRAME, frame.T_f_w, n, n_inl)

    def _restart(self) -> None:
        self.stage = STAGE_FIRST
        self.first_frame = None
        self._init_px = None
