"""System facade, the port's public entry point (counterpart of
``orb_slam3_rgbl_tpu.slam.system``; reference ``System.cc``).

Ported: ``System(cfg).track_rgbl``, ``track_rgbd`` (sensor RGBD: a metric
depth image in place of the cloud), ``track_stereo`` (sensor STEREO: depth
from row matching of the left and right features, refined by SAD, after the
pair is rectified where the settings give a second camera that needs it)
and ``track_monocular`` (sensor MONOCULAR: no depth; the map starts from a
two-view reconstruction and has no metric scale) with the default
configuration (local mapping on, loop closing on) — the fused steady-state
loop (RGB-L, RGB-D, monocular) and the classic
ladder, the atlas's new-map recovery after a lost streak or a backward
timestamp, trajectory export, and the planes behind every frame that
created a keyframe: the mapping job of ``LocalMapper.process_keyframe``
(landmark culling, triangulation, fusion, local BA, keyframe culling), then
loop closing (the keyframe is indexed in the database, loop candidates are
detected and verified by Sim3, a verified loop is corrected — fusion,
essential graph, landmark re-anchoring — and a 16-iteration global BA
follows). A keyframe that closed no loop is looked up in the databases of
the archived atlas maps; a verified match welds the active map into the
archived one (``slam.merging``, ``_do_merge``: the trajectory, the
database, the tracker and both planes move to the welded map, and a
weld-window local BA follows). A lost tracker relocalizes against the
keyframe database. ``cfg.vocab_path`` swaps the database's LSH words for a
trained tree vocabulary. ``track_features`` feeds extracted features
straight to the ladder.

With ``async_mapping = False`` (the default, as in the JAX package) the
planes run synchronously, inside the frame that made the keyframe. With
``async_mapping = True`` they run as the JAX ``System`` runs them, on three
worker threads (the reference's LocalMapping and LoopClosing threads and
its transient global-BA thread): the mapping worker drains a keyframe queue
and applies verified loop corrections between jobs, the loop worker indexes
and detects (index only while the mapping plane is busy), and the global BA
solves a snapshot on its own thread, abortable by a later correction, and
lands at the next structural point of the tracking thread. Tracking goes on
meanwhile: the fused step keeps its window (``FastPath.hold``), landmark
statistics are buffered, NeedNewKeyFrame declines while three keyframes are
queued or a correction runs. On the card each worker issues its device work
on a CUDA stream of its own (``_on_plane``), after the tracking stream's
work it reads, and synchronizes its stream before it publishes a result;
the keyframe mirror and the database order cross-stream reads themselves.
A failed loop detection is logged and its traceback kept in
``worker_errors``; the mapping and GBA workers' exceptions surface where
their futures are read.

With ``enable_mapping=False`` keyframes still mint landmarks from LiDAR
depth, so a drive tracks over any distance, but nothing is culled or
refined; with ``loop_closing=False`` there is no database, so
relocalization fails at once and no map is ever welded.

A PinHole camera with distortion coefficients works on undistorted
keypoints (``_undistort_feats``, after the depth is sampled at the raw
pixel) against a working camera with its distortion zeroed; its frames
never take the fused step. ``activate_localization_mode`` freezes the map:
no keyframe, no mapping job. ``save_atlas`` / ``load_atlas`` write and read
the JAX package's archive format (``utils/serialization.py``); a loaded
atlas resumes in relocalization. ``timer`` (a ``utils.profiling.StageTimer``)
collects the reference's stage times beside the profiler spans.

Stereo frames take the per-stage path every frame, as in the JAX package
(it has no fused stereo step). The inertial sensors (IMU_MONOCULAR,
IMU_STEREO, IMU_RGBD) take ``imu=``, the (S, 7) samples ``[t, ax, ay, az,
gx, gy, gz]`` since the previous frame, on ``track_monocular``,
``track_stereo``, ``track_rgbd`` and ``track_features``; their frames take
the per-stage path every frame (the fused step has no inertial branch, as
in the JAX package). After a frame that made a keyframe the planes add the
IMU initialization (until it succeeds; the tracker is then re-expressed in
the gravity-aligned metric frame) and the VIBA1 / VIBA2 schedule; a
motion-starved initialization (``LocalMapper.bad_imu``) resets the active
map, and so does a forward timestamp jump of more than 1 s (a new map once
VIBA2 has run). Inertial configurations stay synchronous even with
``async_mapping = True``, as in the JAX package: the IMU initialization and
VIBA interleave with the tracking state.

A KannalaBrandt8 camera (``camera_type``) is accepted with every sensor:
matching and every solver's residuals project through ``cfg.geo_camera``,
and a stereo-fisheye pair (a ``Camera2`` section) is neither rectified nor
undistorted: ``track_stereo`` matches the two fisheye images' features over
the full table and triangulates each match (depth only). What the JAX
package keeps on the pinhole ``cfg.camera`` (whose distortion slots then
hold the KB8 coefficients) the port keeps there too: the loop closer's Sim3
and global BA, the weld, the monocular two-view initialization and DLT
relocalization, and the fused step of the monocular, RGB-D and RGB-L
sensors.

``start_viewer`` starts the live viewer (``viz/live.LiveViewer``, the
reference's Viewer thread): ``track_rgbl``, ``track_rgbd``,
``track_monocular`` and ``track_stereo`` (the left image; the JAX package's
stereo entry feeds nothing) hand it each frame's image; ``shutdown`` stops
it first.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from orb_slam3_rgbl_tpu_torch.config import (IMU_STEREO, MONOCULAR, RGBD, RGBL, SENSOR_NAMES,
                                             STEREO, SlamConfig)
from orb_slam3_rgbl_tpu_torch.device import resolve
from orb_slam3_rgbl_tpu_torch.geometry import camera as cam_mod
from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.geometry.rectify import build_rectifier
from orb_slam3_rgbl_tpu_torch.io import trajectory as traj_io
from orb_slam3_rgbl_tpu_torch.ops import fast as fast_ops
from orb_slam3_rgbl_tpu_torch.slam import compiled, merging
from orb_slam3_rgbl_tpu_torch.slam import frame as frame_mod
from orb_slam3_rgbl_tpu_torch.slam import tracking as trk
from orb_slam3_rgbl_tpu_torch.slam.atlas import Atlas
from orb_slam3_rgbl_tpu_torch.slam.fast_path import FastPath
from orb_slam3_rgbl_tpu_torch.slam.local_mapping import LocalMapper
from orb_slam3_rgbl_tpu_torch.slam.loop_closing import LoopCloser
from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState
from orb_slam3_rgbl_tpu_torch.slam.tracking import Tracker, TrackResult
from orb_slam3_rgbl_tpu_torch.utils import serialization
from orb_slam3_rgbl_tpu_torch.utils.logging import log
from orb_slam3_rgbl_tpu_torch.utils.profiling import stage

GBA_ITERATIONS = 16   # LM iterations of the global BA after a loop correction


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    """Whether tensor ``t`` lies on ``dev`` ('cuda' means the current card)."""
    if t.device.type != dev.type:
        return False
    if dev.type != "cuda":
        return True
    return t.device.index == (torch.cuda.current_device() if dev.index is None else dev.index)


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class System:
    CLOUD_CAP = 131072  # fixed LiDAR capacity (KITTI sweeps hold ~120k points)

    def __init__(self, config: SlamConfig, enable_mapping: bool = True, device=None):
        if config.inertial and config.imu is None:
            raise ValueError(f"sensor {SENSOR_NAMES[config.sensor]} needs cfg.imu (ImuConfig)")
        if config.sensor not in SENSOR_NAMES:
            raise ValueError(f"unknown sensor {config.sensor!r}")
        # a stereo pair with a second camera that needs it is rectified
        # (the reference's Settings maps) and the system works on the
        # rectified camera; a distorted pinhole otherwise works on
        # undistorted keypoints (Frame::UndistortKeyPoints) against a
        # working camera without distortion
        self.rectifier = None
        self._undistort_cam = None
        if (config.sensor in (STEREO, IMU_STEREO) and config.stereo is not None
                and config.stereo.needs_rectify and config.camera_type == "PinHole"):
            self.rectifier = build_rectifier(config)
            config = dataclasses.replace(config, camera=self.rectifier.cam_rect)
            if config.sensor == IMU_STEREO:
                # the IMU sees the rectified camera (Settings.cc's
                # Tbc = Tbc · T_r1_u1⁻¹; the JAX package keeps the
                # unrectified extrinsic)
                T = np.asarray(config.imu.T_body_cam, np.float64).reshape(4, 4)
                T_u_r = np.eye(4)
                T_u_r[:3, :3] = self.rectifier.R1.T
                config = dataclasses.replace(config, imu=dataclasses.replace(
                    config.imu, T_body_cam=tuple((T @ T_u_r).reshape(-1).tolist())))
        elif config.camera_type == "PinHole" and config.camera.has_distortion:
            self._undistort_cam = config.camera
            config = dataclasses.replace(config, camera=dataclasses.replace(
                config.camera, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0))
            if config.sensor in (RGBL, STEREO, IMU_STEREO):
                log("WARNING: distorted PinHole configuration with sensor %s: keypoints are "
                    "undistorted per frame, but stereo row matching and the LiDAR projection "
                    "assume rectified images; give rectified input or a Camera2 section"
                    % SENSOR_NAMES[config.sensor])
        self.cfg = config
        self.cam = config.camera
        self.device = resolve(device)
        # a stereo-fisheye pair: both KB8 cameras (k0..k3 from the k1, k2,
        # k3 and p2 slots) and the right camera's pose in the left frame
        self._fisheye_pair = None
        if config.camera_type == "KannalaBrandt8" and config.stereo is not None:
            c, st = config.camera, config.stereo
            T = np.asarray(st.T_c1_c2, np.float32).reshape(4, 4)
            q = lie.matrix_to_quat(torch.as_tensor(T[:3, :3], device=self.device))
            self._fisheye_pair = (
                cam_mod.KannalaBrandt8Camera(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, k0=c.k1,
                                             k1=c.k2, k2=c.k3, k3=c.p2, width=c.width,
                                             height=c.height, bf=c.bf),
                cam_mod.KannalaBrandt8Camera(fx=st.fx, fy=st.fy, cx=st.cx, cy=st.cy, k0=st.k1,
                                             k1=st.k2, k2=st.k3, k3=st.p2, width=c.width,
                                             height=c.height, bf=c.bf),
                torch.cat([q, torch.as_tensor(T[:3, 3], device=self.device)]))
        self._enable_mapping = enable_mapping
        # components materialize on the first frame
        self.atlas: Optional[Atlas] = None
        self.map: Optional[MapState] = None
        self.tracker: Optional[Tracker] = None
        self.mapper: Optional[LocalMapper] = None   # local-mapping plane
        self.loop_closer: Optional[LoopCloser] = None   # loop-closing plane
        # the source of the RANSAC draws of loop verification and of
        # relocalization (CPU generators, seeded: a run repeats)
        self._loop_rng = torch.Generator().manual_seed(7)
        self._reloc_rng = torch.Generator().manual_seed(13)
        self._init_rng = torch.Generator().manual_seed(21)   # monocular two-view draws
        self._lost_streak = 0
        self._fast: Optional[FastPath] = None   # shared across atlas maps
        self.use_fused = True       # the fused steady-state loop
        self.timer = None           # optional StageTimer (the reference's REGISTER_TIMES)
        self.P_lidar = compiled.lidar_projection(config, self.device)
        self._cloud_mask_ones = None
        # the asynchronous planes (off by default, as in the JAX package;
        # the engine bench and the example runners turn them on)
        self.async_mapping = False
        self.worker_errors: list = []   # tracebacks of failed loop detections
        self._map_exec = self._loop_exec = self._gba_exec = None
        self._map_future = self._loop_future = self._gba_future = None
        self._gba_abort: Optional[threading.Event] = None
        self._map_queue = deque()       # keyframes for the mapping worker
        self._loop_queue = deque()      # keyframes for the loop worker
        self._loop_inbox = deque()      # (map, LoopEvent) verified, to be corrected
        self._merge_candidate = None    # (map, keyframe) that closed no loop
        self._last_shed_kf = None       # newest index-only keyframe, re-detected when idle
        self._freeze_kf = False         # a correction runs: no keyframe may be inserted
        self._gba_lock = threading.Lock()
        self._loop_lock = threading.Lock()
        self._kf_lock = threading.Lock()    # keyframe creation vs correction
        self._rng_lock = threading.Lock()   # draws of _loop_rng (loop worker, _try_merge)
        self._streams: dict = {}            # plane → its CUDA stream
        self._tracker_stream = None         # the tracking thread's stream
        # the live viewer (reference Viewer thread, System.cc:236-244),
        # created on demand by start_viewer()
        self._viewer = None

    # ------------------------------------------------------------------
    def _extract(self, gray):
        return compiled.extract(self.cfg, gray, self.device)

    def _pad_cloud(self, pointcloud, cloud_mask=None):
        """(Np, 3|4) → fixed (CLOUD_CAP, 4) cloud + validity mask on the
        device; over-capacity clouds are truncated (the tail is far-range
        returns). A device tensor already at (CLOUD_CAP, 4) passes through
        untouched (a caller that stages frames on the card pays no
        transfer); an explicit ``cloud_mask`` becomes the mask."""
        dev = self.device
        if (isinstance(pointcloud, torch.Tensor) and _on(pointcloud, dev)
                and tuple(pointcloud.shape) == (self.CLOUD_CAP, 4)):
            if cloud_mask is not None:
                return pointcloud, torch.as_tensor(cloud_mask, dtype=torch.bool, device=dev)
            if self._cloud_mask_ones is None or self._cloud_mask_ones.shape[0] != self.CLOUD_CAP:
                self._cloud_mask_ones = torch.ones(self.CLOUD_CAP, dtype=torch.bool, device=dev)
            return pointcloud, self._cloud_mask_ones
        pc = _numpy(pointcloud).astype(np.float32)
        if pc.shape[1] == 3:
            pc = np.concatenate([pc, np.ones((len(pc), 1), np.float32)], axis=1)
        n = min(len(pc), self.CLOUD_CAP)
        out = np.zeros((self.CLOUD_CAP, 4), np.float32)
        out[:n] = pc[:n]
        mask = np.zeros(self.CLOUD_CAP, bool)
        mask[:n] = True if cloud_mask is None else _numpy(cloud_mask).astype(bool)[:n]
        return (torch.as_tensor(out, device=dev),
                torch.as_tensor(mask, dtype=torch.bool, device=dev))

    def _frame_capacity(self) -> int:
        o = self.cfg.orb
        return int(sum(fast_ops.features_per_level(o.n_features, o.n_levels, o.scale_factor)))

    def _check_timestamp_jump(self, timestamp: float):
        """Input-stream sanity (``Tracking::Track`` head, Tracking.cc:1855-1888):
        a BACKWARD timestamp means the stream restarted — start a new map; a
        FORWARD gap of more than 1 s breaks an inertial map's preintegration
        chain — reset the active map (a new map once VIBA2 has run)."""
        if self.tracker is None or not self.tracker.traj_time:
            return
        last = self.tracker.traj_time[-1]
        if timestamp < last:
            log("ERROR: frame timestamp older than previous frame — starting a new map")
            self._create_map_in_atlas()
        elif timestamp > last + 1.0 and self.cfg.inertial:
            log("timestamp jump of %.2f s: resetting" % (timestamp - last))
            viba2_done = self.mapper is not None and self.mapper._viba_stage >= 2
            if self.map.imu_initialized and viba2_done:
                self._create_map_in_atlas()
            else:
                self.reset_active_map()

    def _create_map_in_atlas(self):
        """Archive the active map and start tracking in a fresh one
        (``Tracking::CreateMapInAtlas``); a map of fewer than two
        keyframes is discarded. The planes are drained first."""
        n_feat = self.tracker.n_feat or self._frame_capacity()
        self._join_mapping()
        if self.map.n_kf >= 2:
            self.atlas.archive_trajectory(self.tracker)
        else:
            self.atlas.entries.pop(self.atlas.active_idx)
        self._spawn_components(n_feat)

    def track_rgbl(self, gray, pointcloud, timestamp: float, cloud_mask=None) -> TrackResult:
        """Gray image (H, W) + raw LiDAR cloud (N, 3|4) → ``TrackResult``
        (``System::TrackRGBL``). Numpy arrays or tensors; a cloud already
        on the device at (CLOUD_CAP, 4) is used in place.

        Steady-state frames run the fused step; with ``use_fused`` off, a
        distorted camera or another sensor than RGBL every frame takes the
        classic ladder on the raw cloud."""
        self._check_timestamp_jump(timestamp)
        if self._viewer is not None:
            self._viewer.latest_img = gray   # FrameDrawer::Update feed
        if self.use_fused and self._undistort_cam is None and self.cfg.sensor == RGBL:
            self._ensure_fast("rgbl")
            img = torch.as_tensor(gray, dtype=torch.float32, device=self.device)
            pts, mask = self._pad_cloud(pointcloud, cloud_mask)
            return self._post_track(self.tracker.track_image_rgbl(img, pts, mask, timestamp,
                                                                  timer=self.timer))
        feats = compiled.attach_lidar(
            self.cfg, self._extract(gray),
            torch.as_tensor(pointcloud, dtype=torch.float32, device=self.device), self.P_lidar,
            None if cloud_mask is None
            else torch.as_tensor(cloud_mask, dtype=torch.bool, device=self.device))
        return self._track(self._undistort_feats(feats), timestamp)

    def track_rgbd(self, gray, depth_img, timestamp: float, imu=None) -> TrackResult:
        """Gray image (H, W) + metric depth image (H, W) → ``TrackResult``
        (``System::TrackRGBD``). Depth is sampled at the raw (distorted)
        pixel; geometry uses undistorted coordinates. Steady-state frames
        run the fused step, as ``track_rgbl`` does, with the depth image in
        place of the cloud; an inertial frame (``imu``: the samples since the
        previous frame) takes the per-stage path."""
        self._check_timestamp_jump(timestamp)
        if self._viewer is not None:
            self._viewer.latest_img = gray
        depth = torch.as_tensor(depth_img, dtype=torch.float32, device=self.device)
        if (self.use_fused and self._undistort_cam is None and imu is None
                and self.cfg.sensor == RGBD):
            self._ensure_fast("rgbd")
            img = torch.as_tensor(gray, dtype=torch.float32, device=self.device)
            return self._post_track(self.tracker.track_image_rgbd(img, depth, timestamp,
                                                                  timer=self.timer))
        feats = frame_mod.attach_depth_map(self._extract(gray), depth, self.cam.bf)
        return self._track(self._undistort_feats(feats), timestamp, imu)

    def _ensure_fast(self, mode: str):
        """Components and the shared ``FastPath`` of the fused loop."""
        if self.map is None:
            self._spawn_components(self._frame_capacity())
        if self._fast is None:
            self._fast = FastPath(self.cfg, self._frame_capacity(), mode=mode, device=self.device)
            self.tracker.fast = self._fast

    def _undistort_feats(self, feats):
        """Undistorted keypoint coordinates (``Frame::UndistortKeyPoints``)
        and the pseudo-stereo column re-derived from them; the features as
        they are for an undistorted camera."""
        if self._undistort_cam is None:
            return feats
        uvu = cam_mod.undistort_points(self._undistort_cam, feats.uv)
        has_d = feats.depth > 0
        u_right = torch.where(
            has_d, uvu[..., 0] - self.cam.bf / torch.where(has_d, feats.depth, 1.0), -1.0)
        return feats._replace(uv=uvu, u_right=u_right)

    def track_stereo(self, gray_l, gray_r, timestamp: float, imu=None) -> TrackResult:
        """Left and right gray images (H, W) → ``TrackResult``
        (``System::TrackStereo``): rectified first when the system has a
        rectifier; both extracted; the left features' depth from row
        matching against the right ones (disparity ≤ bf / 0.5, z ≥ 0.5 m),
        refined by SAD on the level-0 images, or, for a stereo-fisheye pair,
        by triangulating mutual best matches (``frame.
        attach_stereo_fisheye_depth``); then the classic ladder (``imu``:
        the samples since the previous frame, IMU_STEREO)."""
        self._check_timestamp_jump(timestamp)
        if self._viewer is not None:
            # the left image, as the reference's FrameDrawer::Update for
            # every sensor (the JAX package's track_stereo has no feed)
            self._viewer.latest_img = gray_l
        img_l = torch.as_tensor(gray_l, dtype=torch.float32, device=self.device)
        img_r = torch.as_tensor(gray_r, dtype=torch.float32, device=self.device)
        if self.rectifier is not None:
            img_l, img_r = self.rectifier.remap(img_l, img_r)
        o = self.cfg.orb
        feats_l, feats_r = self._extract(img_l), self._extract(img_r)
        if self._fisheye_pair is not None:
            feats = frame_mod.attach_stereo_fisheye_depth(feats_l, feats_r, *self._fisheye_pair,
                                                          scale_factor=o.scale_factor)
            return self._track(feats, timestamp, imu)
        feats = frame_mod.attach_stereo_depth(
            feats_l, feats_r, self.cam.bf, min_disp=0.0,
            max_disp=self.cam.bf / 0.5, n_levels=o.n_levels, scale_factor=o.scale_factor)
        feats = frame_mod.refine_stereo_subpixel(feats, img_l, img_r, self.cam.bf)
        return self._track(self._undistort_feats(feats), timestamp, imu)

    def track_monocular(self, gray, timestamp: float, imu=None) -> TrackResult:
        """Gray image (H, W) → ``TrackResult`` (``System::TrackMonocular``).
        The map initializes from a two-view reconstruction on the classic
        ladder and has no metric scale (IMU_MONOCULAR: metric once the IMU
        initializes; ``imu``: the samples since the previous frame); steady
        MONOCULAR frames run the fused step without a depth source."""
        self._check_timestamp_jump(timestamp)
        if self._viewer is not None:
            self._viewer.latest_img = gray
        img = torch.as_tensor(gray, dtype=torch.float32, device=self.device)
        if (self.use_fused and self._undistort_cam is None and imu is None
                and self.cfg.sensor == MONOCULAR):
            self._ensure_fast("mono")
            return self._post_track(self.tracker.track_image_mono(img, timestamp,
                                                                  timer=self.timer))
        return self._track(self._undistort_feats(self._extract(img)), timestamp, imu)

    def track_features(self, feats, timestamp: float, imu=None) -> TrackResult:
        """Feature-level entry point: extracted ``FrameFeatures`` on the
        system's device go straight to the classic ladder (testing, or
        replaying features without images); ``imu`` as ``track_monocular``'s."""
        return self._track(feats, timestamp, imu)

    # ------------------------------------------------------------------
    def _spawn_components(self, n_feat: int):
        """A new active map and its tracker and planes. Frame ids continue
        across maps; the shared ``FastPath`` re-syncs on the new map. What
        the planes held for the old map is dropped."""
        self._drop_plane_work()
        if self.atlas is None:
            self.atlas = Atlas(self.cfg, n_feat)
        next_frame = self.tracker.frame_id + 1 if self.tracker is not None else 0
        self.map = self.atlas.create_new_map()
        self._build_components(next_frame)
        if self.loop_closer is not None:
            # the entry keeps its database alive for later merge detection
            self.atlas.entries[self.atlas.active_idx].db = self.loop_closer.db

    def _drop_plane_work(self):
        """Discard what the planes hold for the active map: a global BA in
        flight, queued keyframes, detections and events."""
        self._cancel_gba()
        self._map_queue.clear()
        with self._loop_lock:
            self._loop_queue.clear()
        self._loop_inbox.clear()
        self._merge_candidate = None
        self._last_shed_kf = None

    def _build_components(self, next_frame: int, db=None, loop_closing: bool = True):
        """The tracker and both planes around the active map, wired; the
        loop-closing plane (when the configuration and ``loop_closing``
        have it) around ``db`` or a new keyframe database."""
        self.tracker = Tracker(self.cfg, self.map, start_frame_id=next_frame, device=self.device)
        self.mapper = (LocalMapper(self.cfg, self.map, device=self.device)
                       if self._enable_mapping else None)
        t = self.tracker
        if self.mapper is not None:
            self.mapper.timer = self.timer
            t.kf_feats_hook = self.mapper.dev_cache.add
            # keyframes queued behind the running job (the reference's
            # mbAbortBA pressure: the local BA shortens or skips)
            self.mapper.backlog_fn = lambda: len(self._map_queue)
        t.pre_kf_hook = self._poll_mapping
        t.join_mapping_fn = self._join_mapping
        t.kf_guard = self._kf_lock
        # NeedNewKeyFrame declines while a correction runs or the mapping
        # plane is three keyframes behind (the reference's KeyframesInQueue() < 3)
        t.mapping_busy_fn = lambda: self._freeze_kf or (
            len(self._map_queue) + (1 if self._map_busy() else 0) >= 3)
        # any job may be mutating the map now: the tracker buffers its
        # landmark statistics
        t.mapping_inflight_fn = lambda: bool(self._map_queue) or self._map_busy()
        t.fast = self._fast
        t.init_generator = self._init_rng
        self.loop_closer = None
        if self.cfg.loop_closing and loop_closing:
            self.loop_closer = LoopCloser(
                self.cfg, self.map, device=self.device, generator=self._loop_rng,
                dev_cache=self.mapper.dev_cache if self.mapper is not None else None)
            if db is not None:
                self.loop_closer.db = db
            self.loop_closer.rng_lock = self._rng_lock
            self.loop_closer.gba_dispatch = self._dispatch_gba
            t.kf_db = self.loop_closer.db
            t.reloc_generator = self._reloc_rng
        self._lost_streak = 0

    def _map_busy(self) -> bool:
        return self._map_future is not None and not self._map_future.done()

    def _set_hold(self, hold: bool):
        if self._fast is not None:
            self._fast.hold = hold

    def _current_stream(self):
        return torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None

    @contextlib.contextmanager
    def _on_plane(self, plane: str, after=None):
        """Run a worker's item on the plane's own CUDA stream (``mapping``,
        ``loop`` or ``gba``), which first waits for ``after`` (the stream
        whose work the item reads: the tracking thread's unless given) and
        is synchronized before the item's results are published. On the
        CPU, where the caller asked for it, there is nothing to order."""
        if self.device.type != "cuda":
            yield
            return
        stream = self._streams.get(plane)
        if stream is None:
            stream = self._streams[plane] = torch.cuda.Stream(device=self.device)
        with torch.cuda.stream(stream):
            stream.wait_stream(after if after is not None else self._tracker_stream)
            try:
                yield
            finally:
                stream.synchronize()

    # -- the mapping plane (the reference's LocalMapping thread) ---------
    def _dispatch_mapping(self, kf_id: int):
        """The new keyframe's job: inline on the synchronous plane, queued
        to the mapping worker on the asynchronous one. Inertial
        configurations stay synchronous (the IMU initialization and VIBA
        interleave with the tracking state)."""
        if not self.async_mapping or self.cfg.inertial:
            self._mapping_job(kf_id, defer_merge=False)
            return
        self._tracker_stream = self._current_stream()
        self._map_queue.append(kf_id)
        if self._map_future is None or self._map_future.done():
            # land a finished job first (it resubmits for a non-empty queue)
            self._poll_mapping()
            if self._map_queue and self._map_future is None:
                self._submit_mapping_worker()

    def _submit_mapping_worker(self):
        if self._map_exec is None:
            self._map_exec = ThreadPoolExecutor(max_workers=1, thread_name_prefix="mapping")
        self._map_future = self._map_exec.submit(self._mapping_worker)

    def _mapping_worker(self):
        """Drain the keyframe queue (the reference's LocalMapping::Run loop
        body). Queued loop corrections apply between jobs: this thread owns
        map mutations while it runs. The fused step's window is held across
        each item and released between them."""
        while True:
            if self._loop_inbox:
                self._set_hold(True)
                try:
                    with self._on_plane("mapping"):
                        self._apply_loop_events()
                finally:
                    self._set_hold(False)
            try:
                kf_id = self._map_queue.popleft()
            except IndexError:
                return
            self._set_hold(True)
            try:
                with self._on_plane("mapping"):
                    self._mapping_job(kf_id, defer_merge=True)
            finally:
                self._set_hold(False)

    def _mapping_job(self, kf_id: int, defer_merge: bool):
        """The job behind a new keyframe: local mapping, then loop closing.
        Inline (``defer_merge`` False) detection and correction follow at
        once and a keyframe that closed no loop is tried against the other
        atlas maps; on the mapping worker the keyframe goes to the loop
        worker instead, and a merge candidate waits for the tracking
        thread."""
        if self.mapper is not None and self.map.n_kf > 1:
            self.mapper.process_keyframe(kf_id)
        if self.loop_closer is None:
            return
        if defer_merge:
            self._enqueue_loop_detect(kf_id)
            return
        with stage(self.timer, "pr"):
            ev = self.loop_closer.on_keyframe(kf_id)
        if ev is None:
            self._try_merge(kf_id)

    def _land_mapping_job(self):
        """Wait for the job in flight (its exception surfaces here), then
        release the window and land the tracker's buffered statistics."""
        fut, self._map_future = self._map_future, None
        try:
            fut.result()
        finally:
            self._set_hold(False)
            if self.tracker is not None:
                self.tracker.flush_stat_buffer()

    def _take_merge_candidate(self):
        mc, self._merge_candidate = self._merge_candidate, None
        if mc is not None and mc[0] is self.map:
            self._try_merge(mc[1])

    def _join_mapping(self):
        """Drain the mapping queue, the job in flight and the loop plane
        before a structural operation (the reference's queue-drain gates).
        Corrections, merges and a finished global BA land here, on the
        calling thread."""
        while True:
            while self._map_future is not None or self._map_queue:
                if self._map_future is None:
                    self._submit_mapping_worker()
                self._land_mapping_job()
            with self._loop_lock:
                self._kick_loop_worker_locked()
                lf = self._loop_future
            if lf is not None:
                lf.result()
            self._apply_loop_events()
            self._take_merge_candidate()
            if (self._map_future is None and not self._map_queue and self._loop_future is None
                    and not self._loop_queue and not self._loop_inbox):
                break
        if self.loop_closer is not None:
            self._poll_gba()
        if self.tracker is not None:
            self.tracker.flush_stat_buffer()

    def _poll_mapping(self):
        """Non-blocking checkpoint (the tracker's pre-keyframe hook and the
        head of every frame's post-tracking): land a finished job without
        waiting for a running one; with the plane idle, send queued
        corrections back to the worker (a correction would stall this
        frame), re-enqueue the newest shed detection, and land a merge
        candidate and a finished global BA here."""
        if self._map_future is not None and self._map_future.done():
            self._land_mapping_job()
            if self.loop_closer is not None:
                self._poll_gba()
            if self._map_queue or self._loop_inbox:
                self._submit_mapping_worker()
        if self._map_future is None and not self._map_queue:
            if self._loop_inbox:
                self._submit_mapping_worker()
                return
            if (self._last_shed_kf is not None and not self._loop_queue
                    and self._loop_future is None):
                kf, self._last_shed_kf = self._last_shed_kf, None
                self._enqueue_loop_detect(kf)
            self._take_merge_candidate()
            if self.loop_closer is not None:
                self._poll_gba()

    # -- the loop plane (the reference's LoopClosing thread) -------------
    def _enqueue_loop_detect(self, kf_id: int):
        with self._loop_lock:
            self._loop_queue.append(kf_id)
            self._kick_loop_worker_locked()

    def _kick_loop_worker_locked(self):
        """(Re)start the loop worker if keyframes are queued and no live
        worker will see them. The caller holds ``_loop_lock``."""
        if not self._loop_queue:
            return
        if self._loop_exec is None:
            self._loop_exec = ThreadPoolExecutor(max_workers=1, thread_name_prefix="loop")
        if self._loop_future is None or self._loop_future.done():
            self._loop_future = self._loop_exec.submit(self._loop_worker)

    def _loop_worker(self):
        """Drain the detection queue (LoopClosing::Run). While the mapping
        plane is busy or more keyframes wait, a keyframe is indexed only
        (load shedding); the newest one shed is detected again once the
        plane idles. A verified event goes to the inbox, a keyframe that
        closed no loop becomes the merge candidate."""
        while True:
            with self._loop_lock:
                if not self._loop_queue:
                    # marked with the empty check, atomically: an enqueue
                    # racing this exit resubmits
                    self._loop_future = None
                    return
                kf_id = self._loop_queue.popleft()
            index_only = bool(self._loop_queue) or bool(self._map_queue) or self._map_busy()
            lc = self.loop_closer
            if lc is None:
                continue
            try:
                with self._on_plane("loop"), stage(self.timer, "pr"):
                    ev = lc.detect_only(kf_id, index_only=index_only)
            except Exception:
                tb = traceback.format_exc()
                log("loop detection of keyframe %d failed:\n%s" % (kf_id, tb))
                self.worker_errors.append(tb)
                continue
            if index_only:
                self._last_shed_kf = kf_id
            elif self._last_shed_kf is not None and kf_id >= self._last_shed_kf:
                self._last_shed_kf = None
            if lc is not self.loop_closer:
                continue               # components respawned mid-detection
            if ev is not None:
                # the suppression window starts now: detections queued
                # behind this one must not verify the same revisit again
                lc.last_loop_kf = kf_id
                self._loop_inbox.append((self.map, ev))
            else:
                self._merge_candidate = (self.map, kf_id)

    def _apply_loop_events(self):
        """Run queued corrections. The caller owns map mutations (the
        mapping worker between jobs, or the tracking thread with the plane
        idle). No keyframe is inserted meanwhile: the freeze declines new
        ones, the lock waits out one in flight."""
        while self._loop_inbox:
            ev_map, ev = self._loop_inbox.popleft()
            if ev_map is not self.map or self.loop_closer is None:
                continue               # the map was replaced since detection
            if not (self.map.kf_valid[ev.kf_cur] and self.map.kf_valid[ev.kf_matched]):
                continue               # a side was culled since detection
            self._freeze_kf = True
            try:
                with self._kf_lock, stage(self.timer, "opt_essential"):
                    self.loop_closer.apply_event(ev)
            finally:
                self._freeze_kf = False

    # -- the global BA after a correction --------------------------------
    def _dispatch_gba(self):
        """The global BA after a loop correction, ``GBA_ITERATIONS`` (16) LM
        iterations: a loop-bent map needs about that many to unbend (on an
        initialized inertial map the whole-map inertial solve, 7 in one
        call: ``LoopCloser._gba_iterate``). Inline on the synchronous plane. On the asynchronous one the snapshot is
        assembled here, on the thread that owns map mutations, and solved
        on the ``gba`` thread; a new correction aborts a running solve (the
        reference's ``mbStopGBA``)."""
        if not self.async_mapping:
            self.loop_closer._global_ba(GBA_ITERATIONS)
            return
        closer = self.loop_closer
        snapshot = closer._gba_assemble()
        after = self._current_stream()
        with self._gba_lock:
            self._abort_gba_locked()
            if self._gba_exec is None:
                self._gba_exec = ThreadPoolExecutor(max_workers=1, thread_name_prefix="gba")
            self._gba_abort = threading.Event()
            self._gba_future = self._gba_exec.submit(self._gba_job, closer, snapshot, after,
                                                     self._gba_abort)

    def _gba_job(self, closer, snapshot, after, abort):
        with self._on_plane("gba", after):
            return closer._gba_iterate(snapshot, GBA_ITERATIONS, abort)

    def _abort_gba_locked(self):
        if self._gba_future is not None:
            self._gba_abort.set()
            fut, self._gba_future = self._gba_future, None
            fut.result()               # a chunk ends before the abort is seen

    def _cancel_gba(self):
        """Abort and discard a solve in flight (its snapshot belongs to a
        map being replaced or rebound)."""
        with self._gba_lock:
            self._abort_gba_locked()

    def _poll_gba(self, wait: bool = False):
        """Write back a finished solve (with ``wait``, wait for it) at a
        structural point, the mapping plane idle."""
        with self._gba_lock:
            fut = self._gba_future
            if fut is None or not (wait or fut.done()):
                return
            self._gba_future = None
            out = fut.result()
        if out is not None:
            self.loop_closer._apply_gba(out)

    def _try_merge(self, kf_id: int) -> bool:
        """Cross-map place recognition (reference ``NewDetectCommonRegions``
        merge branch, LoopClosing.cc:324-533): the keyframe's signature
        against every archived map's database, the best three gated
        candidates verified by Sim3; the first verified one is welded."""
        if self.atlas.n_maps() < 2 or self.map.n_kf < 1:
            return False
        qv = self.loop_closer.db.vectors[kf_id]
        for ei, entry in enumerate(self.atlas.entries):
            if entry.map is self.map or entry.db is None or entry.map.n_kf < 2:
                continue
            scores, shared = entry.db.query(qv, np.zeros(0, np.int64))
            if shared.max() == 0:
                continue
            gate = shared >= max(int(0.8 * shared.max()), 1)
            cands = np.argsort(-np.where(gate, scores, 0.0))[:3]
            for cand in cands:
                if not gate[cand] or scores[cand] <= 0:
                    continue
                with record_function("merge.verify"), self._rng_lock:
                    out = merging.verify_cross_map(
                        self.cfg, self.map, kf_id, entry.map, int(cand), self.loop_closer.fix_scale,
                        generator=self._loop_rng, device=self.device)
                if out is None:
                    continue
                S12, n_inl, fusion = out
                self._do_merge(merging.MergeEvent(kf_cur=kf_id, kf_matched=int(cand), entry_idx=ei,
                                                  n_inliers=n_inl, S12=S12, fusion=fusion))
                return True
        return False

    def _do_merge(self, ev: merging.MergeEvent):
        """Weld the active map into the archived map of ``ev`` (reference
        ``MergeLocal``): transport and append the active map, fuse the
        verified duplicates, weld the trajectory segments, extend the
        archived database, rebind the tracker and both planes, drop the
        active atlas entry, then a local BA around the weld. On the
        asynchronous plane a solve in flight is discarded, the loop worker's
        detection in flight ends first (unlike the JAX ``System``, which lets
        it run on into the welded map), queued keyframes take their welded
        ids and queued detections and events, carrying old ids, are
        dropped."""
        self._cancel_gba()
        with self._loop_lock:
            self._loop_queue.clear()
            lf = self._loop_future
        if lf is not None:
            lf.result()
        entry_old = self.atlas.entries[ev.entry_idx]
        old = entry_old.map
        active_map_id = self.map.map_id
        with record_function("merge.weld"):
            S_w2_w1 = merging.world_alignment(ev.S12, self.map.kf_pose[ev.kf_cur],
                                              old.kf_pose[ev.kf_matched])
            res = merging.merge_maps(old, self.map, ev.kf_cur, S_w2_w1)
            # fuse the verified duplicates (active-side ids → merged ids first)
            fuse_remap = merging.apply_fusion(res.map, res.lm_remap[ev.fusion[0]], ev.fusion[1])
            lm_map = np.where(res.lm_remap >= 0, fuse_remap[np.clip(res.lm_remap, 0, None)],
                              -1).astype(np.int32)

            # the active trajectory segment joins the archived one, relative
            # translations in merged-map units
            self.atlas.archive_trajectory(self.tracker)
            active_entry = self.atlas.entries[self.atlas.active_idx]
            s = float(S_w2_w1[7])
            for Tcr, rk, t, lost in zip(active_entry.traj_rel, active_entry.traj_ref_kf,
                                        active_entry.traj_time, active_entry.traj_lost):
                Tcr2 = np.asarray(Tcr, np.float32).copy()
                Tcr2[4:7] *= s
                entry_old.traj_rel.append(Tcr2)
                entry_old.traj_ref_kf.append(int(res.kf_remap[rk]))
                entry_old.traj_time.append(t)
                entry_old.traj_lost.append(lost)

            # the archived database grows to the welded map and indexes the
            # transported keyframes
            db = entry_old.db
            db.grow(res.map.capacity_kf)
            for k in res.appended_kfs:
                db.add(int(k), res.map.kf_desc[k], res.map.kf_feat_valid[k])

        # rebind the tracker and both planes to the welded map
        self.map = res.map
        self.tracker.rebind_after_merge(res.map, res.kf_remap, lm_map, S_w2_w1)
        self.tracker.traj_rel = list(entry_old.traj_rel)
        self.tracker.traj_ref_kf = list(entry_old.traj_ref_kf)
        self.tracker.traj_time = list(entry_old.traj_time)
        self.tracker.traj_lost = list(entry_old.traj_lost)
        self.tracker.kf_db = db
        if self.mapper is not None:
            self.mapper.map = res.map
            # the JAX package remaps the creation count of each batch as if
            # it were a keyframe id; carried as it is
            self.mapper.recent_lm = [
                (lm_map[np.clip(ids, 0, None)][lm_map[np.clip(ids, 0, None)] >= 0],
                 int(res.kf_remap[k]) if k < len(res.kf_remap) and res.kf_remap[k] >= 0
                 else res.map.n_kf - 1)
                for ids, k in self.mapper.recent_lm]
        self.loop_closer.map = res.map
        self.loop_closer.db = db
        # merged ids invalidate the device mirror of keyframe features (the
        # mapper's, which the closer shares, or the closer's own)
        self.loop_closer.dev_cache.reset(res.map.capacity_kf)
        # no re-detection right around the weld
        self.loop_closer.last_loop_kf = res.kf_cur_new
        # the weld constraint joins every later essential graph
        # (reference KeyFrame::AddMergeEdge)
        self.loop_closer.extra_edges.append(
            (int(res.kf_cur_new), int(ev.kf_matched), np.asarray(ev.S12, np.float32), 10.0))
        self.loop_closer._consistent_groups = []
        self.atlas.entries.remove(active_entry)
        self.atlas.active_idx = self.atlas.entries.index(entry_old)
        self._map_queue = deque(int(res.kf_remap[k]) for k in self._map_queue
                                if 0 <= k < len(res.kf_remap) and res.kf_remap[k] >= 0)
        self._loop_inbox.clear()
        self._merge_candidate = None
        self._last_shed_kf = None

        # weld-window bundle adjustment (LoopClosing.cc:1623-1627); an
        # initialized inertial map takes the 15-DoF solve over its chain
        # (the reference's MergeInertialBA)
        if self.mapper is not None:
            with record_function("merge.ba"):
                res.map.update_landmark_stats(np.array([res.kf_cur_new]))
                if self.cfg.inertial and res.map.imu_initialized:
                    self.mapper.full_inertial_ba(res.kf_cur_new)
                else:
                    self.mapper.local_bundle_adjustment(res.kf_cur_new)
        log("merge: welded map %d into map %d (%d keyframes transported, scale %.4f)"
            % (active_map_id, old.map_id, len(res.appended_kfs), s))

    def _track(self, feats, timestamp, imu=None) -> TrackResult:
        if self.map is None:
            self._spawn_components(int(feats.uv.shape[0]))
        return self._post_track(self.tracker.track(feats, timestamp, imu=imu))

    def _post_track(self, res: TrackResult) -> TrackResult:
        """After the tracking stage: land what the asynchronous planes
        finished, then the mapping job of the frame's last new keyframe
        (inertial: then the VIBA schedule or the IMU initialization, and the
        bad-IMU reset), then elastic recovery — a LOST streak longer than
        ``fps`` frames archives the map (or discards it, under two
        keyframes) and starts a new one (Tracking.cc:2032-2058)."""
        if self._viewer is not None:
            self._viewer.update(self.tracker)     # FrameDrawer::Update: the frame's keypoints
        if ((self._map_future is not None and self._map_future.done())
                or (self._loop_inbox and self._map_future is None)):
            self._poll_mapping()
        if self.tracker.new_kf_ids:
            self._dispatch_mapping(self.tracker.new_kf_ids[-1])
            if self.cfg.inertial and self.mapper is not None:
                self._inertial_schedule(res.timestamp)
        if self.mapper is not None and self.mapper.bad_imu:
            # a motion-starved IMU initialization (Tracking.cc:1839-1844)
            log("resetting the active map (bad IMU)")
            self.reset_active_map()
            return res
        if res.state == trk.LOST:
            self._lost_streak += 1
        elif res.state == trk.OK:
            self._lost_streak = 0
        if self._lost_streak > int(self.cfg.fps):
            self._create_map_in_atlas()
        return res

    def _inertial_schedule(self, timestamp: float):
        """After a keyframe's job: VIBA1 / VIBA2 on an initialized map,
        else an IMU initialization attempt; on success the tracker moves to
        the gravity-aligned metric frame (ids unchanged) and takes the
        reference keyframe's velocity and biases."""
        if self.map.imu_initialized:
            with record_function("map.viba"):
                self.mapper.maybe_viba(timestamp)
            return
        S_align = self.mapper.maybe_initialize_imu()
        if S_align is None:
            return
        identity_kf = np.arange(self.map.capacity_kf, dtype=np.int32)
        identity_lm = np.append(np.arange(self.map.capacity_lm, dtype=np.int32), -1)
        t = self.tracker
        t.rebind_after_merge(self.map, identity_kf, identity_lm, S_align)
        t.cur_vel = self.map.kf_vel[t.ref_kf].copy()
        t.cur_bias = (self.map.kf_bg[t.ref_kf].copy(), self.map.kf_ba[t.ref_kf].copy())

    # -- live viewer (reference Viewer / FrameDrawer threads) -------------
    def start_viewer(self, out_dir: str = "viewer_out", hz: float = 2.0,
                     http_port=None, map_3d: bool = False):
        """Start the live-viewer thread (``Viewer::Run``): the frame overlay
        and a map view rendered to ``out_dir`` at ``hz``, and served over
        HTTP on ``http_port`` (0 picks a free port) if given. Returns the
        ``viz.live.LiveViewer``."""
        from orb_slam3_rgbl_tpu_torch.viz.live import LiveViewer

        if self._viewer is None:
            self._viewer = LiveViewer(self, out_dir=out_dir, hz=hz, http_port=http_port,
                                      map_3d=map_3d)
            self._viewer.start()
        return self._viewer

    def stop_viewer(self):
        if self._viewer is not None:
            self._viewer.stop()
            self._viewer = None

    # ------------------------------------------------------------------
    def shutdown(self):
        """``System::Shutdown``: stop the viewer, drain the planes, land the
        global BA and stop the worker threads."""
        self.stop_viewer()
        self._join_mapping()
        self._poll_gba(wait=True)
        for name in ("_map_exec", "_loop_exec", "_gba_exec"):
            executor = getattr(self, name)
            if executor is not None:
                executor.shutdown(wait=True)
                setattr(self, name, None)

    def _resolve_segment(self, entry) -> np.ndarray:
        """World-frame camera poses Twc of one atlas entry's trajectory
        segment, against its map's current keyframe poses."""
        if not entry.traj_rel:
            return np.zeros((0, 7), np.float32)
        m = entry.map
        ref_poses = np.stack([m.effective_kf_pose(int(rk)) for rk in entry.traj_ref_kf])
        return lie.np_se3_inv(lie.np_se3_mul(np.stack(entry.traj_rel), ref_poses))

    def trajectory(self) -> np.ndarray:
        """World-frame camera poses Twc (F, 7), one per frame, across all
        atlas maps (``SaveTrajectoryKITTI`` semantics), after the planes
        have drained and the global BA has landed."""
        self._join_mapping()
        self._poll_gba(wait=True)
        if self.atlas is None:
            return np.zeros((0, 7), np.float32)
        self.atlas.archive_trajectory(self.tracker)
        segs = [s for s in (self._resolve_segment(e) for e in self.atlas.entries) if len(s)]
        return np.concatenate(segs) if segs else np.zeros((0, 7), np.float32)

    def timestamps(self):
        if self.atlas is None:
            return []
        self.atlas.archive_trajectory(self.tracker)
        return [t for e in self.atlas.entries for t in e.traj_time]

    def save_trajectory_kitti(self, path: str):
        traj_io.save_kitti(path, self.trajectory())

    def save_trajectory_tum(self, path: str):
        traj_io.save_tum(path, self.timestamps(), self.trajectory())

    def save_trajectory_euroc(self, path: str):
        traj_io.save_euroc(path, self.timestamps(), self.trajectory())

    def _keyframe_poses(self):
        """(timestamps, Twc (K, 7)) of the atlas map with the most
        keyframes (the reference's ``pBiggerMap``)."""
        big = self.map
        for e in self.atlas.entries:
            if e.map.n_kf > big.n_kf:
                big = e.map
        valid = big.valid_kf_ids()
        return big.kf_timestamp[valid], lie.np_se3_inv(big.kf_pose[valid])

    def save_keyframe_trajectory_kitti(self, path: str):
        traj_io.save_kitti(path, self._keyframe_poses()[1])

    def save_keyframe_trajectory_tum(self, path: str):
        traj_io.save_tum(path, *self._keyframe_poses())

    def save_keyframe_trajectory_euroc(self, path: str):
        traj_io.save_euroc(path, *self._keyframe_poses())

    # -- lifecycle ---------------------------------------------------------
    def activate_localization_mode(self):
        """``ActivateLocalizationMode``: track against the existing map and
        leave it frozen — no keyframe, so no mapping job and no loop
        closing."""
        if self.tracker is not None:
            self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        if self.tracker is not None:
            self.tracker.only_tracking = False

    # -- persistence (SaveAtlas / LoadAtlas) ------------------------------
    def save_map(self, path: str):
        """The active map alone (``serialization.save_map``)."""
        self._join_mapping()
        serialization.save_map(path, self.map)

    def save_atlas(self, path: str):
        """Every atlas map with its database and trajectory segment, after
        the planes have drained."""
        self._join_mapping()
        serialization.save_atlas(path, self.atlas, tracker=self.tracker)

    def load_atlas(self, path: str, strict_vocab: bool = True):
        """Rebuild the components around a saved atlas (either package's):
        the planes drain first, the active map's trajectory segment goes
        back to a new tracker, frame ids go on after every saved frame, and
        the tracker starts LOST, so the next frame relocalizes against the
        restored database."""
        self._join_mapping()
        self._drop_plane_work()
        self.atlas = serialization.load_atlas(path, self.cfg, strict_vocab=strict_vocab,
                                              device=self.device)
        entry = self.atlas.entries[self.atlas.active_idx]
        self.map = entry.map
        next_frame = sum(len(e.traj_time) for e in self.atlas.entries)
        self._build_components(next_frame, db=entry.db, loop_closing=entry.db is not None)
        t = self.tracker
        t.state = trk.LOST
        t.traj_rel, t.traj_ref_kf = list(entry.traj_rel), list(entry.traj_ref_kf)
        t.traj_time, t.traj_lost = list(entry.traj_time), list(entry.traj_lost)
        entry.traj_rel, entry.traj_ref_kf, entry.traj_time, entry.traj_lost = [], [], [], []

    def reset(self):
        """Full reset (``System::Reset``): drop the whole atlas; fresh
        components materialize on the next frame."""
        self._join_mapping()
        self._cancel_gba()
        self.atlas = None
        self.map = None
        self.tracker = None
        self.mapper = None
        self.loop_closer = None
        self._lost_streak = 0

    def reset_active_map(self):
        """``System::ResetActiveMap``: discard the active map and restart
        tracking in a fresh one; other atlas maps stay."""
        if self.tracker is None:
            return
        self._join_mapping()
        n_feat = self.map.n_features
        self.atlas.entries.pop(self.atlas.active_idx)
        self._spawn_components(n_feat)
