"""Per-frame tracking, the part that drives the fused loop (counterpart of
``orb_slam3_rgbl_tpu.slam.tracking``).

Ported: stereo/RGB-L initialization (``_stereo_initialization`` seeds
keyframe 0 and its landmarks from one frame) and the steady-state loop
``track_image_rgbl`` → ``FastPath.sync/run/advance`` with one packed
download per frame (``_download_fused``) and the host bookkeeping of
``_accept_fused``.

Not ported yet (the next slice): keyframe creation, the classic per-stage
path (TrackReferenceKeyFrame, relocalization, the lost states) and
``System.track_rgbl``. Two consequences here:

* a frame that keeps fewer than 30 inliers, which the JAX tracker would
  hand to the classic path, raises ``TrackingLostError``;
* the first frame after initialization predicts with zero velocity (the
  JAX tracker runs TrackReferenceKeyFrame on the classic path there).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch.config import SlamConfig
from orb_slam3_rgbl_tpu_torch.device import resolve
from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.geometry.camera import np_geo_unproject
from orb_slam3_rgbl_tpu_torch.slam import compiled
from orb_slam3_rgbl_tpu_torch.slam.fast_path import FastPath
from orb_slam3_rgbl_tpu_torch.slam.frame import FrameFeatures
from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState

NO_IMAGES_YET = 0
NOT_INITIALIZED = 1
OK = 2

MIN_FUSED_INLIERS = 30   # below this the JAX tracker leaves the fused loop


class TrackingLostError(RuntimeError):
    """The fused step kept too few inliers; recovery (the classic
    per-stage path) is not ported yet."""


@dataclasses.dataclass
class TrackResult:
    pose: np.ndarray          # (7,) Tcw
    state: int
    n_inliers: int
    created_kf: bool
    timestamp: float


class Tracker:
    def __init__(self, config: SlamConfig, map_state: MapState, n_feat: int,
                 window_cap: int = 8192, device=None):
        self.cfg = config
        self.geo_cam = config.geo_camera
        self.map = map_state
        self.n_feat = n_feat
        self.device = resolve(device)
        self.fast = FastPath(config, n_feat, window_cap=window_cap, device=self.device)
        self.state = NO_IMAGES_YET
        self.frame_id = -1
        self.cur_pose = lie.np_se3_identity()
        self.last_pose: Optional[np.ndarray] = None
        self.velocity: Optional[np.ndarray] = None   # T_cur_last
        self.last_feats: Optional[FrameFeatures] = None
        self.cur_lm_idx: Optional[np.ndarray] = None
        self.last_lm_idx: Optional[np.ndarray] = None
        self.last_lm_gen: Optional[np.ndarray] = None
        self.ref_kf = -1
        self.scale_factors = np.asarray(
            [config.orb.scale_factor ** l for l in range(config.orb.n_levels)], np.float32)
        self.P_lidar = compiled.lidar_projection(config, self.device)

    # ------------------------------------------------------------------
    def track_image_rgbl(self, img, points, cloud_valid, timestamp: float) -> TrackResult:
        """Frame 0 initializes the map; every later frame runs the fused
        step through ``FastPath``."""
        if self.state != OK:
            self.frame_id += 1
            feats = self._extract_rgbl(img, points, cloud_valid)
            host_feats = self._download_feats(feats)
            ok = self._stereo_initialization(host_feats, timestamp)
            self.state = OK if ok else NOT_INITIALIZED
            if ok:
                self.last_pose = self.cur_pose.copy()
                self.velocity = lie.np_se3_identity()   # zero-motion prior
                self.last_feats = feats
                self.last_lm_idx = self.cur_lm_idx.copy()
                self.last_lm_gen = self.map.lm_gen[np.clip(self.last_lm_idx, 0, None)].copy()
            return TrackResult(pose=self.cur_pose.copy(), state=self.state,
                               n_inliers=int(host_feats.valid.sum()) if ok else 0,
                               created_kf=ok, timestamp=timestamp)

        fp = self.fast
        fp.sync(self.map, self.ref_kf, self.last_feats, self.last_lm_idx, self.last_lm_gen)
        out = fp.run(img, points, cloud_valid, self._predict_pose_fused())
        host = self._download_fused(out)
        if host[0] < MIN_FUSED_INLIERS:
            raise TrackingLostError(
                f"frame {self.frame_id + 1}: fused step kept {host[0]} inliers "
                f"(< {MIN_FUSED_INLIERS}); recovery through the classic tracking "
                "path is the next slice of the port (Tracker keyframe creation, "
                "classic path and System.track_rgbl)")
        return self._accept_fused(out, host, timestamp)

    # ------------------------------------------------------------------
    def _extract_rgbl(self, img, points, cloud_valid) -> FrameFeatures:
        feats = compiled.extract(self.cfg, img, self.device)
        return compiled.attach_lidar(
            self.cfg, feats, torch.as_tensor(points, dtype=torch.float32, device=self.device),
            self.P_lidar,
            None if cloud_valid is None
            else torch.as_tensor(cloud_valid, dtype=torch.bool, device=self.device))

    @staticmethod
    def _download_feats(feats: FrameFeatures) -> FrameFeatures:
        """Host copy (numpy) of a frame's features; descriptors come back
        as the JAX package's uint32 words."""
        host = {k: v.detach().cpu().numpy() for k, v in feats._asdict().items()}
        host["desc"] = host["desc"].view(np.uint32)
        return FrameFeatures(**host)

    def _stereo_initialization(self, feats: FrameFeatures, timestamp: float) -> bool:
        """Reference ``Tracking::StereoInitialization``: need ≥ 500
        features; create KF0 at identity + landmarks from every feature
        with positive depth. ``feats`` are host (numpy) features."""
        valid, depth, uv = feats.valid, feats.depth, feats.uv
        if valid.sum() < 500:
            return False
        self.cur_pose = lie.np_se3_identity()
        feat_idx = np.nonzero(valid & (depth > 0))[0]
        rays = self._unproject(uv[feat_idx], depth[feat_idx], self.cur_pose)
        lm_idx = np.full(self.n_feat, -1, np.int32)
        kf_id = self.map.add_keyframe(
            self.cur_pose, uv, feats.octave.astype(np.int16), feats.desc, depth,
            feats.u_right, valid, lm_idx, timestamp, self.frame_id, angle=feats.angle)
        normals = rays / np.maximum(np.linalg.norm(rays, axis=-1, keepdims=True), 1e-9)
        octv = feats.octave[feat_idx]
        dist = np.linalg.norm(rays, axis=-1)
        sf = self.scale_factors[np.clip(octv, 0, len(self.scale_factors) - 1)]
        ids = self.map.add_landmarks(
            rays.astype(np.float32), feats.desc[feat_idx], kf_id, feat_idx,
            normals.astype(np.float32), (dist * sf).astype(np.float32),
            (dist * sf / self.scale_factors[-1] / self.cfg.orb.scale_factor).astype(np.float32))
        self.cur_lm_idx = lm_idx.copy()
        self.cur_lm_idx[feat_idx] = ids
        self.ref_kf = kf_id
        return True

    def _unproject(self, uv: np.ndarray, depth: np.ndarray, Tcw) -> np.ndarray:
        pc = (np_geo_unproject(self.geo_cam, uv) * depth[:, None]).astype(np.float32)
        Twc = lie.np_se3_inv(np.asarray(Tcw, np.float32))
        return lie.np_quat_rotate(Twc[:4], pc) + Twc[4:7]

    def _predict_pose_fused(self) -> np.ndarray:
        return lie.np_se3_mul(self.velocity, self.last_pose)

    def _download_fused(self, out: compiled.TrackStepOut):
        """ONE device→host transfer for everything the control loop needs."""
        v = out.packed.cpu().numpy()
        N = self.n_feat
        n_inl, n_mm, n_tc, n_ntc = v[:4].astype(np.int64)
        pose = v[4:11].astype(np.float32)
        bind_prev = v[11: 11 + N].astype(np.int32)
        bind_win = v[11 + N: 11 + 2 * N].astype(np.int32)
        win_visible = v[11 + 2 * N:] > 0.5
        return (int(n_inl), pose, bind_prev, bind_win, win_visible, int(n_tc), int(n_ntc))

    def _accept_fused(self, out, host, timestamp: float) -> TrackResult:
        fp = self.fast
        self.frame_id += 1
        n_inl, pose, bind_prev, bind_win, win_visible, _, _ = host
        cur = np.full(self.n_feat, -1, np.int32)
        cur_gen = np.zeros(self.n_feat, np.int32)
        pm = bind_prev >= 0
        cur[pm] = fp.prev_lm_ids[bind_prev[pm]]
        cur_gen[pm] = fp.prev_lm_gen[bind_prev[pm]]
        wm = bind_win >= 0
        cur[wm] = fp.win_ids[bind_win[wm]]
        cur_gen[wm] = fp.win_gen[bind_win[wm]]
        # slot-recycling guard: drop bindings whose slot was culled and reused
        b = cur >= 0
        safe = np.clip(cur, 0, None)
        cur[b & ((~self.map.lm_valid[safe]) | (self.map.lm_gen[safe] != cur_gen))] = -1
        self.cur_pose = pose
        self.cur_lm_idx = cur

        # visibility / found bookkeeping (MapPoint::IncreaseVisible/Found)
        vis = win_visible[: len(fp.win_ids)]
        self.map.lm_visible[fp.win_ids[vis]] += 1
        self.map.lm_found[cur[cur >= 0]] += 1

        self.velocity = lie.np_se3_mul(pose, lie.np_se3_inv(self.last_pose))
        self.last_pose = pose.copy()
        self.last_feats = out.feats
        self.last_lm_idx = cur.copy()
        self.last_lm_gen = cur_gen
        fp.advance(out, cur.copy(), cur_gen)
        return TrackResult(pose=pose.copy(), state=OK, n_inliers=n_inl,
                           created_kf=False, timestamp=timestamp)
