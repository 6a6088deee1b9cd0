"""Per-frame tracking: the state machine, the classic per-stage ladder,
keyframe creation and the fused loop (counterpart of
``orb_slam3_rgbl_tpu.slam.tracking``; reference ``Tracking.cc``).

States mirror ``Tracking.h``: NO_IMAGES_YET → NOT_INITIALIZED → OK /
RECENTLY_LOST / LOST. A steady OK frame runs the fused step
(``track_image_rgbl`` → ``FastPath.sync/run/advance``, one packed
download). Initialization, the first frame after it, a frame the fused
step loses, and the lost states run the classic ladder: TrackWithMotionModel
(or TrackReferenceKeyFrame) → TrackLocalMap → NeedNewKeyFrame /
CreateNewKeyFrame. Control flow and tie rules are host numpy, exactly as
in the JAX package; matching and pose solves run the port's PyTorch
functions on the tracker's device.

Ported for the non-inertial RGB-L (stereo-like) sensor. Not ported:
monocular initialization and relocalization's DLT solver (Queue 1 item
14), the inertial parts (item 15) and localization mode with its
visual-odometry branch (item 17). Relocalization runs against the keyframe
database that the loop-closing plane wires (``kf_db``). The hooks of the
asynchronous mapping worker stay ``None`` (item 18).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch.config import MONOCULAR, SlamConfig
from orb_slam3_rgbl_tpu_torch.device import resolve
from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.geometry.camera import np_geo_project, np_geo_unproject
from orb_slam3_rgbl_tpu_torch.ops import matching
from orb_slam3_rgbl_tpu_torch.optim import pnp, pose_opt
from orb_slam3_rgbl_tpu_torch.slam import compiled
from orb_slam3_rgbl_tpu_torch.slam.frame import FrameFeatures, inv_scale_sigma2
from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState

NO_IMAGES_YET = 0
NOT_INITIALIZED = 1
OK = 2
RECENTLY_LOST = 3
LOST = 4

STATE_NAMES = {0: "NO_IMAGES_YET", 1: "NOT_INITIALIZED", 2: "OK", 3: "RECENTLY_LOST", 4: "LOST"}

LOCAL_LM_CAP = 8192   # local-map landmark budget per frame
LOCAL_KF_CAP = 80     # reference caps local keyframes at 80 (Tracking.cc:3543)
MIN_FUSED_INLIERS = 30   # below this a fused frame goes to the classic ladder
RELOC_HYPOTHESES = 256   # PnP RANSAC budget of one relocalization candidate


@dataclasses.dataclass
class TrackResult:
    pose: np.ndarray          # (7,) Tcw
    state: int
    n_inliers: int
    created_kf: bool
    timestamp: float


def _i32(desc_u32: np.ndarray) -> np.ndarray:
    """uint32 descriptor words → int32 with the same bits (the port's layout)."""
    return np.ascontiguousarray(desc_u32, np.uint32).view(np.int32)


class Tracker:
    def __init__(self, config: SlamConfig, map_state: MapState, start_frame_id: int = 0,
                 device=None):
        if config.inertial:
            raise NotImplementedError(
                "inertial tracking is not ported yet (ROADMAP Queue 1 item 15)")
        if config.sensor == MONOCULAR:
            raise NotImplementedError(
                "monocular initialization is not ported yet (ROADMAP Queue 1 item 14)")
        self.cfg = config
        self.cam = config.camera
        self.geo_cam = config.geo_camera
        self.map = map_state
        self.device = resolve(device)
        self.state = NO_IMAGES_YET
        self.n_feat: Optional[int] = None   # set on the first frame
        self.kf_db = None   # KeyFrameDatabase, wired by the loop-closing plane
        self.reloc_generator = None   # torch.Generator of the PnP draws, wired with it
        self.fast = None    # FastPath, wired by System for the fused loop
        # mapping hooks, wired by the mapping plane (all checked for None)
        self.pre_kf_hook = None        # called right before keyframe creation
        self.kf_feats_hook = None      # called with (kf_id, feats) after creation
        self.mapping_busy_fn = None    # NeedNewKeyFrame declines while busy
        self.join_mapping_fn = None    # the classic ladder joins the worker first
        self.mapping_inflight_fn = None  # a worker job is mutating the map now
        self.kf_guard = None           # lock held across keyframe creation
        self._pending_device_feats = None
        self._stat_buffer: list = []   # deferred lm_visible/lm_found bumps
        self.new_kf_ids: list = []     # keyframes created this frame
        self._feats_prefetch = None    # (feats, blob, desc, event) async KF download
        self._host_cache: list = []    # [(device feats, host feats)], newest last
        self._ref_tracked_cache = None

        self.cur_pose = lie.np_se3_identity()
        self.last_pose: Optional[np.ndarray] = None
        self.velocity: Optional[np.ndarray] = None   # T_cur_last
        self.last_feats: Optional[FrameFeatures] = None
        self.cur_lm_idx: Optional[np.ndarray] = None
        self.last_lm_idx: Optional[np.ndarray] = None
        self.last_lm_gen: Optional[np.ndarray] = None  # lm_gen snapshot
        self.ref_kf: int = -1
        self.last_kf_frame: int = -9999
        self.last_reloc_frame: int = -9999
        # frame ids are global across atlas maps (the reference's
        # Frame::nNextId is a static counter)
        self.frame_id: int = start_frame_id - 1
        o = config.orb
        self.inv_sigma2 = inv_scale_sigma2(o.n_levels, o.scale_factor, self.device)
        self.scale_factors = np.asarray([o.scale_factor ** l for l in range(o.n_levels)],
                                        np.float32)
        # depth threshold in meters: mThDepth = bf · ThDepth / fx
        self.th_depth_m = self.cam.bf * self.cam.th_depth / self.cam.fx
        # trajectory log: relative pose to the reference keyframe per frame
        self.traj_rel: list = []
        self.traj_ref_kf: list = []
        self.traj_time: list = []
        self.traj_lost: list = []
        self.min_frames = 0
        self.max_frames = int(config.fps)
        # force a keyframe every N frames (0: the natural policy only);
        # deferred_kf counts insertions the mapping busy-gate declined
        self.force_kf_every = 0
        self.deferred_kf = 0
        self.P_lidar = compiled.lidar_projection(config, self.device)

    # ------------------------------------------------------------------
    def _dev(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _host(self, feats: FrameFeatures) -> FrameFeatures:
        """Host (numpy) copy of a frame's features, descriptors as uint32
        words; cached for the current and the last frame, so each frame's
        features come down once."""
        if isinstance(feats.uv, np.ndarray):
            return feats
        for dev_f, host_f in self._host_cache:
            if dev_f is feats:
                return host_f
        host_f = self._download_feats(feats)
        self._host_cache = self._host_cache[-1:] + [(feats, host_f)]
        return host_f

    # ------------------------------------------------------------------
    def track(self, feats: FrameFeatures, timestamp: float) -> TrackResult:
        """One frame through the classic ladder. ``feats`` are the frame's
        features on the tracker's device."""
        if self.join_mapping_fn is not None:
            self.join_mapping_fn()
        self.frame_id += 1
        if self.n_feat is None:
            self.n_feat = int(feats.uv.shape[0])
        created_kf = False
        self.new_kf_ids = []
        if self.state in (NO_IMAGES_YET, NOT_INITIALIZED):
            ok = self._stereo_initialization(feats, timestamp)
            self.state = OK if ok else NOT_INITIALIZED
            n_inl = int(self._host(feats).valid.sum()) if ok else 0
            created_kf = ok
        else:
            ok, n_inl = self._track_frame(feats)
            if ok:
                self.state = OK
                created_kf = self._maybe_insert_keyframe(feats, timestamp, n_inl)
            elif self.state == OK:
                self.state = RECENTLY_LOST
            elif self.state == RECENTLY_LOST:
                self.state = LOST
        self._log_trajectory(timestamp)
        self._update_last(feats)
        return TrackResult(pose=self.cur_pose.copy(), state=self.state, n_inliers=n_inl,
                           created_kf=created_kf, timestamp=timestamp)

    # ------------------------------------------------------------------
    def _stereo_initialization(self, feats: FrameFeatures, timestamp: float) -> bool:
        """Reference ``Tracking::StereoInitialization``: need ≥ 500
        features; create KF0 at identity + landmarks from every feature
        with positive depth."""
        hf = self._host(feats)
        valid, depth, uv = hf.valid, hf.depth, hf.uv
        if valid.sum() < 500:
            return False
        self.cur_pose = lie.np_se3_identity()
        feat_idx = np.nonzero(valid & (depth > 0))[0]
        rays = self._unproject(uv[feat_idx], depth[feat_idx], self.cur_pose)
        lm_idx = np.full(self.n_feat, -1, np.int32)
        kf_id = self.map.add_keyframe(
            self.cur_pose, uv, hf.octave.astype(np.int16), hf.desc, depth,
            hf.u_right, valid, lm_idx, timestamp, self.frame_id, angle=hf.angle)
        normals = rays / np.maximum(np.linalg.norm(rays, axis=-1, keepdims=True), 1e-9)
        octv = hf.octave[feat_idx]
        dist = np.linalg.norm(rays, axis=-1)
        sf = self.scale_factors[np.clip(octv, 0, len(self.scale_factors) - 1)]
        ids = self.map.add_landmarks(
            rays.astype(np.float32), hf.desc[feat_idx], kf_id, feat_idx,
            normals.astype(np.float32), (dist * sf).astype(np.float32),
            (dist * sf / self.scale_factors[-1] / self.cfg.orb.scale_factor).astype(np.float32))
        self.cur_lm_idx = lm_idx.copy()
        self.cur_lm_idx[feat_idx] = ids
        self.ref_kf = kf_id
        self.last_kf_frame = self.frame_id
        self.new_kf_ids = [kf_id]
        if self.kf_feats_hook is not None:
            self.kf_feats_hook(kf_id, feats)
        return True

    # ------------------------------------------------------------------
    def _track_frame(self, feats: FrameFeatures):
        """Motion-model (or reference-KF) tracking then local-map
        refinement. Returns (ok, n_inliers)."""
        lm_idx = None
        if self.state in (RECENTLY_LOST, LOST):
            # RECENTLY_LOST / LOST attempt relocalization (Tracking.cc:2036-2053)
            lm_idx, n = self._relocalization(feats)
            if n < 15:
                return False, 0
        if lm_idx is None and self.velocity is not None and self.state == OK:
            lm_idx, n = self._track_with_motion_model(feats, th=15.0)
            if n < 20:
                lm_idx, n = self._track_with_motion_model(feats, th=30.0)
            if n < 20:
                lm_idx = None
        if lm_idx is None:
            lm_idx, n = self._track_reference_keyframe(feats)
            if n < 10 and self.state == OK:
                lm_idx, n = self._relocalization(feats)
            if n < 10:
                return False, 0

        lm_idx, n_inl = self._track_local_map(feats, lm_idx)
        self.cur_lm_idx = lm_idx
        # acceptance (Tracking.cc:3064-3096): ≥ 30 inliers, 50 right after
        # relocalization
        need = 50 if self.frame_id < self.last_reloc_frame + self.max_frames else 30
        return n_inl >= need, n_inl

    def _predict_pose(self) -> np.ndarray:
        if self.velocity is None or self.last_pose is None:
            return self.cur_pose
        return lie.np_se3_mul(self.velocity, self.last_pose)

    def _track_with_motion_model(self, feats: FrameFeatures, th: float):
        """Project the last frame's landmarks with the constant-velocity
        prediction and match in windows (Tracking.cc:2888; th 15 for
        depth sensors, doubled on retry)."""
        pred = self._predict_pose()
        lm_ids = self.last_lm_idx
        safe = np.clip(lm_ids, 0, None)
        sel = (lm_ids >= 0) & self.map.lm_valid[safe]
        if self.last_lm_gen is not None:
            # slot-recycling guard: a culled + reused slot passes lm_valid
            # but its generation moved
            sel &= self.map.lm_gen[safe] == self.last_lm_gen
        ids = lm_ids[sel]
        if ids.size < 10:
            return None, 0
        last = self._host(self.last_feats)
        cap = self.n_feat
        m = min(ids.size, cap)
        P = np.zeros((cap, 3), np.float32)
        Pdesc = np.zeros((cap, 8), np.uint32)
        Poct = np.zeros(cap, np.int32)
        Pangle = np.zeros(cap, np.float32)
        Pvalid = np.zeros(cap, bool)
        P[:m] = self.map.lm_pos[ids[:m]]
        Pdesc[:m] = self.map.lm_desc[ids[:m]]
        Poct[:m] = last.octave[np.nonzero(sel)[0][:m]]
        Pangle[:m] = last.angle[np.nonzero(sel)[0][:m]]
        Pvalid[:m] = True
        ids_global = np.full(cap, -1, np.int64)
        ids_global[:m] = ids[:m]
        lm_idx, n, _ = self._match_and_bind(feats, pred, P, Pdesc, Poct, Pvalid,
                                            ids_global=ids_global, th=th, Pangle=Pangle)
        if n < 10:
            return lm_idx, n
        pose, n_inl, inliers = self._optimize_pose(feats, lm_idx, pred)
        self.cur_pose = pose
        return np.where(inliers, lm_idx, -1), n_inl

    def _track_reference_keyframe(self, feats: FrameFeatures):
        """Brute-force descriptor match against the reference keyframe
        (Tracking.cc:2754 matches through BoW; a full distance table
        replaces it)."""
        k = self.ref_kf
        if k < 0:
            return np.full(self.n_feat, -1, np.int32), 0
        kf_lm = self.map.kf_lm_idx[k]
        d = matching.distance_table(feats.desc, self._dev(_i32(self.map.kf_desc[k]), torch.int32),
                                    feats.valid, self._dev(kf_lm >= 0, torch.bool))
        idx, _ = matching.mutual_best_match(
            d, feats.angle, self._dev(self.map.kf_angle[k], torch.float32),
            th=matching.TH_LOW, ratio=0.7, check_rotation=True)
        idx = idx.cpu().numpy()
        lm_idx = np.where(idx >= 0, kf_lm[np.clip(idx, 0, None)], -1).astype(np.int32)
        lm_idx = np.where((lm_idx >= 0) & self.map.lm_valid[np.clip(lm_idx, 0, None)], lm_idx, -1)
        n = int((lm_idx >= 0).sum())
        if n < 10:
            return lm_idx, n
        init = self.last_pose if self.last_pose is not None else self.cur_pose
        pose, n_inl, inliers = self._optimize_pose(feats, lm_idx, init)
        self.cur_pose = pose
        return np.where(inliers, lm_idx, -1), n_inl

    # ------------------------------------------------------------------
    def _track_local_map(self, feats: FrameFeatures, lm_idx: np.ndarray):
        """Expand to the covisibility-local map and re-optimize (reference
        ``TrackLocalMap``: UpdateLocalMap + SearchLocalPoints +
        PoseOptimization)."""
        local_kfs = self._local_keyframes(lm_idx)
        local_lms = self._local_landmarks(local_kfs, exclude=lm_idx)
        if local_lms.size > 0:
            cap = LOCAL_LM_CAP
            m = min(local_lms.size, cap)
            sel = local_lms[:m]
            P = np.zeros((cap, 3), np.float32)
            Pdesc = np.zeros((cap, 8), np.uint32)
            Poct = np.zeros(cap, np.int32)
            Pvalid = np.zeros(cap, bool)
            P[:m] = self.map.lm_pos[sel]
            Pdesc[:m] = self.map.lm_desc[sel]
            # predicted octave from distance (MapPoint::PredictScale)
            dist = np.linalg.norm(P[:m] - lie.np_se3_centers(self.cur_pose)[None, :], axis=-1)
            ratio = self.map.lm_max_dist[sel] / np.maximum(dist, 1e-6)
            Poct[:m] = np.clip(
                np.ceil(np.log(np.maximum(ratio, 1e-6)) / np.log(self.cfg.orb.scale_factor)),
                0, self.cfg.orb.n_levels - 1).astype(np.int32)
            Pvalid[:m] = True
            self.map.lm_visible[sel] += 1
            extra_idx, _, _ = self._match_and_bind(
                feats, self.cur_pose, P, Pdesc, Poct, Pvalid, ids_global=sel,
                th=4.0, exclude_bound=lm_idx)
            lm_idx = np.where(lm_idx >= 0, lm_idx, extra_idx)
        pose, n_inl, inliers = self._optimize_pose(feats, lm_idx, self.cur_pose)
        self.cur_pose = pose
        lm_idx = np.where(inliers, lm_idx, -1)
        self.map.lm_found[lm_idx[lm_idx >= 0]] += 1
        return lm_idx, n_inl

    def _local_keyframes(self, lm_idx: np.ndarray) -> np.ndarray:
        """Keyframes sharing landmarks with the current frame, ranked by
        count (``UpdateLocalKeyFrames``); the most-shared becomes the
        reference keyframe. numpy's default argsort, as the JAX package."""
        ids = lm_idx[lm_idx >= 0]
        if ids.size == 0:
            return np.array([self.ref_kf], np.int64) if self.ref_kf >= 0 else np.zeros(0, np.int64)
        mask = np.zeros(self.map.capacity_lm, bool)
        mask[ids] = True
        valid_kfs = self.map.valid_kf_ids()
        tbl = self.map.kf_lm_idx[valid_kfs]
        shared = (mask[np.clip(tbl, 0, None)] & (tbl >= 0)).sum(axis=1)
        order = np.argsort(-shared)
        sel = valid_kfs[order[:LOCAL_KF_CAP]]
        sel = sel[shared[order[:LOCAL_KF_CAP]] > 0]
        if sel.size:
            self.ref_kf = int(sel[0])
        return sel

    def _local_landmarks(self, kf_ids: np.ndarray, exclude: np.ndarray) -> np.ndarray:
        if kf_ids.size == 0:
            return np.zeros(0, np.int64)
        tbl = self.map.kf_lm_idx[kf_ids]
        ids = np.unique(tbl[tbl >= 0])
        ids = ids[self.map.lm_valid[ids]]
        bound = exclude[exclude >= 0]
        if bound.size:
            ids = ids[~np.isin(ids, bound)]
        return ids

    # ------------------------------------------------------------------
    def _match_and_bind(self, feats, pose, P, Pdesc, Poct, Pvalid, ids_global,
                        th: float, exclude_bound: Optional[np.ndarray] = None,
                        Pangle: Optional[np.ndarray] = None):
        """Project landmark array P with ``pose`` on the host, window-match
        against the frame on the device, then resolve collisions on the
        host: each feature keeps its closest landmark (stable argsort +
        ``np.unique``, the JAX package's tie rule). Returns
        (per-feature landmark ids (N,), count, per-feature P slot)."""
        pc = lie.np_se3_apply(np.asarray(pose, np.float32), P)
        proj_uv = np_geo_project(self.geo_cam, pc).astype(np.float32)
        u, v = proj_uv[:, 0], proj_uv[:, 1]
        in_img = (u >= 0) & (u < self.cam.width) & (v >= 0) & (v < self.cam.height)
        Pvalid = Pvalid & (pc[:, 2] > 0.1) & in_img
        radius = (th * self.scale_factors[np.clip(Poct, 0, len(self.scale_factors) - 1)]
                  ).astype(np.float32)
        kp_valid = feats.valid
        if exclude_bound is not None:
            kp_valid = kp_valid & self._dev(exclude_bound < 0, torch.bool)
        f32 = torch.float32
        idx, dist = matching.windowed_projection_match(
            self._dev(proj_uv, f32), self._dev(Pvalid, torch.bool),
            self._dev(_i32(Pdesc), torch.int32), self._dev(Poct, torch.int32),
            feats.uv, kp_valid, feats.desc, feats.octave, self._dev(radius, f32),
            th=matching.TH_HIGH,
            proj_angle=None if Pangle is None else self._dev(Pangle, f32),
            kp_angle=None if Pangle is None else feats.angle)
        both = torch.stack([idx.to(f32), dist]).cpu().numpy()   # one download
        idx, dist = both[0].astype(np.int64), both[1]
        lm_idx = np.full(self.n_feat, -1, np.int32)
        feat_slot = np.full(self.n_feat, -1, np.int32)
        hit = np.nonzero(idx >= 0)[0]
        if hit.size:
            order = hit[np.argsort(dist[hit], kind="stable")]
            feats_of = idx[order]
            first = np.unique(feats_of, return_index=True)[1]
            lm_idx[feats_of[first]] = ids_global[order[first]]
            feat_slot[feats_of[first]] = order[first].astype(np.int32)
        return lm_idx, int((lm_idx >= 0).sum()), feat_slot

    def _optimize_pose(self, feats, lm_idx: np.ndarray, init_pose):
        """Robust pose solve on the bound features. Returns (Tcw (7,),
        n_inliers, inliers (N,) bool), downloaded in one transfer."""
        bound = lm_idx >= 0
        Xw = np.zeros((self.n_feat, 3), np.float32)
        Xw[bound] = self.map.lm_pos[lm_idx[bound]]
        L = len(self.scale_factors)
        obs = pose_opt.PoseObs(
            Xw=self._dev(Xw, torch.float32), uv=feats.uv, u_right=feats.u_right,
            inv_sigma2=self.inv_sigma2[feats.octave.clamp(0, L - 1).long()],
            valid=self._dev(bound, torch.bool) & feats.valid)
        res = pose_opt.pose_optimize(self._dev(np.asarray(init_pose, np.float32), torch.float32),
                                     obs, self.geo_cam)
        v = torch.cat([res.Tcw, res.n_inliers.to(torch.float32)[None],
                       res.inliers.to(torch.float32)]).cpu().numpy()
        return v[:7].astype(np.float32), int(v[7]), v[8:] > 0.5

    # ------------------------------------------------------------------
    def _reloc_draws(self, n_pairs: int) -> torch.Tensor:
        """(RELOC_HYPOTHESES, 3) minimal-set draws in [0, n_pairs) from the
        generator the owner wired beside the keyframe database."""
        if self.reloc_generator is None:
            raise ValueError("relocalization needs the caller's torch.Generator for PnP RANSAC")
        return torch.randint(0, n_pairs, (RELOC_HYPOTHESES, 3), generator=self.reloc_generator,
                             device=self.reloc_generator.device)

    def _relocalization(self, feats: FrameFeatures):
        """Recover the pose from scratch (reference ``Relocalization``
        ``Tracking.cc:3643-3810``): database candidates → descriptor match
        → PnP RANSAC → robust pose refinement, and a wide projection search
        before the final accept. The depth sensor gives the query features
        their 3D, so hypotheses are rigid 3-point alignments
        (``optim/pnp.py``). Without a keyframe database (no loop-closing
        plane) it fails at once."""
        fail = np.full(self.n_feat, -1, np.int32), 0
        if self.kf_db is None:
            return fail
        hf = self._host(feats)
        cands = self.kf_db.detect_relocalization_candidates(feats.desc, feats.valid, 5)
        for cand in cands:
            cand = int(cand)
            b2 = self.map.kf_lm_idx[cand] >= 0
            if b2.sum() < 15:
                continue
            d = matching.distance_table(
                feats.desc, self._dev(_i32(self.map.kf_desc[cand]), torch.int32),
                feats.valid, self._dev(b2, torch.bool))
            idx, _ = matching.mutual_best_match(
                d, feats.angle, self._dev(self.map.kf_angle[cand], torch.float32),
                th=matching.TH_LOW, ratio=0.75, check_rotation=True)
            idx = idx.cpu().numpy()
            f1 = np.nonzero((idx >= 0) & (hf.depth > 0))[0]
            if f1.size < 15:
                continue
            lm = self.map.kf_lm_idx[cand, idx[f1]]
            ok_lm = self.map.lm_valid[lm]
            f1, lm = f1[ok_lm], lm[ok_lm]
            if f1.size < 15:
                continue
            uv = hf.uv[f1]
            s2 = (self.cfg.orb.scale_factor ** (2 * hf.octave[f1])).astype(np.float32)
            p_cam = (np_geo_unproject(self.geo_cam, uv) * hf.depth[f1][:, None]).astype(np.float32)
            f32 = torch.float32
            res = pnp.rigid_pnp_ransac(
                self._dev(p_cam, f32), self._dev(self.map.lm_pos[lm], f32), self._dev(uv, f32),
                self._dev(s2, f32), torch.ones(f1.size, dtype=torch.bool, device=self.device),
                self.cam, n_hypotheses=RELOC_HYPOTHESES, draws=self._reloc_draws(f1.size))
            down = torch.cat([res.Tcw, res.n_inliers[None].to(f32), res.inliers.to(f32)]
                             ).cpu().numpy()
            # reference RANSAC accepts ≥ 10 inliers (Tracking.cc:3690),
            # refines, then escalates with a wide SearchByProjection against
            # all the candidate's landmarks before the 50-inlier final accept
            if int(down[7]) < 10:
                continue
            lm_idx = np.full(self.n_feat, -1, np.int32)
            inl = down[8:] > 0.5
            lm_idx[f1[inl]] = lm[inl]
            pose, n_inl, inliers = self._optimize_pose(feats, lm_idx, down[:7].astype(np.float32))
            if n_inl < 10:
                continue
            lm_idx = np.where(inliers, lm_idx, -1)
            if n_inl < 50:
                cand_lms = self.map.kf_lm_idx[cand]
                cand_lms = np.unique(cand_lms[cand_lms >= 0])
                cand_lms = cand_lms[self.map.lm_valid[cand_lms]]
                cap = self.n_feat
                P = np.zeros((cap, 3), np.float32)
                Pdesc = np.zeros((cap, 8), np.uint32)
                Poct = np.zeros(cap, np.int32)
                Pvalid = np.zeros(cap, bool)
                mm = min(cand_lms.size, cap)
                P[:mm] = self.map.lm_pos[cand_lms[:mm]]
                Pdesc[:mm] = self.map.lm_desc[cand_lms[:mm]]
                Pvalid[:mm] = True
                ids_global = np.full(cap, -1, np.int64)
                ids_global[:mm] = cand_lms[:mm]
                extra, _, _ = self._match_and_bind(
                    feats, pose, P, Pdesc, Poct, Pvalid, ids_global=ids_global, th=10.0,
                    exclude_bound=lm_idx)
                lm_idx = np.where(lm_idx >= 0, lm_idx, extra)
                pose, n_inl, inliers = self._optimize_pose(feats, lm_idx, pose)
                lm_idx = np.where(inliers, lm_idx, -1)
            if n_inl >= 30:
                self.cur_pose = pose
                self.last_reloc_frame = self.frame_id
                self.ref_kf = cand
                return lm_idx, int(n_inl)
        return fail

    # ------------------------------------------------------------------
    def _maybe_insert_keyframe(self, feats, timestamp, n_inl) -> bool:
        """Keyframe policy (``NeedNewKeyFrame``) + creation
        (``CreateNewKeyFrame``)."""
        if self.ref_kf < 0:
            return False
        hf = self._host(feats)
        close = hf.valid & (hf.depth > 0) & (hf.depth < self.th_depth_m)
        n_tc = int((close & (self.cur_lm_idx >= 0)).sum())
        n_ntc = int((close & (self.cur_lm_idx < 0)).sum())
        if not self._fast_kf_policy(n_inl, n_tc, n_ntc):
            return False
        self._create_keyframe(feats, timestamp)
        return True

    def _create_keyframe(self, feats, timestamp):
        if self.pre_kf_hook is not None:
            self.pre_kf_hook()
        with self.kf_guard if self.kf_guard is not None else contextlib.nullcontext():
            self._create_keyframe_locked(feats, timestamp)

    def _create_keyframe_locked(self, feats, timestamp):
        hf = self._host(feats)
        uv, depth, valid = hf.uv, hf.depth, hf.valid
        lm_idx = self.cur_lm_idx.copy()
        kf_id = self.map.add_keyframe(
            self.cur_pose, uv, hf.octave.astype(np.int16), hf.desc, depth, hf.u_right,
            valid, lm_idx, timestamp, self.frame_id, angle=hf.angle)
        # close landmarks for unbound features (the reference sorts by
        # depth, creates at least the 100 closest / all closer than ThDepth)
        cand = np.nonzero(valid & (depth > 0) & (lm_idx < 0))[0]
        if cand.size:
            order = cand[np.argsort(depth[cand])]
            keep = order[(depth[order] < self.th_depth_m) | (np.arange(order.size) < 100)]
            if keep.size:
                rays = self._unproject(uv[keep], depth[keep], self.cur_pose)
                vecs = rays - lie.np_se3_centers(self.cur_pose)[None, :]
                d = np.linalg.norm(vecs, axis=-1)
                normals = vecs / np.maximum(d[:, None], 1e-9)
                sf = self.scale_factors[np.clip(hf.octave[keep], 0, len(self.scale_factors) - 1)]
                ids = self.map.add_landmarks(
                    rays.astype(np.float32), hf.desc[keep], kf_id, keep,
                    normals.astype(np.float32), (d * sf).astype(np.float32),
                    (d * sf / self.scale_factors[-1] / self.cfg.orb.scale_factor
                     ).astype(np.float32))
                self.cur_lm_idx[keep] = ids
                self.map.kf_lm_idx[kf_id, keep] = ids
        self.ref_kf = kf_id
        self.last_kf_frame = self.frame_id
        self.new_kf_ids = [kf_id]
        if self.kf_feats_hook is not None:
            df = self._pending_device_feats
            self.kf_feats_hook(kf_id, df if df is not None else feats)
        self._pending_device_feats = None

    # ------------------------------------------------------------------
    def _unproject(self, uv: np.ndarray, depth: np.ndarray, Tcw) -> np.ndarray:
        pc = (np_geo_unproject(self.geo_cam, uv) * depth[:, None]).astype(np.float32)
        Twc = lie.np_se3_inv(np.asarray(Tcw, np.float32))
        return lie.np_quat_rotate(Twc[:4], pc) + Twc[4:7]

    def _update_last(self, feats):
        if self.state == OK:
            if self.last_pose is not None:
                self.velocity = lie.np_se3_mul(self.cur_pose, lie.np_se3_inv(self.last_pose))
            self.last_pose = self.cur_pose.copy()
            self.last_feats = feats
            self.last_lm_idx = (self.cur_lm_idx.copy() if self.cur_lm_idx is not None
                                else np.full(self.n_feat, -1, np.int32))
            self.last_lm_gen = self.map.lm_gen[np.clip(self.last_lm_idx, 0, None)].copy()
        elif self.state in (RECENTLY_LOST, LOST):
            self.velocity = None

    def _log_trajectory(self, timestamp):
        """Relative pose to the reference keyframe, resolved at save time
        against the keyframe's pose (``SaveTrajectoryKITTI``)."""
        if self.ref_kf >= 0 and self.state in (OK, RECENTLY_LOST):
            Tcr = lie.np_se3_mul(self.cur_pose, lie.np_se3_inv(self.map.kf_pose[self.ref_kf]))
            self.traj_rel.append(np.asarray(Tcr, np.float32))
            self.traj_ref_kf.append(self.ref_kf)
            self.traj_lost.append(self.state != OK)
        else:
            self.traj_rel.append(lie.np_se3_identity())
            self.traj_ref_kf.append(max(self.ref_kf, 0))
            self.traj_lost.append(True)
        self.traj_time.append(timestamp)

    # ==================================================================
    # Fused loop
    # ==================================================================
    def track_image_rgbl(self, img, points, cloud_valid, timestamp: float) -> TrackResult:
        """One RGB-L frame. A steady OK frame runs the fused step; a frame
        it loses (< 30 inliers), initialization, the first frame after it
        (no velocity yet) and the lost states take the classic ladder."""
        fp = self.fast
        usable = (fp is not None and self.state == OK and self.velocity is not None
                  and self.ref_kf >= 0 and self.last_lm_idx is not None
                  and self.frame_id + 1 >= self.last_reloc_frame + self.max_frames)
        if usable:
            # prefetch gate: a forced-cadence keyframe is due, or (natural
            # policy) ≥ 3 frames since the last one
            gap = self.frame_id + 1 - self.last_kf_frame
            kf_likely = gap >= (self.force_kf_every if self.force_kf_every > 0
                                else max(3, self.min_frames))
            fp.sync(self.map, self.ref_kf, self.last_feats, self.last_lm_idx, self.last_lm_gen)
            out = fp.run(img, points, cloud_valid, self._predict_pose_fused())
            if kf_likely:
                self._prefetch_feats(out.feats)
            host = self._download_fused(out)
            if host[0] >= MIN_FUSED_INLIERS:
                return self._accept_fused(out, host, timestamp)
            feats = out.feats  # reuse the extraction for the classic ladder
        else:
            feats = self._extract_rgbl(img, points, cloud_valid)
        return self.track(feats, timestamp)

    def _extract_rgbl(self, img, points, cloud_valid) -> FrameFeatures:
        feats = compiled.extract(self.cfg, img, self.device)
        return compiled.attach_lidar(
            self.cfg, feats, self._dev(points, torch.float32), self.P_lidar,
            None if cloud_valid is None else self._dev(cloud_valid, torch.bool))

    def _predict_pose_fused(self) -> np.ndarray:
        return lie.np_se3_mul(self.velocity, self.last_pose)

    def _download_fused(self, out: compiled.TrackStepOut):
        """ONE device→host transfer for everything the control loop needs."""
        v = out.packed.cpu().numpy()
        N = self.n_feat
        n_inl, _, n_tc, n_ntc = v[:4].astype(np.int64)
        pose = v[4:11].astype(np.float32)
        bind_prev = v[11: 11 + N].astype(np.int32)
        bind_win = v[11 + N: 11 + 2 * N].astype(np.int32)
        win_visible = v[11 + 2 * N:] > 0.5
        return (int(n_inl), pose, bind_prev, bind_win, win_visible, int(n_tc), int(n_ntc))

    def _need_close(self, tracked_close: int, nontracked_close: int) -> bool:
        """Close-point starvation trigger (``bNeedToInsertClose``)."""
        return tracked_close < 100 and nontracked_close > 70

    def _ref_kf_tracked(self) -> int:
        """``KeyFrame::TrackedMapPoints(nMinObs)`` of the reference
        keyframe: its landmarks observed by ≥ 3 keyframes (≥ 2 while the
        map is tiny); the bound count while every landmark has a single
        observation. Cached per (map version, ref_kf)."""
        key = (self.map.version, self.ref_kf)
        if self._ref_tracked_cache is not None and self._ref_tracked_cache[0] == key:
            return self._ref_tracked_cache[1]
        min_obs = 3 if self.map.n_kf > 2 else 2
        ids = self.map.kf_lm_idx[self.ref_kf]
        ids = ids[ids >= 0]
        if ids.size == 0:
            return 0
        n = int((self.map.observation_counts(ids) >= min_obs).sum())
        out = n if n > 0 else ids.size
        self._ref_tracked_cache = (key, out)
        return out

    def _fast_kf_policy(self, n_inl: int, tracked_close: int, nontracked_close: int) -> bool:
        """The keyframe decision of ``NeedNewKeyFrame`` from the inlier
        count and the close-point counts (computed on the device by the
        fused step, on the host by the classic ladder)."""
        if self.ref_kf < 0:
            return False
        if (self.map.n_kf > self.max_frames
                and self.frame_id < self.last_reloc_frame + self.max_frames):
            return False
        want = (self.force_kf_every > 0
                and self.frame_id >= self.last_kf_frame + self.force_kf_every)
        if not want:
            ref_matches = self._ref_kf_tracked()
            need_close = self._need_close(tracked_close, nontracked_close)
            th_ref = 0.4 if self.map.n_kf < 2 else 0.75
            c1a = self.frame_id >= self.last_kf_frame + self.max_frames
            c1b = self.frame_id >= self.last_kf_frame + self.min_frames
            c1c = n_inl < ref_matches * 0.25 or need_close
            c2 = (n_inl < ref_matches * th_ref or need_close) and n_inl > 15
            want = (c1a or c1b or c1c) and c2
        if not want:
            return False
        if self.mapping_busy_fn is not None and self.mapping_busy_fn():
            self.deferred_kf += 1
            return False
        return True

    def _accept_fused(self, out, host, timestamp: float) -> TrackResult:
        fp = self.fast
        self.frame_id += 1
        self.new_kf_ids = []
        n_inl, pose, bind_prev, bind_win, win_visible, n_tc, n_ntc = host
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
        self._bump_stats(fp.win_ids[vis], fp.win_gen[vis], cur[cur >= 0], cur_gen[cur >= 0])

        created = self._fast_kf_policy(n_inl, n_tc, n_ntc)
        if created:
            self._pending_device_feats = out.feats
            self._create_keyframe(self._host(out.feats), timestamp)

        self._log_trajectory(timestamp)
        self.velocity = lie.np_se3_mul(pose, lie.np_se3_inv(self.last_pose))
        self.last_pose = pose.copy()
        self.last_feats = out.feats
        self.last_lm_idx = self.cur_lm_idx.copy()
        if created:
            # keyframe creation minted landmarks into cur_lm_idx
            cur_gen = self.map.lm_gen[np.clip(self.cur_lm_idx, 0, None)].copy()
        self.last_lm_gen = cur_gen
        fp.advance(out, self.cur_lm_idx.copy(), cur_gen)
        return TrackResult(pose=pose.copy(), state=OK, n_inliers=n_inl,
                           created_kf=created, timestamp=timestamp)

    # ------------------------------------------------------------------
    @staticmethod
    def _pack_feats_blob(feats: FrameFeatures):
        f32 = torch.float32
        blob = torch.cat([feats.uv.reshape(-1), feats.response, feats.octave.to(f32),
                          feats.angle, feats.valid.to(f32), feats.depth, feats.u_right])
        return blob, feats.desc

    def _prefetch_feats(self, feats: FrameFeatures):
        """Start the keyframe features' download right behind the fused
        step: non-blocking copies into pinned host memory, read after an
        event. Issued only on frames where a keyframe is likely."""
        blob, desc = self._pack_feats_blob(feats)
        event = None
        if blob.device.type == "cuda":
            hb = torch.empty(blob.shape, dtype=blob.dtype, pin_memory=True)
            hd = torch.empty(desc.shape, dtype=desc.dtype, pin_memory=True)
            hb.copy_(blob, non_blocking=True)
            hd.copy_(desc, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            blob, desc = hb, hd
        self._feats_prefetch = (feats, blob, desc, event)

    def _download_feats(self, feats: FrameFeatures) -> FrameFeatures:
        """Host (numpy) copy of a frame's features in two transfers (one
        f32 blob + the descriptor words, which come back as the JAX
        package's uint32); uses the prefetch when one was issued for these
        features."""
        N = feats.uv.shape[0]
        pf = self._feats_prefetch
        self._feats_prefetch = None
        if pf is not None and pf[0] is feats:
            _, blob, desc, event = pf
            if event is not None:
                event.synchronize()
        else:
            blob, desc = self._pack_feats_blob(feats)
        b = blob.cpu().numpy()
        return FrameFeatures(
            uv=b[: 2 * N].reshape(N, 2).copy(), response=b[2 * N: 3 * N].copy(),
            octave=b[3 * N: 4 * N].astype(np.int32), angle=b[4 * N: 5 * N].copy(),
            desc=desc.cpu().numpy().view(np.uint32).copy(), valid=b[5 * N: 6 * N] > 0.5,
            depth=b[6 * N: 7 * N].copy(), u_right=b[7 * N: 8 * N].copy())

    # ------------------------------------------------------------------
    def _bump_stats(self, vis_ids, vis_gen, found_ids, found_gen):
        """``MapPoint::IncreaseVisible/IncreaseFound``. While a mapping job
        is in flight the increments are buffered and flushed at the next
        join."""
        inflight = self.mapping_inflight_fn or self.mapping_busy_fn
        if inflight is not None and inflight():
            self._stat_buffer.append(
                (vis_ids.copy(), vis_gen.copy(), found_ids.copy(), found_gen.copy()))
            return
        self.flush_stat_buffer()
        self.map.lm_visible[vis_ids] += 1
        self.map.lm_found[found_ids] += 1

    def flush_stat_buffer(self):
        """Apply deferred visibility/found increments; entries whose slot
        generation moved meanwhile are dropped."""
        m = self.map
        for vis_ids, vis_gen, found_ids, found_gen in self._stat_buffer:
            m.lm_visible[vis_ids[m.lm_gen[vis_ids] == vis_gen]] += 1
            m.lm_found[found_ids[m.lm_gen[found_ids] == found_gen]] += 1
        self._stat_buffer.clear()

    # ------------------------------------------------------------------
    def rebind_after_merge(self, new_map: MapState, kf_remap: np.ndarray, lm_map: np.ndarray,
                           S_w2_w1: np.ndarray):
        """Re-express the tracker's state in the welded map's frame and ids
        after an atlas weld (the reference's ``MergeLocal`` updates the
        current frame and the tracker's last-frame pointers the same way,
        ``LoopClosing.cc:1383-1401``). The fused step's device window
        re-syncs on its own: it keys on the map object."""
        self.map = new_map
        S_w1_w2 = lie.np_sim3_inv(np.asarray(S_w2_w1, np.float32))
        s = float(S_w2_w1[7])

        def transport(T):
            return lie.np_sim3_to_se3(lie.np_sim3_mul(lie.np_sim3_from_se3(T), S_w1_w2))

        self.cur_pose = transport(self.cur_pose)
        if self.last_pose is not None:
            self.last_pose = transport(self.last_pose)
        if self.velocity is not None:
            # a relative pose: the rotation stays, the translation rescales
            # (merged-map units are s× active-map units)
            v = self.velocity.copy()
            v[4:7] *= s
            self.velocity = v

        def remap_lms(idx):
            if idx is None:
                return None
            return np.where(idx >= 0, lm_map[np.clip(idx, 0, None)], -1).astype(np.int32)

        self.last_lm_idx = remap_lms(self.last_lm_idx)
        if self.last_lm_idx is not None:
            self.last_lm_gen = new_map.lm_gen[np.clip(self.last_lm_idx, 0, None)].copy()
        self.cur_lm_idx = remap_lms(self.cur_lm_idx)
        self._stat_buffer.clear()        # pre-weld ids are void
        self._ref_tracked_cache = None   # keyed on the old map's version
        if self.ref_kf >= 0:
            self.ref_kf = int(kf_remap[self.ref_kf])
        # metric depth of the last frame rescales with the weld, on its device
        if self.last_feats is not None and s != 1.0:
            d = self.last_feats.depth
            self.last_feats = self.last_feats._replace(depth=torch.where(d > 0, d * s, d))
        self.th_depth_m = self.cam.bf * self.cam.th_depth / self.cam.fx

    def trajectory_world(self) -> np.ndarray:
        """The per-frame relative log resolved into world-frame camera
        poses Twc (F, 7) against the current keyframe poses."""
        if not self.traj_rel:
            return np.zeros((0, 7), np.float32)
        ref_poses = np.stack([self.map.effective_kf_pose(int(rk)) for rk in self.traj_ref_kf])
        return lie.np_se3_inv(lie.np_se3_mul(np.stack(self.traj_rel), ref_poses))
