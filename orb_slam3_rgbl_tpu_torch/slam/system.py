"""System facade, the port's public entry point (counterpart of
``orb_slam3_rgbl_tpu.slam.system``; reference ``System.cc``).

Ported: ``System(cfg).track_rgbl`` with the default configuration (local
mapping on, loop closing on) — the fused steady-state loop and the classic
ladder, the atlas's new-map recovery after a lost streak or a backward
timestamp, trajectory export, and the two synchronous planes behind every
frame that created a keyframe: the mapping job of
``LocalMapper.process_keyframe`` (landmark culling, triangulation, fusion,
local BA, keyframe culling), then ``LoopCloser.on_keyframe`` (the keyframe
is indexed in the database, loop candidates are detected and verified by
Sim3, a verified loop is corrected — fusion, essential graph, landmark
re-anchoring — and a 16-iteration global BA follows). A keyframe that
closed no loop is looked up in the databases of the archived atlas maps;
a verified match welds the active map into the archived one
(``slam.merging``, ``_do_merge``: the trajectory, the database, the tracker
and both planes move to the welded map, and a weld-window local BA
follows). A lost tracker relocalizes against the keyframe database.
``cfg.vocab_path`` swaps the database's LSH words for a trained tree
vocabulary. ``track_features`` feeds extracted features straight to the
ladder.

With ``enable_mapping=False`` keyframes still mint landmarks from LiDAR
depth, so a drive tracks over any distance, but nothing is culled or
refined; with ``loop_closing=False`` there is no database, so
relocalization fails at once and no map is ever welded.

The other sensors and the asynchronous workers (``async_mapping = True``)
raise ``NotImplementedError`` naming the ROADMAP Queue 1 item that ports
them.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from orb_slam3_rgbl_tpu_torch.config import RGBL, SlamConfig
from orb_slam3_rgbl_tpu_torch.device import resolve
from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.io import trajectory as traj_io
from orb_slam3_rgbl_tpu_torch.ops import fast as fast_ops
from orb_slam3_rgbl_tpu_torch.slam import compiled, merging
from orb_slam3_rgbl_tpu_torch.slam import tracking as trk
from orb_slam3_rgbl_tpu_torch.slam.atlas import Atlas
from orb_slam3_rgbl_tpu_torch.slam.fast_path import FastPath
from orb_slam3_rgbl_tpu_torch.slam.local_mapping import LocalMapper
from orb_slam3_rgbl_tpu_torch.slam.loop_closing import LoopCloser
from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState
from orb_slam3_rgbl_tpu_torch.slam.tracking import Tracker, TrackResult

log = logging.getLogger(__name__)

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
        if config.inertial:
            raise NotImplementedError(
                "inertial sensors are not ported yet (ROADMAP Queue 1 item 15)")
        if config.sensor != RGBL:
            raise NotImplementedError(
                f"sensor {config.sensor} is not ported yet, only RGBL "
                "(ROADMAP Queue 1 items 14 and 17)")
        if config.camera_type == "PinHole" and config.camera.has_distortion:
            raise NotImplementedError(
                "keypoint undistortion for a distorted PinHole camera is not ported yet "
                "(ROADMAP Queue 1 item 17)")
        self.cfg = config
        self.cam = config.camera
        self.device = resolve(device)
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
        self._lost_streak = 0
        self._fast: Optional[FastPath] = None   # shared across atlas maps
        self.use_fused = True       # the fused steady-state loop
        self.P_lidar = compiled.lidar_projection(config, self.device)
        self._cloud_mask_ones = None

    @property
    def async_mapping(self) -> bool:
        """Whether the mapping job runs on a worker thread beside tracking.
        Only the synchronous plane (False, the JAX package's default) is
        ported."""
        return False

    @async_mapping.setter
    def async_mapping(self, value: bool):
        if value:
            raise NotImplementedError(
                "the asynchronous mapping worker is not ported yet (ROADMAP Queue 1 item 18); "
                "the mapping job runs synchronously after each keyframe")

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
        """Input-stream sanity (``Tracking::Track`` head): a BACKWARD
        timestamp means the stream restarted — start a new map."""
        if self.tracker is None or not self.tracker.traj_time:
            return
        if timestamp < self.tracker.traj_time[-1]:
            log.error("frame timestamp older than previous frame — starting a new map")
            self._create_map_in_atlas()

    def _create_map_in_atlas(self):
        """Archive the active map and start tracking in a fresh one
        (``Tracking::CreateMapInAtlas``); a map of fewer than two
        keyframes is discarded."""
        n_feat = self.tracker.n_feat or self._frame_capacity()
        if self.map.n_kf >= 2:
            self.atlas.archive_trajectory(self.tracker)
        else:
            self.atlas.entries.pop(self.atlas.active_idx)
        self._spawn_components(n_feat)

    def track_rgbl(self, gray, pointcloud, timestamp: float, cloud_mask=None) -> TrackResult:
        """Gray image (H, W) + raw LiDAR cloud (N, 3|4) → ``TrackResult``
        (``System::TrackRGBL``). Numpy arrays or tensors; a cloud already
        on the device at (CLOUD_CAP, 4) is used in place.

        Steady-state frames run the fused step; with ``use_fused`` off
        every frame takes the classic ladder on the raw cloud."""
        self._check_timestamp_jump(timestamp)
        if self.use_fused:
            if self.map is None:
                self._spawn_components(self._frame_capacity())
            if self._fast is None:
                self._fast = FastPath(self.cfg, self._frame_capacity(), device=self.device)
                self.tracker.fast = self._fast
            img = torch.as_tensor(gray, dtype=torch.float32, device=self.device)
            pts, mask = self._pad_cloud(pointcloud, cloud_mask)
            return self._post_track(self.tracker.track_image_rgbl(img, pts, mask, timestamp))
        feats = compiled.attach_lidar(
            self.cfg, self._extract(gray),
            torch.as_tensor(pointcloud, dtype=torch.float32, device=self.device), self.P_lidar,
            None if cloud_mask is None
            else torch.as_tensor(cloud_mask, dtype=torch.bool, device=self.device))
        return self._track(feats, timestamp)

    def track_features(self, feats, timestamp: float) -> TrackResult:
        """Feature-level entry point: extracted ``FrameFeatures`` on the
        system's device go straight to the classic ladder (testing, or
        replaying features without images)."""
        return self._track(feats, timestamp)

    # ------------------------------------------------------------------
    def _spawn_components(self, n_feat: int):
        """A new active map and its tracker. Frame ids continue across
        maps; the shared ``FastPath`` re-syncs on the new map."""
        if self.atlas is None:
            self.atlas = Atlas(self.cfg, n_feat)
        next_frame = self.tracker.frame_id + 1 if self.tracker is not None else 0
        self.map = self.atlas.create_new_map()
        self.tracker = Tracker(self.cfg, self.map, start_frame_id=next_frame, device=self.device)
        self.mapper = (LocalMapper(self.cfg, self.map, device=self.device)
                       if self._enable_mapping else None)
        if self.mapper is not None:
            self.tracker.kf_feats_hook = self.mapper.dev_cache.add
        # the synchronous plane has no queue and no job in flight, so the
        # tracker's busy, in-flight, pre-keyframe and lock hooks stay unset
        # and the mapper's backlog is 0
        self.tracker.join_mapping_fn = self._join_mapping
        self.tracker.fast = self._fast
        self.loop_closer = None
        if self.cfg.loop_closing:
            self.loop_closer = LoopCloser(
                self.cfg, self.map, device=self.device, generator=self._loop_rng,
                dev_cache=self.mapper.dev_cache if self.mapper is not None else None)
            self.loop_closer.gba_dispatch = self._dispatch_gba
            self.tracker.kf_db = self.loop_closer.db
            self.tracker.reloc_generator = self._reloc_rng
            # the entry keeps its database alive for later merge detection
            self.atlas.entries[self.atlas.active_idx].db = self.loop_closer.db
        self._lost_streak = 0

    def _join_mapping(self):
        """Drain the mapping plane before a structural operation. The
        synchronous plane has finished its job before the frame returns:
        only the tracker's deferred statistics are left to land."""
        if self.tracker is not None:
            self.tracker.flush_stat_buffer()

    def _mapping_job(self, kf_id: int):
        """The synchronous job behind a new keyframe: local mapping, then
        loop detection and correction inline; a keyframe that closed no
        loop is tried against the other atlas maps."""
        if self.mapper is not None and self.map.n_kf > 1:
            self.mapper.process_keyframe(kf_id)
        if self.loop_closer is None:
            return
        if self.loop_closer.on_keyframe(kf_id) is None:
            self._try_merge(kf_id)

    def _dispatch_gba(self):
        """The global BA after a loop correction, on the calling thread
        (the abortable job of the asynchronous plane is not ported). 16 LM
        iterations: a loop-bent map needs about that many to unbend."""
        self.loop_closer._global_ba(GBA_ITERATIONS)

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
                with record_function("merge.verify"):
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
        active atlas entry, then a local BA around the weld."""
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

        # weld-window bundle adjustment (LoopClosing.cc:1623-1627)
        if self.mapper is not None:
            with record_function("merge.ba"):
                res.map.update_landmark_stats(np.array([res.kf_cur_new]))
                self.mapper.local_bundle_adjustment(res.kf_cur_new)
        log.info("merge: welded map %d into map %d (%d keyframes transported, scale %.4f)",
                 active_map_id, old.map_id, len(res.appended_kfs), s)

    def _dispatch_mapping(self, kf_id: int):
        self._mapping_job(kf_id)

    def _track(self, feats, timestamp) -> TrackResult:
        if self.map is None:
            self._spawn_components(int(feats.uv.shape[0]))
        return self._post_track(self.tracker.track(feats, timestamp))

    def _post_track(self, res: TrackResult) -> TrackResult:
        """After the tracking stage: the mapping job of the frame's last
        new keyframe, then elastic recovery — a LOST streak longer than
        ``fps`` frames archives the map (or discards it, under two
        keyframes) and starts a new one (Tracking.cc:2032-2058)."""
        if self.tracker.new_kf_ids:
            self._dispatch_mapping(self.tracker.new_kf_ids[-1])
        if res.state == trk.LOST:
            self._lost_streak += 1
        elif res.state == trk.OK:
            self._lost_streak = 0
        if self._lost_streak > int(self.cfg.fps):
            n_feat = self.tracker.n_feat or self._frame_capacity()
            if self.map.n_kf >= 2:
                self.atlas.archive_trajectory(self.tracker)
            else:
                self.atlas.entries.pop(self.atlas.active_idx)
            self._spawn_components(n_feat)
        return res

    # ------------------------------------------------------------------
    def shutdown(self):
        """``System::Shutdown``: drain the mapping plane (the synchronous
        plane has no worker to stop)."""
        self._join_mapping()

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
        atlas maps (``SaveTrajectoryKITTI`` semantics)."""
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

    def reset(self):
        """Full reset (``System::Reset``): drop the whole atlas; fresh
        components materialize on the next frame."""
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
        n_feat = self.map.n_features
        self.atlas.entries.pop(self.atlas.active_idx)
        self._spawn_components(n_feat)
