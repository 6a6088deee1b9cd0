"""Map state on the host (counterpart of the part of
``orb_slam3_rgbl_tpu.slam.map_state`` that tracking, keyframe creation,
``FastPath.sync`` and trajectory export use): fixed-capacity numpy
struct-of-arrays with validity masks, the (K, N) ``kf_lm_idx`` binding
table (landmark id per keyframe feature slot, −1 unbound) and the
``version`` counter that tells the fast path when to refresh its device
window.

Descriptors are kept as the JAX package keeps them, (…, 8) uint32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from orb_slam3_rgbl_tpu_torch.geometry import lie

INVALID = -1


@dataclasses.dataclass
class MapState:
    # --- keyframes ---------------------------------------------------------
    kf_pose: np.ndarray       # (K, 7) Tcw
    kf_valid: np.ndarray      # (K,) bool
    kf_timestamp: np.ndarray  # (K,) f64
    kf_frame_id: np.ndarray   # (K,) i64 — source frame index
    kf_uv: np.ndarray         # (K, N, 2) f32
    kf_octave: np.ndarray     # (K, N) i16
    kf_desc: np.ndarray       # (K, N, 8) u32
    kf_depth: np.ndarray      # (K, N) f32 (−1 unknown)
    kf_ur: np.ndarray         # (K, N) f32 pseudo-stereo (−1 mono)
    kf_feat_valid: np.ndarray  # (K, N) bool
    kf_lm_idx: np.ndarray     # (K, N) i32 → landmark id or −1
    kf_angle: np.ndarray      # (K, N) f32 keypoint orientation (radians)
    # --- landmarks ---------------------------------------------------------
    lm_pos: np.ndarray        # (M, 3) f32 world
    lm_valid: np.ndarray      # (M,) bool
    lm_desc: np.ndarray       # (M, 8) u32 distinctive descriptor
    lm_normal: np.ndarray     # (M, 3) f32 mean viewing direction
    lm_max_dist: np.ndarray   # (M,) f32 scale-invariance band
    lm_min_dist: np.ndarray   # (M,)
    lm_ref_kf: np.ndarray     # (M,) i32 creating keyframe
    lm_first_kf: np.ndarray   # (M,) i32 first observing keyframe
    lm_visible: np.ndarray    # (M,) i32 — times predicted visible
    lm_found: np.ndarray      # (M,) i32 — times actually matched
    lm_gen: np.ndarray        # (M,) i32 slot generation (bumped on free)
    # --- counters ----------------------------------------------------------
    n_kf: int = 0
    n_lm: int = 0             # landmark high-water mark (slots ever used)
    version: int = 0
    map_id: int = 0           # Atlas multi-map id this state belongs to
    lm_free: list = dataclasses.field(default_factory=list)  # recycled slots (LIFO)
    # culled keyframe → (parent id, T_culled_parent at cull time), the
    # spanning-tree-parent analog that trajectory export walks (keyframe
    # culling belongs to the mapping plane; nothing fills it yet)
    kf_redirect: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def create(max_kf: int, max_lm: int, n_feat: int, map_id: int = 0) -> "MapState":
        K, M, N = max_kf, max_lm, n_feat
        return MapState(
            kf_pose=np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (K, 1)),
            kf_valid=np.zeros(K, bool),
            kf_timestamp=np.zeros(K, np.float64),
            kf_frame_id=np.zeros(K, np.int64),
            kf_uv=np.zeros((K, N, 2), np.float32),
            kf_octave=np.zeros((K, N), np.int16),
            kf_desc=np.zeros((K, N, 8), np.uint32),
            kf_depth=np.full((K, N), -1.0, np.float32),
            kf_ur=np.full((K, N), -1.0, np.float32),
            kf_feat_valid=np.zeros((K, N), bool),
            kf_lm_idx=np.full((K, N), INVALID, np.int32),
            kf_angle=np.zeros((K, N), np.float32),
            lm_pos=np.zeros((M, 3), np.float32),
            lm_valid=np.zeros(M, bool),
            lm_desc=np.zeros((M, 8), np.uint32),
            lm_normal=np.zeros((M, 3), np.float32),
            lm_max_dist=np.zeros(M, np.float32),
            lm_min_dist=np.zeros(M, np.float32),
            lm_ref_kf=np.full(M, INVALID, np.int32),
            lm_first_kf=np.full(M, INVALID, np.int32),
            lm_visible=np.ones(M, np.int32),
            lm_found=np.ones(M, np.int32),
            lm_gen=np.zeros(M, np.int32),
            map_id=map_id,
        )

    @property
    def capacity_kf(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def capacity_lm(self) -> int:
        return self.lm_pos.shape[0]

    @property
    def n_features(self) -> int:
        return self.kf_uv.shape[1]

    def valid_kf_ids(self) -> np.ndarray:
        return np.nonzero(self.kf_valid)[0]

    # --- keyframe insertion -------------------------------------------------
    def add_keyframe(self, pose, uv, octave, desc, depth, ur, feat_valid, lm_idx,
                     timestamp: float, frame_id: int, angle=None) -> int:
        k = self.n_kf
        if k >= self.capacity_kf:
            raise RuntimeError("keyframe capacity exhausted")
        lm_idx = np.asarray(lm_idx, np.int32)
        lm_idx = np.where((lm_idx >= 0) & self.lm_valid[np.clip(lm_idx, 0, None)],
                          lm_idx, INVALID)
        self.kf_pose[k] = pose
        if angle is not None:
            self.kf_angle[k] = angle
        self.kf_valid[k] = True
        self.kf_timestamp[k] = timestamp
        self.kf_frame_id[k] = frame_id
        self.kf_uv[k] = uv
        self.kf_octave[k] = octave
        self.kf_desc[k] = desc
        self.kf_depth[k] = depth
        self.kf_ur[k] = ur
        self.kf_feat_valid[k] = feat_valid
        self.kf_lm_idx[k] = lm_idx
        self.n_kf += 1
        self.version += 1
        return k

    # --- landmark insertion -------------------------------------------------
    def _grow_landmarks(self, need: int):
        """Double landmark capacity until ``need`` fresh slots fit."""
        cap = new_cap = self.capacity_lm
        while self.n_lm + need > new_cap:
            new_cap *= 2
        grow = new_cap - cap

        def pad(a, fill=0):
            return np.concatenate([a, np.full((grow,) + a.shape[1:], fill, a.dtype)])

        self.lm_pos = pad(self.lm_pos)
        self.lm_valid = pad(self.lm_valid, False)
        self.lm_desc = pad(self.lm_desc)
        self.lm_normal = pad(self.lm_normal)
        self.lm_max_dist = pad(self.lm_max_dist)
        self.lm_min_dist = pad(self.lm_min_dist)
        self.lm_ref_kf = pad(self.lm_ref_kf, INVALID)
        self.lm_first_kf = pad(self.lm_first_kf, INVALID)
        self.lm_visible = pad(self.lm_visible, 1)
        self.lm_found = pad(self.lm_found, 1)
        self.lm_gen = pad(self.lm_gen)

    def refresh_free_list(self):
        """Rebuild the recycled-slot stack from validity (after load/merge)."""
        self.lm_free = [int(i) for i in np.nonzero(~self.lm_valid[: self.n_lm])[0][::-1]]

    def add_landmarks(self, pos: np.ndarray, desc: np.ndarray, kf_id: int,
                      feat_idx: np.ndarray, normal: np.ndarray,
                      max_dist: np.ndarray, min_dist: np.ndarray) -> np.ndarray:
        """Batch-create landmarks observed by (kf_id, feat_idx): recycled
        slots first, then fresh ones, growing capacity on demand. Returns
        their ids."""
        n = pos.shape[0]
        n_reuse = min(len(self.lm_free), n)
        reuse = [self.lm_free.pop() for _ in range(n_reuse)]
        fresh = n - n_reuse
        if fresh and self.n_lm + fresh > self.capacity_lm:
            self._grow_landmarks(fresh)
        ids = np.asarray(reuse + list(range(self.n_lm, self.n_lm + fresh)), np.int32)
        self.n_lm += fresh
        self.lm_pos[ids] = pos
        self.lm_valid[ids] = True
        self.lm_desc[ids] = desc
        self.lm_normal[ids] = normal
        self.lm_max_dist[ids] = max_dist
        self.lm_min_dist[ids] = min_dist
        self.lm_ref_kf[ids] = kf_id
        self.lm_first_kf[ids] = kf_id
        self.lm_visible[ids] = 1
        self.lm_found[ids] = 1
        self.kf_lm_idx[kf_id, feat_idx] = ids
        self.version += 1
        return ids

    # --- covisibility -------------------------------------------------------
    def covisibility_weights(self, kf_id: int) -> np.ndarray:
        """Shared-landmark counts between kf_id and every other keyframe
        (reference ``KeyFrame::UpdateConnections``)."""
        w = np.zeros(self.capacity_kf, np.int32)
        lms = self.kf_lm_idx[kf_id]
        lms = lms[lms >= 0]
        if lms.size == 0:
            return w
        mask = np.zeros(self.capacity_lm, bool)
        mask[lms] = True
        valid = self.valid_kf_ids()
        tbl = self.kf_lm_idx[valid]
        shared = (mask[np.clip(tbl, 0, self.capacity_lm - 1)] & (tbl >= 0)).sum(axis=1)
        w[valid] = shared.astype(np.int32)
        w[kf_id] = 0
        return w

    def best_covisible(self, kf_id: int, n: int, min_weight: int = 15) -> np.ndarray:
        w = self.covisibility_weights(kf_id)
        out = np.argsort(-w)[:n]
        return out[w[out] >= min_weight]

    # --- landmark observations / trajectory anchors --------------------------
    def observation_counts(self, lm_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Number of keyframes observing each landmark (scan of the binding
        table over valid keyframes)."""
        idx = self.kf_lm_idx[self.kf_valid]
        counts = np.bincount(idx[idx >= 0], minlength=self.capacity_lm)
        return counts if lm_ids is None else counts[lm_ids]

    def live_ref_kf(self, k: int) -> int:
        """Walk cull redirects until a valid keyframe (the reference's
        ``while(pKF->isBad()) pKF = pKF->GetParent()``)."""
        seen = 0
        while not self.kf_valid[k] and seen < 64:
            entry = self.kf_redirect.get(int(k))
            if entry is None:
                break
            k = entry[0]
            seen += 1
        return int(k)

    def effective_kf_pose(self, k: int) -> np.ndarray:
        """Tcw of keyframe ``k``, composing cull redirects so a culled
        keyframe inherits every later correction of its parent."""
        T_acc = None
        seen = 0
        while not self.kf_valid[k] and seen < 64:
            entry = self.kf_redirect.get(int(k))
            if entry is None:
                break
            p, T_kp = entry
            T_acc = T_kp if T_acc is None else lie.np_se3_mul(T_acc, T_kp)
            k = p
            seen += 1
        pose = self.kf_pose[k]
        return pose if T_acc is None else lie.np_se3_mul(T_acc, pose)
