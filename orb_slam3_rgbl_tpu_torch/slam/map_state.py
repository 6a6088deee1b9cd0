"""Map state on the host (counterpart of
``orb_slam3_rgbl_tpu.slam.map_state`` without its inertial state and
``apply_scaled_rotation``, which wait for the inertial slice):
numpy struct-of-arrays whose capacity grows on demand (landmarks double,
keyframes grow to what an atlas weld needs), with validity masks, the (K, N)
``kf_lm_idx`` binding table (landmark id per keyframe feature slot, −1
unbound) and the ``version`` counter that tells the fast path when to
refresh its device window. Tracking, keyframe creation, the mapping
plane's culling, fusion and observation tables, and trajectory export all
work on it; the tie rules (stable sorts, ``np.unique``'s first index,
even-stride decimation) are the JAX package's.

Descriptors are kept as the JAX package keeps them, (…, 8) uint32.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Tuple

import numpy as np

from orb_slam3_rgbl_tpu_torch.geometry import lie

INVALID = -1

# byte → popcount lookup (vectorized Hamming for the host-side
# distinctive-descriptor update)
_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


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
    # slot-allocator lock around n_kf/n_lm/lm_free/lm_valid bookkeeping:
    # keyframe creation and the mapping plane's culling both touch them
    # (uncontended while the mapping plane runs synchronously)
    alloc_lock: object = dataclasses.field(default_factory=threading.RLock)
    # culled keyframe → (parent id, T_culled_parent at cull time), the
    # spanning-tree-parent analog that trajectory export walks;
    # ``remove_keyframe`` fills it
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
        with self.alloc_lock:
            return self._add_keyframe_locked(pose, uv, octave, desc, depth, ur, feat_valid,
                                             lm_idx, timestamp, frame_id, angle)

    def _add_keyframe_locked(self, pose, uv, octave, desc, depth, ur, feat_valid, lm_idx,
                             timestamp, frame_id, angle):
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

    def _grow_keyframes(self, capacity: int):
        """Extend the keyframe arrays to ``capacity`` rows with empty
        keyframes (identity poses, unknown depths, no bindings), the
        keyframe half of the JAX package's ``merging._grow_map``."""
        grow = capacity - self.capacity_kf
        if grow <= 0:
            return

        def pad(a, fill=0):
            return np.concatenate([a, np.full((grow,) + a.shape[1:], fill, a.dtype)])

        self.kf_pose = pad(self.kf_pose)
        self.kf_pose[-grow:, 0] = 1.0
        self.kf_valid = pad(self.kf_valid, False)
        self.kf_timestamp = pad(self.kf_timestamp)
        self.kf_frame_id = pad(self.kf_frame_id)
        self.kf_uv = pad(self.kf_uv)
        self.kf_octave = pad(self.kf_octave)
        self.kf_desc = pad(self.kf_desc)
        self.kf_depth = pad(self.kf_depth, -1.0)
        self.kf_ur = pad(self.kf_ur, -1.0)
        self.kf_feat_valid = pad(self.kf_feat_valid, False)
        self.kf_lm_idx = pad(self.kf_lm_idx, INVALID)
        self.kf_angle = pad(self.kf_angle)

    def refresh_free_list(self):
        """Rebuild the recycled-slot stack from validity (after load/merge)."""
        self.lm_free = [int(i) for i in np.nonzero(~self.lm_valid[: self.n_lm])[0][::-1]]

    def add_landmarks(self, pos: np.ndarray, desc: np.ndarray, kf_id: int,
                      feat_idx: np.ndarray, normal: np.ndarray,
                      max_dist: np.ndarray, min_dist: np.ndarray) -> np.ndarray:
        """Batch-create landmarks observed by (kf_id, feat_idx): recycled
        slots first, then fresh ones, growing capacity on demand. Returns
        their ids."""
        with self.alloc_lock:
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

    def covisibility_matrix(self, max_obs: int = 12):
        """Full pairwise covisibility weights over live keyframes.

        Returns (valid_kf_ids (K,), W (K, K) int32). Counts shared
        landmarks between every keyframe pair (``KeyFrame::
        UpdateConnections`` weights) from the landmark-major observation
        table; observations are capped at ``max_obs`` per landmark, which
        mildly undercounts weights in very dense covisibility (only the
        first ``max_obs`` observers of a landmark pair up) — fine for the
        weight≥100 essential-graph gate this feeds (Optimizer.cc:1545)."""
        valid = self.valid_kf_ids()
        tbl = self.kf_lm_idx[valid]
        lm_ids = np.unique(tbl[tbl >= 0])
        K = valid.size
        W = np.zeros((K, K), np.int32)
        if lm_ids.size == 0 or K == 0:
            return valid, W
        obs_kf, _, obs_mask, _, _ = self.gather_observations(valid, lm_ids, max_obs)
        D = obs_kf.shape[1]
        for d1 in range(D):
            s1 = obs_mask[:, d1]
            for d2 in range(d1 + 1, D):
                sel = s1 & obs_mask[:, d2]
                if sel.any():
                    np.add.at(W, (obs_kf[sel, d1], obs_kf[sel, d2]), 1)
        W = W + W.T
        return valid, W

    # --- observation table for BA ------------------------------------------
    def gather_observations(
        self, kf_ids: np.ndarray, lm_ids: np.ndarray, max_obs: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Build the landmark-major (M, D) observation table for BAProblem.

        Args:
          kf_ids: (Kw,) keyframes in the window (local index = position).
          lm_ids: (Mw,) landmark ids.
          max_obs: D — cap of observations per landmark inside the window.

        Returns (obs_kf_local (Mw, D), obs_feat (Mw, D), obs_mask,
        obs_uv (Mw, D, 2), obs_ur (Mw, D)). A landmark with more than D
        observations keeps an EVENLY-STRIDED sample of its observer list
        (keep-first-D starves the later window keyframes of constraints);
        the dropped count is recorded in ``self.last_dropped_obs`` so
        callers can log it (no silent caps).
        """
        Kw, Mw, D = len(kf_ids), len(lm_ids), max_obs
        self.last_dropped_obs = 0
        lm_slot = np.full(self.capacity_lm + 1, -1, np.int64)
        lm_slot[lm_ids] = np.arange(Mw)

        obs_kf = np.zeros((Mw, D), np.int32)
        obs_feat = np.zeros((Mw, D), np.int32)
        obs_mask = np.zeros((Mw, D), bool)
        obs_uv = np.zeros((Mw, D, 2), np.float32)
        obs_ur = np.full((Mw, D), -1.0, np.float32)

        # pass 1: total observations per landmark inside the window
        total = np.zeros(Mw, np.int64)
        per_kf = []
        for k in kf_ids:
            rows = self.kf_lm_idx[k]
            feat_idx = np.nonzero(rows >= 0)[0]
            slots = lm_slot[rows[feat_idx]]
            sel = slots >= 0
            feat_idx, slots = feat_idx[sel], slots[sel]
            per_kf.append((feat_idx, slots))
            np.add.at(total, slots, 1)
        self.last_dropped_obs = int(np.maximum(total - D, 0).sum())

        # pass 2: fill with even-stride decimation — arrival j of T total
        # lands at d = j·D//T, kept iff d advanced (exactly min(T, D) kept,
        # spread across the whole observer list)
        arrival = np.zeros(Mw, np.int64)
        T_clip = np.maximum(total, 1)
        for local_k, (feat_idx, slots) in enumerate(per_kf):
            j = arrival[slots]
            T = T_clip[slots]
            d = np.where(T <= D, j, (j * D) // T)
            d_prev = np.where(T <= D, j - 1, ((j - 1) * D) // T)
            keep = (j == 0) | (d != d_prev)
            arrival[slots] = j + 1
            feat_k, slots_k, d_k = feat_idx[keep], slots[keep], d[keep]
            k = kf_ids[local_k]
            obs_kf[slots_k, d_k] = local_k
            obs_feat[slots_k, d_k] = feat_k
            obs_mask[slots_k, d_k] = True
            obs_uv[slots_k, d_k] = self.kf_uv[k, feat_k]
            obs_ur[slots_k, d_k] = self.kf_ur[k, feat_k]
        return obs_kf, obs_feat, obs_mask, obs_uv, obs_ur

    # --- landmark maintenance / trajectory anchors ----------------------------
    def observation_counts(self, lm_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Number of keyframes observing each landmark (scan of the binding
        table over valid keyframes)."""
        idx = self.kf_lm_idx[self.kf_valid]
        counts = np.bincount(idx[idx >= 0], minlength=self.capacity_lm)
        return counts if lm_ids is None else counts[lm_ids]

    def remove_landmarks(self, lm_ids: np.ndarray):
        """SetBadFlag equivalent: unbind everywhere + invalidate; the slot
        goes on the free list with its generation bumped so any consumer
        still holding the old id can detect the recycle."""
        lm_ids = np.unique(np.asarray(lm_ids))
        lm_ids = lm_ids[self.lm_valid[lm_ids]]
        if len(lm_ids) == 0:
            return
        with self.alloc_lock:
            self.lm_valid[lm_ids] = False
            self.lm_gen[lm_ids] += 1
            self.lm_free.extend(int(i) for i in lm_ids)
        bad = np.zeros(self.capacity_lm + 1, bool)
        bad[lm_ids] = True
        valid = self.valid_kf_ids()
        tbl = self.kf_lm_idx[valid]
        hit = (tbl >= 0) & bad[np.clip(tbl, 0, self.capacity_lm - 1)]
        tbl[hit] = INVALID
        self.kf_lm_idx[valid] = tbl
        self.version += 1

    def cull_orphans(self, lm_ids: np.ndarray):
        """Remove landmarks from ``lm_ids`` left with ZERO observations
        (the reference never leaves such MapPoints alive: losing the last
        observation triggers ``SetBadFlag``, MapPoint.cc EraseObservation).
        Call after any operation that unbinds observations — LBA outlier
        removal, keyframe culling, binding dedup."""
        lm_ids = np.unique(np.asarray(lm_ids))
        lm_ids = lm_ids[(lm_ids >= 0) & (lm_ids < self.capacity_lm)]
        lm_ids = lm_ids[self.lm_valid[lm_ids]]
        if lm_ids.size == 0:
            return
        counts = self.observation_counts(lm_ids)
        dead = lm_ids[counts == 0]
        if dead.size:
            self.remove_landmarks(dead)

    def remove_keyframe(self, kf_id: int):
        """KeyFrame culling: drop the KF and its bindings (landmarks keep
        other observations; observation counts recompute lazily).

        Before the bindings vanish, the most covisible surviving keyframe
        is recorded as the cull parent (``kf_redirect``) and landmarks
        referencing this KF re-anchor to it — reference
        ``KeyFrame::SetBadFlag`` re-parents children and stores ``mTcp``."""
        w = self.covisibility_weights(kf_id)
        w[kf_id] = 0
        parent = int(np.argmax(w))
        if w[parent] == 0:
            # isolated keyframe: fall back to the nearest surviving id
            live = self.valid_kf_ids()
            live = live[live != kf_id]
            parent = int(live[np.argmin(np.abs(live - kf_id))]) if live.size else kf_id
        if parent != kf_id:
            T_kp = lie.np_se3_mul(self.kf_pose[kf_id],
                                  lie.np_se3_inv(self.kf_pose[parent]))
            self.kf_redirect[int(kf_id)] = (parent, np.asarray(T_kp, np.float32))
            orphans = self.lm_ref_kf == kf_id
            self.lm_ref_kf[orphans] = parent
        mine = self.kf_lm_idx[kf_id]
        mine = mine[mine >= 0]
        self.kf_valid[kf_id] = False
        self.kf_lm_idx[kf_id] = INVALID
        self.kf_feat_valid[kf_id] = False
        # landmarks observed ONLY here are now orphans — cull them (the
        # culling policy lets ≤10% of a redundant KF's points be rare)
        self.cull_orphans(mine)
        self.version += 1

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

    def update_landmark_stats(self, kf_ids: np.ndarray = None,
                              lm_ids: np.ndarray = None):
        """Refresh distinctive descriptors + normals + depth bands for
        landmarks observed by the given keyframes (or the explicit
        ``lm_ids`` subset — fusion passes touch a few dozen landmarks,
        not every landmark of the whole neighborhood).

        Distinctive descriptor = observation whose max Hamming distance to
        the other observations is minimal (reference
        ``MapPoint::ComputeDistinctiveDescriptors`` uses min-median; min-max
        is equivalent in effect and cheaply batchable). Normal = mean of
        unit camera→point rays; band from reference-KF distance and octave
        (``MapPoint::UpdateNormalAndDepth``).
        """
        if lm_ids is not None:
            lm_set = np.unique(np.asarray(lm_ids))
            lm_set = lm_set[(lm_set >= 0) & self.lm_valid[np.clip(lm_set, 0, None)]]
        else:
            lm_set = np.unique(self.kf_lm_idx[kf_ids][self.kf_lm_idx[kf_ids] >= 0])
        if lm_set.size == 0:
            return
        # collect up to 12 observations per landmark
        obs_kf, obs_feat, obs_mask, _, _ = self.gather_observations(
            self.valid_kf_ids(), lm_set, max_obs=12
        )
        kf_global = self.valid_kf_ids()[obs_kf]
        descs = self.kf_desc[kf_global, obs_feat]          # (Mw, D, 8)
        # pairwise hamming via a byte-popcount table
        b = descs.view(np.uint8)                            # (Mw, D, 32)
        x = b[:, :, None, :] ^ b[:, None, :, :]             # (Mw, D, D, 32)
        dist = _POPCNT8[x].sum(-1, dtype=np.int32)          # (Mw, D, D)
        big = 1 << 14
        dist = np.where(obs_mask[:, :, None] & obs_mask[:, None, :], dist, big)
        worst = np.where(obs_mask, dist.max(axis=2), big)
        best_obs = worst.argmin(axis=1)
        rows = np.arange(len(lm_set))
        self.lm_desc[lm_set] = descs[rows, best_obs]

        # normals + distance bands
        cam_centers = lie.np_se3_centers(self.kf_pose[kf_global])  # (Mw, D, 3)
        rays = self.lm_pos[lm_set][:, None, :] - cam_centers
        norms = np.linalg.norm(rays, axis=-1, keepdims=True)
        rays = np.where(norms > 1e-9, rays / norms, 0.0)
        cnt = np.maximum(obs_mask.sum(1, keepdims=True), 1)
        self.lm_normal[lm_set] = (rays * obs_mask[..., None]).sum(1) / cnt

        ref_kf = self.lm_ref_kf[lm_set]
        ref_center = lie.np_se3_centers(self.kf_pose[ref_kf])
        d_ref = np.linalg.norm(self.lm_pos[lm_set] - ref_center, axis=-1)
        # scale band: levelScaleFactor of the observing octave
        # (approximate with octave of the ref observation = first obs)
        oct0 = self.kf_octave[kf_global[rows, 0], obs_feat[rows, 0]]
        sf = 1.2 ** oct0.astype(np.float32)
        self.lm_max_dist[lm_set] = d_ref * sf
        self.lm_min_dist[lm_set] = self.lm_max_dist[lm_set] / (1.2 ** 7)


def dedup_kf_bindings(m: MapState):
    """Enforce one observation per (keyframe, landmark): after a Replace
    remap or projection-fusion binding, a keyframe may reference the same
    landmark at two feature slots (the invariant
    :func:`check_binding_consistency` checks; reference ``Fuse`` guards
    it via ``MapPoint::IsInKeyFrame``). Keeps the first slot per pair."""
    valid_kfs = m.valid_kf_ids()
    if valid_kfs.size == 0:
        return
    tbl = m.kf_lm_idx[valid_kfs]
    order = np.argsort(tbl, axis=1, kind="stable")
    st = np.take_along_axis(tbl, order, 1)
    dup = (st[:, 1:] == st[:, :-1]) & (st[:, 1:] >= 0)
    if dup.any():
        rows, cols = np.nonzero(dup)
        m.kf_lm_idx[valid_kfs[rows], order[rows, cols + 1]] = INVALID
        # unbinding may orphan a landmark whose only observations were
        # duplicate slots — cull it (keeps the zero-obs invariant)
        orphans = np.nonzero(m.lm_valid & (m.observation_counts() == 0))[0]
        if orphans.size:
            m.remove_landmarks(orphans)


def debug_reprojection_error(m: MapState, cam) -> dict:
    """Whole-map reprojection-error statistics (reference
    ``Map::printReprojectionError`` debug utility, ``Map.h:88-97``):
    projects every binding through its keyframe pose and reports the
    pixel-error distribution — the cheapest global map-consistency probe."""
    valid = m.valid_kf_ids()
    errs = []
    for k in valid:
        ids = m.kf_lm_idx[k]
        sel = np.nonzero(ids >= 0)[0]
        if sel.size == 0:
            continue
        T = np.asarray(m.kf_pose[k], np.float32)
        pc = lie.np_quat_rotate(T[:4], m.lm_pos[ids[sel]]) + T[4:7]
        z = np.maximum(pc[:, 2], 1e-6)
        u = cam.fx * pc[:, 0] / z + cam.cx
        v = cam.fy * pc[:, 1] / z + cam.cy
        e = np.hypot(u - m.kf_uv[k, sel, 0], v - m.kf_uv[k, sel, 1])
        errs.append(e[pc[:, 2] > 0])
    if not errs:
        return {"n": 0}
    e = np.concatenate(errs)
    return {"n": int(e.size), "mean_px": float(e.mean()),
            "median_px": float(np.median(e)), "p95_px": float(np.percentile(e, 95))}


def check_binding_consistency(m: MapState) -> list:
    """Structural invariants of the binding table (the array-design
    analog of ``Map::CheckEssentialGraph``): every bound landmark is
    valid, every valid landmark has ≥1 observation in a valid keyframe,
    and no keyframe binds the same landmark twice. Returns a list of
    violation strings (empty = consistent)."""
    faults = []
    valid = m.valid_kf_ids()
    tbl = m.kf_lm_idx[valid]
    bound = tbl[tbl >= 0]
    if bound.size and not m.lm_valid[bound].all():
        n = int((~m.lm_valid[bound]).sum())
        faults.append(f"{n} bindings to invalid landmarks")
    counts = m.observation_counts()
    orphans = int((m.lm_valid & (counts == 0)).sum())
    if orphans:
        faults.append(f"{orphans} valid landmarks with zero observations")
    for i, k in enumerate(valid):
        row = tbl[i]
        row = row[row >= 0]
        if row.size != np.unique(row).size:
            faults.append(f"keyframe {int(k)} binds a landmark twice")
    return faults
