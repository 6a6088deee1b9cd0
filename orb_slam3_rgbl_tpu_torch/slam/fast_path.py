"""Device-resident state of the fused tracking step (counterpart of
``orb_slam3_rgbl_tpu.slam.fast_path``).

``FastPath`` owns what stays on the card between frames — the previous
frame's features and bound landmark positions, and the local-map landmark
window (the reference keyframe's covisibility neighbourhood) — refreshed
from the host map only when ``MapState.version`` moves. ``advance`` rolls
the state forward from a step's outputs without leaving the device. While a
mapping worker mutates the map, ``hold`` keeps ``sync`` serving the last
consistent window of that map.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch.config import SlamConfig
from orb_slam3_rgbl_tpu_torch.device import resolve
from orb_slam3_rgbl_tpu_torch.slam import compiled
from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState

LOCAL_KF_CAP = 80  # reference caps local keyframes at 80 (Tracking.cc:3543)


def _u32_to_i32(a: np.ndarray) -> np.ndarray:
    """uint32 descriptor words → int32 with the same bits (the port's layout)."""
    return np.ascontiguousarray(a, np.uint32).view(np.int32)


class FastPath:
    """Owns the tracking step + device-resident inter-frame state."""

    def __init__(self, cfg: SlamConfig, n_feat: int, window_cap: int = 8192,
                 mode: str = "rgbl", device=None):
        self.cfg = cfg
        self.n_feat = n_feat
        self.window_cap = window_cap
        self.mode = mode
        self.device = dev = resolve(device)
        self.step = compiled.make_track_step(cfg, window_cap=window_cap, mode=mode,
                                             device=dev)
        self._sync_key = None
        # set by the mapping worker around each job: the map is mid-mutation
        self.hold = False
        # host id maps for the device windows; generations snapshot the
        # landmark slots at sync time (slot-recycling detection)
        self.win_ids = np.zeros(0, np.int64)
        self.win_gen = np.zeros(0, np.int32)
        self.prev_lm_ids: Optional[np.ndarray] = None
        self.prev_lm_gen: Optional[np.ndarray] = None
        f32, i32 = torch.float32, torch.int32
        self.win_pos = torch.zeros((window_cap, 3), dtype=f32, device=dev)
        self.win_desc = torch.zeros((window_cap, 8), dtype=i32, device=dev)
        self.win_maxdist = torch.ones((window_cap,), dtype=f32, device=dev)
        self.win_valid = torch.zeros((window_cap,), dtype=torch.bool, device=dev)
        self.prev_uv = torch.zeros((n_feat, 2), dtype=f32, device=dev)
        self.prev_desc = torch.zeros((n_feat, 8), dtype=i32, device=dev)
        self.prev_oct = torch.zeros((n_feat,), dtype=i32, device=dev)
        self.prev_angle = torch.zeros((n_feat,), dtype=f32, device=dev)
        self.prev_Xw = torch.zeros((n_feat, 3), dtype=f32, device=dev)
        self.prev_bound = torch.zeros((n_feat,), dtype=torch.bool, device=dev)

    def _dev(self, a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def sync(self, m: MapState, ref_kf: int, last_feats, last_lm_idx: np.ndarray,
             last_lm_gen: Optional[np.ndarray] = None):
        """Refresh window + previous-frame device state iff the map or its
        version moved (≈ once per keyframe / mapping event, and on every
        new atlas map). The key holds the map itself, so a new map can
        never pass for the old one. Under ``hold`` a window already synced
        on ``m`` is kept as it is (the reference's tracker likewise reads
        the map while the mapping thread works)."""
        if self._sync_key is not None and self._sync_key[0] is m \
                and (self.hold or self._sync_key[1] == m.version):
            return
        # --- window: landmarks of the ref-KF covisibility neighbourhood ---
        kfs = [ref_kf] + [int(k) for k in m.best_covisible(ref_kf, LOCAL_KF_CAP, min_weight=1)]
        tbl = m.kf_lm_idx[kfs]
        ids = np.unique(tbl[tbl >= 0])
        ids = ids[m.lm_valid[ids]][: self.window_cap]
        LW, n = self.window_cap, ids.size
        pos = np.zeros((LW, 3), np.float32)
        desc = np.zeros((LW, 8), np.uint32)
        maxd = np.ones(LW, np.float32)
        valid = np.zeros(LW, bool)
        pos[:n] = m.lm_pos[ids]
        desc[:n] = m.lm_desc[ids]
        maxd[:n] = m.lm_max_dist[ids]
        valid[:n] = True
        self.win_ids = ids
        self.win_gen = m.lm_gen[ids].copy()
        self.win_pos = self._dev(pos, torch.float32)
        self.win_desc = self._dev(_u32_to_i32(desc), torch.int32)
        self.win_maxdist = self._dev(maxd, torch.float32)
        self.win_valid = self._dev(valid, torch.bool)

        # --- previous frame: rebind to current landmark state ------------
        lm = np.asarray(last_lm_idx)
        safe = np.clip(lm, 0, None)
        bound = (lm >= 0) & m.lm_valid[safe]
        if last_lm_gen is not None:
            bound &= m.lm_gen[safe] == last_lm_gen
        Xw = np.zeros((self.n_feat, 3), np.float32)
        Xw[bound] = m.lm_pos[lm[bound]]
        # last_feats are the step's device tensors: as_tensor keeps them there
        self.prev_uv = self._dev(last_feats.uv, torch.float32)
        self.prev_desc = self._dev(last_feats.desc, torch.int32)
        self.prev_oct = self._dev(last_feats.octave, torch.int32)
        self.prev_angle = self._dev(last_feats.angle, torch.float32)
        self.prev_Xw = self._dev(Xw, torch.float32)
        self.prev_bound = self._dev(bound, torch.bool)
        self.prev_lm_ids = np.where(bound, lm, -1).astype(np.int32)
        self.prev_lm_gen = m.lm_gen[safe].copy()
        self._sync_key = (m, m.version)

    # ------------------------------------------------------------------
    def run(self, img, points, cloud_valid, Tcw_pred: np.ndarray) -> compiled.TrackStepOut:
        return self.step(
            self._dev(img, torch.float32), self._dev(points, torch.float32),
            self._dev(cloud_valid, torch.bool), self._dev(Tcw_pred, torch.float32),
            self.prev_uv, self.prev_desc, self.prev_oct, self.prev_angle,
            self.prev_Xw, self.prev_bound,
            self.win_pos, self.win_desc, self.win_maxdist, self.win_valid)

    def advance(self, out: compiled.TrackStepOut, cur_lm_idx: np.ndarray,
                cur_lm_gen: Optional[np.ndarray] = None):
        """Roll the device inter-frame state forward after an accepted
        step (no host↔device transfer — the outputs stay on the card)."""
        self.prev_uv = out.feats.uv
        self.prev_desc = out.feats.desc
        self.prev_oct = out.feats.octave
        self.prev_angle = out.feats.angle
        self.prev_Xw = out.next_Xw
        self.prev_bound = out.next_bound
        self.prev_lm_ids = cur_lm_idx
        if cur_lm_gen is not None:
            self.prev_lm_gen = cur_lm_gen
