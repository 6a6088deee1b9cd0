"""Atlas: multi-map container for elastic recovery (counterpart of
``orb_slam3_rgbl_tpu.slam.atlas``; reference ``include/Atlas.h``).

On hard tracking loss with an established map, the active map is archived
and a fresh one started (``Tracking::CreateMapInAtlas``); each archived
map keeps the trajectory segment logged while it was active, so its
poses resolve against its own keyframes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from orb_slam3_rgbl_tpu_torch.config import SlamConfig
from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState


@dataclasses.dataclass(eq=False)  # identity equality: fields hold arrays
class AtlasEntry:
    map: MapState
    # keyframe database of this map (set by the loop-closing plane; kept
    # for merge detection and grown by a weld)
    db: object = None
    # trajectory log segments recorded while this map was active
    traj_rel: list = dataclasses.field(default_factory=list)
    traj_ref_kf: list = dataclasses.field(default_factory=list)
    traj_time: list = dataclasses.field(default_factory=list)
    traj_lost: list = dataclasses.field(default_factory=list)


class Atlas:
    def __init__(self, config: SlamConfig, n_features: int):
        self.cfg = config
        self.n_features = n_features
        self.entries: List[AtlasEntry] = []
        self.active_idx: int = -1
        self._next_map_id = 0

    @property
    def active(self) -> Optional[MapState]:
        return self.entries[self.active_idx].map if self.active_idx >= 0 else None

    def create_new_map(self) -> MapState:
        """``Atlas::CreateNewMap`` — archive current, start fresh."""
        m = MapState.create(self.cfg.max_keyframes, self.cfg.max_map_points,
                            self.n_features, map_id=self._next_map_id)
        self._next_map_id += 1
        self.entries.append(AtlasEntry(map=m))
        self.active_idx = len(self.entries) - 1
        return m

    def archive_trajectory(self, tracker):
        """Stash the active tracker's trajectory segment with its map so
        poses resolve against the correct (possibly corrected) keyframes."""
        e = self.entries[self.active_idx]
        e.traj_rel = list(tracker.traj_rel)
        e.traj_ref_kf = list(tracker.traj_ref_kf)
        e.traj_time = list(tracker.traj_time)
        e.traj_lost = list(tracker.traj_lost)

    def n_maps(self) -> int:
        return len(self.entries)

    def remove_bad_maps(self, min_kf: int = 3):
        """``Atlas::RemoveBadMaps``: drop archived maps that never grew."""
        keep = [e for i, e in enumerate(self.entries)
                if i == self.active_idx or e.map.n_kf >= min_kf]
        active_entry = self.entries[self.active_idx]
        self.entries = keep
        self.active_idx = self.entries.index(active_entry)
