"""Local mapping: per-keyframe map refinement (counterpart of
``orb_slam3_rgbl_tpu.slam.local_mapping``; reference ``LocalMapping.cc``).

A synchronous phase after keyframe insertion:

  ProcessNewKeyFrame → MapPointCulling → CreateNewMapPoints (epipolar
  triangulation) → SearchInNeighbors (fusion) → local BA (Schur) →
  KeyFrameCulling.

The host half (map operations, collision and tie rules) is numpy, as in
the JAX package. The device half is three programs on the mapper's
device: ``_fuse_project_batch``, ``_triangulate_batch`` and
``local_ba.bundle_adjust``, fed from ``DeviceKfCache``, the device mirror
of the keyframes' features; poses and bindings stay on the host. The two
batch programs loop over the real targets / neighbours, one (N, N) table at
a time: no (T, N, N) batch and no padded slots. Each stage of
``process_keyframe`` runs inside a ``torch.profiler.record_function`` span
named ``map.<stage>`` (``MAP_SPANS``).

Inertial configurations add the reference's inertial mapping: once the
map's IMU is initialized, the job's BA is the 15-DoF sliding-window
``local_inertial_bundle_adjustment`` (``optim/inertial_ba.py``: 10
optimizable + 5 fixed states of the temporal chain) and a motion-starved
stretch flags ``bad_imu``; ``maybe_initialize_imu`` (after a keyframe, until
it succeeds) runs the 3-stage IMU initialization and re-expresses the map
gravity-down and metric; ``maybe_viba`` runs ``full_inertial_ba`` 5 s and 15 s
after it (VIBA1, VIBA2); keyframe culling keeps the 21-state window and
relinks the temporal IMU chain around a culled keyframe
(``_relink_imu_chain``). Not ported: ``prewarm``, which exists for XLA's
compile tiers and has nothing to warm here.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from orb_slam3_rgbl_tpu_torch.config import IMU_MONOCULAR, SlamConfig
from orb_slam3_rgbl_tpu_torch.device import StreamOrder, resolve
from orb_slam3_rgbl_tpu_torch.geometry import camera as cam_mod
from orb_slam3_rgbl_tpu_torch.geometry import lie, triangulation
from orb_slam3_rgbl_tpu_torch.geometry.camera import np_geo_project
from orb_slam3_rgbl_tpu_torch.ops import matching
from orb_slam3_rgbl_tpu_torch.imu import preintegration as pre
from orb_slam3_rgbl_tpu_torch.optim import inertial, inertial_ba, local_ba
from orb_slam3_rgbl_tpu_torch.slam import imu_frontend
from orb_slam3_rgbl_tpu_torch.slam.frame import inv_scale_sigma2
from orb_slam3_rgbl_tpu_torch.slam.map_state import (MapState, apply_scaled_rotation,
                                                     dedup_kf_bindings)
from orb_slam3_rgbl_tpu_torch.utils.logging import log
from orb_slam3_rgbl_tpu_torch.utils.profiling import stage

BA_POSES_CAP = 24       # optimized + fixed window sizes
BA_LM_CAP = 8192
BA_OBS_CAP = 8          # D — max obs per landmark inside the window
TRI_CAP = 256           # compacted triangulations downloaded per neighbor
TRI_NEIGHBORS_CAP = 12  # neighbors a keyframe triangulates against
FUSE_TARGETS_CAP = 16   # target keyframes of one fusion pass

MAP_SPANS = ("map.kf_insert", "map.mp_cull", "map.mp_create", "map.loop_fusion", "map.lba",
             "map.kf_cull")
VI_LM_CAP = 4096        # landmarks of one inertial BA (the JAX package's cap)
VI_OBS_CAP = 8          # observations per landmark in it
LOCAL_VIBA_ITERATIONS = 8    # LM iterations of the local inertial BA
FULL_VIBA_ITERATIONS = 10    # and of the full inertial BA (VIBA, the weld)
FULL_VIBA_MAX_STATES = 256   # states of the temporal chain the full inertial BA takes


def _i32_words(desc) -> np.ndarray:
    """uint32 descriptor words → int32 with the same bits (the port's layout)."""
    return np.ascontiguousarray(desc, np.uint32).view(np.int32)


class KfRows(NamedTuple):
    """The feature blocks of ``DeviceKfCache``, as one reader took them."""
    d_uv: torch.Tensor
    d_desc: torch.Tensor
    d_oct: torch.Tensor
    d_angle: torch.Tensor
    d_valid: torch.Tensor
    d_ur: torch.Tensor


class DeviceKfCache:
    """Device-resident mirror of the keyframes' feature arrays.

    The mapping plane's batch programs (Fuse projection, triangulation,
    BA's observation gather) need the uv/descriptor/octave/angle blocks of
    ~16 keyframes a call. Features are immutable once a keyframe exists
    (reference KeyFrame: features const, pose mutable), so each keyframe's
    row is written here once, in place — in the fused path straight from
    the extraction's device tensors, with no trip through the host — and
    every program gathers by keyframe id on the device. Poses stay
    host-authoritative (BA rewrites them) and ride in as a small per-call
    argument.

    The tracking thread writes rows (``add``) while the mapping and loop
    workers read and backfill them (``ensure``), each on its own CUDA
    stream; growth replaces every block. Both go under one lock, and
    ``ensure`` returns the blocks as they stood (``KfRows``): its caller
    reads those, ordered after every stream's writes (``StreamOrder``)."""

    def __init__(self, n_feat: int, cap: int = 128, device=None):
        self.n_feat = n_feat
        self.cap = cap
        self.device = resolve(device)
        self.have = set()
        self._lock = threading.RLock()
        self._order = StreamOrder(self.device)
        self._alloc(cap)

    def _alloc(self, cap):
        N, dev = self.n_feat, self.device
        self.d_uv = torch.zeros((cap, N, 2), dtype=torch.float32, device=dev)
        self.d_desc = torch.zeros((cap, N, 8), dtype=torch.int32, device=dev)
        self.d_oct = torch.zeros((cap, N), dtype=torch.int32, device=dev)
        self.d_angle = torch.zeros((cap, N), dtype=torch.float32, device=dev)
        self.d_valid = torch.zeros((cap, N), dtype=torch.bool, device=dev)
        self.d_ur = torch.zeros((cap, N), dtype=torch.float32, device=dev)

    _FIELDS = KfRows._fields

    def _rows(self) -> KfRows:
        return KfRows(*(getattr(self, f) for f in self._FIELDS))

    def _grow(self, need):
        old_cap, cap = self.cap, self.cap
        while cap < need:
            cap *= 2
        old = self._rows()
        self._order.before_read(old)
        self._alloc(cap)
        for f, a in zip(self._FIELDS, old):
            getattr(self, f)[:old_cap] = a
        self._order.wrote(self._rows())
        self.cap = cap

    def reset(self, capacity_kf: int):
        """Invalidate after an id remap (atlas merge): entries backfill
        lazily from the host map on next use. The mirror grows to
        ``capacity_kf`` rows at once when the welded map has more."""
        with self._lock:
            self.have.clear()
            if capacity_kf > self.cap:
                self._grow(capacity_kf)

    def ensure(self, m: MapState, ids) -> KfRows:
        """Backfill any keyframes missing from the device mirror (maps
        built before the cache attached, loads), then return the blocks for
        the caller to read on its stream."""
        with self._lock:
            for k in ids:
                k = int(k)
                if k not in self.have:
                    self.add(k, _HostFeats(
                        uv=m.kf_uv[k], desc=m.kf_desc[k],
                        octave=m.kf_octave[k].astype(np.int32),
                        angle=m.kf_angle[k], valid=m.kf_feat_valid[k],
                        u_right=m.kf_ur[k]))
            rows = self._rows()
            self._order.before_read(rows)
            return rows

    def add(self, kf_id: int, feats):
        """Register a keyframe's features (``FrameFeatures`` on the device
        or on the host; host descriptors may be uint32 words): one in-place
        row write per array."""
        desc = feats.desc
        if isinstance(desc, np.ndarray):
            desc = _i32_words(desc) if desc.dtype == np.uint32 else desc
        with self._lock:
            if kf_id >= self.cap:
                self._grow(kf_id + 1)
            for field, value in (("d_uv", feats.uv), ("d_desc", desc), ("d_oct", feats.octave),
                                 ("d_angle", feats.angle), ("d_valid", feats.valid),
                                 ("d_ur", feats.u_right)):
                row = getattr(self, field)[kf_id]
                row.copy_(torch.as_tensor(value).to(device=self.device, dtype=row.dtype))
            self._order.wrote(self._rows())
            self.have.add(int(kf_id))


class _HostFeats:
    def __init__(self, uv, desc, octave, angle, valid, u_right):
        (self.uv, self.desc, self.octave, self.angle, self.valid,
         self.u_right) = (uv, desc, octave, angle, valid, u_right)


def _fuse_project_batch(cam, scale_factor: float, n_levels: int, tg_idx, poses,
                        d_uv, d_desc, d_oct, d_valid, P, Pdesc, Pmaxd, Pvalid):
    """``ORBmatcher::Fuse`` projection half for T target keyframes: project
    the landmark set into every target and windowed-match (radius 3·scale
    at the predicted octave, TH_LOW).

    tg_idx (T,) int64, poses (T, 7), T ≥ 1 real targets; the target
    features gather from the device keyframe mirror by id; P (cap, 3),
    Pdesc (cap, 8) int32, Pmaxd (cap,), Pvalid (cap,) bool.
    Returns (idx (T, cap) int32 matched feature per landmark slot or −1,
    dist (T, cap) f32 Hamming distance)."""
    log_sf = float(np.log(np.float32(scale_factor)))     # f32, as the division's other side
    idx_out, dist_out = [], []
    for t in range(tg_idx.shape[0]):
        Tcw, k = poses[t], tg_idx[t]
        pc = lie.se3_apply(Tcw[None, :], P)
        z = pc[:, 2]
        uvp = cam_mod.geo_project(cam, pc)
        u, v = uvp[:, 0], uvp[:, 1]
        ok = Pvalid & (z > 0.1)
        ok = ok & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
        center = lie.se3_trans(lie.se3_inv(Tcw))
        dist_w = torch.linalg.norm(P - center[None, :], dim=-1)
        ratio = Pmaxd / dist_w.clamp_min(1e-6)
        po = torch.ceil(torch.log(ratio.clamp_min(1e-6)) / log_sf).clamp(0, n_levels - 1)
        radius = 3.0 * scale_factor ** po
        idx, dist = matching.windowed_projection_match(
            uvp, ok, Pdesc, po.to(torch.int32), d_uv[k], d_valid[k], d_desc[k], d_oct[k],
            radius, th=matching.TH_LOW)
        idx_out.append(idx)
        dist_out.append(dist)
    return torch.stack(idx_out), torch.stack(dist_out)


def fuse_project_targets_async(mapper, tg, P, Pdesc, Pmaxd, Pvalid):
    """Dispatch half: enqueue the fused projection batch of the target
    keyframes ``tg`` against the device feature mirror. Returns device
    tensors."""
    m = mapper.map
    c, up = mapper.dev_cache.ensure(m, tg), mapper._dev
    return _fuse_project_batch(
        mapper.geo_cam, float(mapper.cfg.orb.scale_factor), mapper.cfg.orb.n_levels,
        up(np.asarray(tg, np.int64), torch.int64), up(m.kf_pose[tg], torch.float32),
        c.d_uv, c.d_desc, c.d_oct, c.d_valid,
        up(P, torch.float32), up(_i32_words(Pdesc), torch.int32), up(Pmaxd, torch.float32),
        up(Pvalid, torch.bool))


def _fetch(out):
    """Download one (idx, dist) result (or None) as numpy."""
    return None if out is None else tuple(a.cpu().numpy() for a in out)


def fuse_project_targets(mapper, tg, P, Pdesc, Pmaxd, Pvalid):
    """Dispatch + fetch in one call (single-batch call sites)."""
    return _fetch(fuse_project_targets_async(mapper, tg, P, Pdesc, Pmaxd, Pvalid))


def _triangulate_batch(cam, scale_factor: float, kf_idx, T1, unbound1, nb_idx, T2s, unbound2s,
                       d_uv, d_desc, d_oct, d_angle):
    """All CreateNewMapPoints pair-math for NB ≥ 1 real neighbors: per
    neighbor, epipolar-gated mutual matching, closed-form DLT triangulation
    and the parallax, cheirality and reprojection gates.

    kf_idx () and nb_idx (NB,) int64 gather the keyframes' features from
    the device mirror; T1 (7,), T2s (NB, 7); unbound1 (N,), unbound2s
    (NB, N) bool. Results compact on the device to
    ``TRI_CAP`` accepted pairs per neighbor, accepted pairs first in
    ascending feature order (a stable sort). Returns (f1 (NB, C) current
    feature index, f2 (NB, C) neighbor feature index, X (NB, C, 3) points,
    cnt (NB,) accepted count)."""
    fisheye = cam_mod.is_fisheye(cam)
    K = None if fisheye else cam_mod.intrinsics(cam, dtype=d_uv.dtype, device=d_uv.device)
    uv1, desc1, ang1, oct1 = d_uv[kf_idx], d_desc[kf_idx], d_angle[kf_idx], d_oct[kf_idx]
    N = uv1.shape[0]
    xn1 = cam_mod.geo_unproject(cam, uv1)
    T1b = T1.expand(N, 7)

    def reproj_ok(X, Tcw, uv, octv):
        pc = lie.se3_apply(Tcw[None, :], X)
        uvp = cam_mod.geo_project(cam, pc)
        err2 = torch.sum((uvp - uv) ** 2, dim=-1)
        sigma2 = scale_factor ** (2.0 * octv.to(torch.float32))
        return (pc[:, 2] > 0.1) & (err2 < 5.991 * sigma2)

    f1_out, f2_out, X_out, cnt_out = [], [], [], []
    for a in range(nb_idx.shape[0]):
        T2, k2 = T2s[a], nb_idx[a]
        uv2, oct2 = d_uv[k2], d_oct[k2]
        d = matching.distance_table(desc1, d_desc[k2], unbound1, unbound2s[a])
        sigma2 = scale_factor ** (2.0 * oct2.to(torch.float32))
        if fisheye:
            # epipolar lines are curves under KB8: the gate works on bearings
            E12 = triangulation.essential_from_poses(T1, T2)
            ep = triangulation.bearing_sampson_sq(
                E12, xn1[:, None, :], cam_mod.geo_unproject(cam, uv2)[None, :, :], cam.fx)
        else:
            F12 = triangulation.fundamental_from_poses(K, K, T1, T2)
            ep = triangulation.epipolar_distance_sq(F12, uv1[:, None, :], uv2[None, :, :])
        d = torch.where(ep < 3.84 * sigma2[None, :], d, 256.0)
        idx, _ = matching.mutual_best_match(
            d, ang1, d_angle[k2], th=matching.TH_LOW, ratio=0.8, check_rotation=True)
        matched = idx >= 0
        f2 = torch.where(matched, idx, 0).long()
        xn2 = cam_mod.geo_unproject(cam, uv2[f2])
        T2b = T2.expand(N, 7)
        cosp = triangulation.parallax_cos(xn1, xn2, T1b, T2b)
        X = triangulation.triangulate_fast(xn1, xn2, T1b, T2b)
        ok = matched & (cosp > 0) & (cosp < 0.9998)
        ok = ok & torch.isfinite(X).all(dim=1)
        Xs = torch.nan_to_num(X)
        ok = ok & reproj_ok(Xs, T1, uv1, oct1)
        ok = ok & reproj_ok(Xs, T2, uv2[f2], oct2[f2])
        # accepted pairs first; the sort is stable, so they come in
        # ascending feature order, which the host loop relies on
        order = torch.argsort((~ok).to(torch.int8), stable=True)[:TRI_CAP]
        f1_out.append(order)
        f2_out.append(f2[order])
        X_out.append(Xs[order])
        cnt_out.append(ok.sum())
    return (torch.stack(f1_out), torch.stack(f2_out), torch.stack(X_out),
            torch.stack(cnt_out).to(torch.int32))


def _settle_cycles(remap: np.ndarray) -> np.ndarray:
    """Settles the Replace chains that four path-compression rounds (the
    JAX package's) left unsettled; a remap that they settled comes back as
    it was. Such a chain either is longer than 16 links, and then each of
    its members goes to the chain's fixed point (its winner), or it runs
    into a cycle: a pair of landmarks with equal observation counts met in
    both fusion directions can each win once (a → b forward, b → c → a
    backward). Then the cycle's members, and the chains that lead into it,
    go to the cycle's smallest id, so no binding is left on a landmark that
    the remap frees. (The JAX package leaves both as they are, and its map
    keeps bindings to freed landmarks.)"""
    unsettled = np.nonzero(remap[remap] != remap)[0]
    if unsettled.size == 0:
        return remap
    remap = remap.copy()
    end: dict = {}
    for x in unsettled:
        path, seen, y = [], {}, int(x)
        while True:
            if y in end:
                target = end[y]
                break
            if remap[y] == y:
                target = y
                break
            if y in seen:
                target = min(path[seen[y]:])      # the cycle's members
                break
            seen[y] = len(path)
            path.append(y)
            y = int(remap[y])
        for p in path:
            end[p] = target
    for p, target in end.items():
        remap[p] = target
    return remap


class LocalMapper:
    VI_OPT_WINDOW = 10   # optimizable temporal states (Optimizer.cc:2392)
    VI_FIX_WINDOW = 5    # fixed temporal anchors

    def __init__(self, config: SlamConfig, map_state: MapState, device=None):
        self.cfg = config
        self.cam = config.camera
        self.geo_cam = config.geo_camera  # residual/projection camera model
        self.map = map_state
        self.device = resolve(device)
        # device mirror of keyframe features (fed by the tracker at
        # keyframe creation; lazily backfilled from the host map)
        self.dev_cache = DeviceKfCache(map_state.n_features, device=self.device)
        self.inv_sigma2 = inv_scale_sigma2(config.orb.n_levels, config.orb.scale_factor,
                                           self.device)
        self.recent_lm: list = []   # (lm_ids, created_at_kf) for culling
        self.is_mono = config.sensor in (0, 3)  # MONOCULAR / IMU_MONOCULAR
        self.obs_cap = BA_OBS_CAP   # D — observers kept per landmark in
        #   local BA (the reference keeps every observer)
        self.backlog_fn = None      # wired by System: keyframes queued
        #   behind this job (reference mbAbortBA pressure signal)
        self._lba_skipped = 0       # consecutive skips under backlog
        # what the plane did, summed over its jobs (read by callers)
        self.counts = collections.Counter()
        self.timer = None           # StageTimer, wired by System (its stage times)
        # inertial state of the plane
        self.bad_imu = False        # mbBadImu: a motion-starved IMU init, reset the map
        self._t_init = 0.0          # accumulated well-excited time (mTinit)
        self._imu_init_time = None  # the last keyframe's timestamp at IMU initialization
        self._viba_stage = 0        # VIBA1 / VIBA2 done
        if config.inertial:
            self._T_bc, self._T_cb = imu_frontend.body_cam_extrinsics(config)

    def _dev(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    @contextlib.contextmanager
    def _stage(self, name):
        """The ``map.<name>`` profiler span and, with a timer, its stage."""
        with record_function("map." + name), stage(self.timer, name):
            yield

    # ------------------------------------------------------------------
    def process_keyframe(self, kf_id: int, run_ba: bool = True):
        with self._stage("kf_insert"):
            self.map.update_landmark_stats(np.array([kf_id]))
        with self._stage("mp_cull"):
            self._map_point_culling(kf_id)
        with self._stage("mp_create"):
            self._triangulate_new_points(kf_id)
        with self._stage("loop_fusion"):
            self._search_in_neighbors(kf_id)
        min_kf_for_ba = 2 if self.is_mono else 3
        if run_ba and self.map.n_kf >= min_kf_for_ba and self.cfg.inertial \
                and self.map.imu_initialized:
            # after IMU initialization the job's BA is LocalInertialBA
            # (LocalMapping.cc:149 against :154)
            with self._stage("lba"):
                self._check_vi_excitation(kf_id)
                self.local_inertial_bundle_adjustment(kf_id)
        elif run_ba and self.map.n_kf >= min_kf_for_ba:
            with self._stage("lba"):
                # pressure-adaptive iteration budget — the reference aborts
                # local BA when the next keyframe arrives (mbAbortBA,
                # Optimizer.cc:1173). Here the queue backlog throttles the
                # same way: nothing queued → full 10 iterations; one
                # queued → short solve; ≥ 2 queued → skip, but never more
                # than twice in a row so a sustained backlog cannot starve
                # the window of refinement.
                backlog = self.backlog_fn() if self.backlog_fn is not None else 0
                if backlog >= 2 and self._lba_skipped < 2:
                    self._lba_skipped += 1
                else:
                    self._lba_skipped = 0
                    iters = 10 if backlog == 0 else 4
                    self.local_bundle_adjustment(kf_id, n_iters=iters)
        with self._stage("kf_cull"):
            self._keyframe_culling(kf_id)

    # ------------------------------------------------------------------
    def _fuse_into(self, kf: int, lm_ids: np.ndarray, counts: np.ndarray,
                   remap: np.ndarray, cap: int, th: float = 3.0,
                   touched: list = None) -> int:
        """``ORBmatcher::Fuse``: project the landmarks into keyframe
        ``kf``; a windowed descriptor match (radius th·scale, TH_LOW)
        either binds an unbound feature or replaces a duplicate landmark
        (keep the one with more observations — ``MapPoint::Replace``).
        Mutates ``remap``/bindings; returns the number of fusions +
        bindings."""
        m = self.map
        lm_ids = lm_ids[: cap]
        n = lm_ids.size
        if n == 0:
            return 0
        P = np.zeros((cap, 3), np.float32)
        Pdesc = np.zeros((cap, 8), np.uint32)
        Pvalid = np.zeros(cap, bool)
        Pmaxd = np.ones(cap, np.float32)
        P[:n] = m.lm_pos[lm_ids]
        Pdesc[:n] = m.lm_desc[lm_ids]
        Pmaxd[:n] = m.lm_max_dist[lm_ids]
        Pvalid[:n] = True
        idx_b, d_b = fuse_project_targets(
            self, np.asarray([kf], np.int64), P, Pdesc, Pmaxd, Pvalid)
        return self._apply_fuse_matches(kf, lm_ids, counts, remap,
                                        idx_b[0], d_b[0], touched=touched)

    def _apply_fuse_matches(self, kf: int, lm_ids: np.ndarray,
                            counts: np.ndarray, remap: np.ndarray,
                            idx: np.ndarray, d: np.ndarray,
                            touched: list = None) -> int:
        """Host half of Fuse: bind unbound features / Replace duplicates
        from a (cap,) projection-match result."""
        m = self.map
        hit = np.nonzero(idx >= 0)[0]
        hit = hit[hit < lm_ids.size]
        if hit.size == 0:
            return 0
        # feature-wise collision resolution: closest projection wins
        order = hit[np.argsort(d[hit], kind="stable")]
        feats_of = idx[order]
        first = np.unique(feats_of, return_index=True)[1]
        win_p, win_f = order[first], feats_of[first]

        src = lm_ids[win_p]
        tgt = m.kf_lm_idx[kf, win_f]
        n_ops = 0
        # unbound features → new observation of the projected landmark;
        # a landmark already observed at another slot of this keyframe
        # must not bind twice (reference Fuse checks MapPoint::IsInKeyFrame)
        row = m.kf_lm_idx[kf]
        present = np.zeros(m.capacity_lm, bool)
        present[row[row >= 0]] = True
        free = (tgt < 0) & ~present[src]
        if free.any():
            m.kf_lm_idx[kf, win_f[free]] = src[free]
            n_ops += int(free.sum())
            self.counts["fuse_bound"] += int(free.sum())
            if touched is not None:
                touched.append(src[free])
        # bound to a different landmark → Replace (more observations wins)
        dup = (~free) & (tgt != src)
        if dup.any():
            a, b = src[dup], tgt[dup]          # a = projected, b = resident
            keep_a = counts[a] >= counts[b]
            winner = np.where(keep_a, a, b)
            loser = np.where(keep_a, b, a)
            fresh = loser != winner
            remap[loser[fresh]] = winner[fresh]
            n_ops += int(fresh.sum())
            if touched is not None:
                touched.append(winner[fresh])
        return n_ops

    def _search_in_neighbors(self, kf_id: int):
        """Reference ``LocalMapping::SearchInNeighbors``
        (LocalMapping.cc:714-824): two-hop covisible duplicate fusion —
        project the new keyframe's landmarks into its extended neighborhood
        and the neighborhood's landmarks back, merging duplicates via
        ``MapPoint::Replace`` and adding missed observations (this is what
        grows covisibility weights and observation counts after
        triangulation)."""
        m = self.map
        nn = 20 if self.is_mono else 10
        hop1 = m.best_covisible(kf_id, nn, min_weight=1)
        targets = set(int(k) for k in hop1)
        for k in hop1[:5]:
            for k2 in m.best_covisible(int(k), 5, min_weight=1):
                if int(k2) != kf_id:
                    targets.add(int(k2))
        # temporal neighbors too (duplicates between fully disjoint
        # landmark sets have zero covisibility by definition, so recency is
        # the only edge that can seed their fusion)
        recent = m.valid_kf_ids()
        for k in recent[recent < kf_id][-3:]:
            targets.add(int(k))
        targets.discard(kf_id)
        if not targets:
            return
        targets = sorted(targets)

        counts = m.observation_counts()
        remap = np.arange(m.capacity_lm, dtype=np.int32)
        cap = m.n_features
        own = m.kf_lm_idx[kf_id]
        own = np.unique(own[own >= 0])
        n_ops = 0
        touched = []
        # forward (this keyframe's landmarks into every neighbor) and
        # backward (the neighborhood's landmarks into this keyframe) are
        # independent: enqueue both, then download both
        tg_all = np.asarray(targets[:FUSE_TARGETS_CAP], np.int64)
        fwd_out = None
        own_c = own[:cap]
        if own.size and tg_all.size:
            n = own_c.size
            P = np.zeros((cap, 3), np.float32)
            Pdesc = np.zeros((cap, 8), np.uint32)
            Pmaxd = np.ones(cap, np.float32)
            Pvalid = np.zeros(cap, bool)
            P[:n] = m.lm_pos[own_c]
            Pdesc[:n] = m.lm_desc[own_c]
            Pmaxd[:n] = m.lm_max_dist[own_c]
            Pvalid[:n] = True
            fwd_out = fuse_project_targets_async(self, tg_all, P, Pdesc, Pmaxd, Pvalid)
        back = m.kf_lm_idx[np.asarray(targets)]
        back = np.unique(back[back >= 0])
        back = back[~np.isin(back, own)]
        back = back[: 2 * cap]
        bwd_out = None
        if back.size:
            bcap = 2 * cap
            Pb = np.zeros((bcap, 3), np.float32)
            Pbd = np.zeros((bcap, 8), np.uint32)
            Pbm = np.ones(bcap, np.float32)
            Pbv = np.zeros(bcap, bool)
            nb2 = back.size
            Pb[:nb2] = m.lm_pos[back]
            Pbd[:nb2] = m.lm_desc[back]
            Pbm[:nb2] = m.lm_max_dist[back]
            Pbv[:nb2] = True
            bwd_out = fuse_project_targets_async(
                self, np.asarray([kf_id], np.int64), Pb, Pbd, Pbm, Pbv)
        fwd, bwd = _fetch(fwd_out), _fetch(bwd_out)
        if fwd is not None:
            idx_b, dist_b = fwd
            for a, k2 in enumerate(tg_all):
                n_ops += self._apply_fuse_matches(
                    int(k2), own_c, counts, remap, idx_b[a], dist_b[a],
                    touched=touched)
        if bwd is not None:
            idx1, d1 = bwd
            n_ops += self._apply_fuse_matches(
                kf_id, back, counts, remap, idx1[0], d1[0], touched=touched)

        # apply Replace remaps globally (path-compress chains first)
        changed = remap != np.arange(m.capacity_lm, dtype=np.int32)
        if changed.any():
            for _ in range(4):
                nxt = remap[remap]
                if np.array_equal(nxt, remap):
                    break
                remap = nxt
            remap = _settle_cycles(remap)
            bound = m.kf_lm_idx >= 0
            m.kf_lm_idx[bound] = remap[m.kf_lm_idx[bound]]
            losers = np.nonzero(remap != np.arange(m.capacity_lm, dtype=np.int32))[0]
            winners = remap[losers]
            # Replace merges the visibility statistics (MapPoint::Replace)
            np.add.at(m.lm_found, winners, m.lm_found[losers])
            np.add.at(m.lm_visible, winners, m.lm_visible[losers])
            with m.alloc_lock:
                m.lm_valid[losers] = False
                m.lm_gen[losers] += 1
                m.lm_free.extend(int(i) for i in losers)
            self.counts["fuse_replaced"] += int(losers.size)
        if n_ops:
            # a keyframe may now bind one landmark at two feature slots
            # (Replace remap collisions) — restore the one-obs-per-pair
            # invariant after every fusion pass, not only on Replace
            dedup_kf_bindings(m)
            # refresh distinctive descriptors / normals / depth bands of
            # the landmarks actually touched (the reference updates per
            # fused point)
            ids = (np.unique(np.concatenate(touched)) if touched
                   else np.zeros(0, np.int64))
            ids = remap[np.clip(ids, 0, m.capacity_lm - 1)]
            m.update_landmark_stats(lm_ids=ids)
            m.version += 1

    # ------------------------------------------------------------------
    def _map_point_culling(self, kf_id: int):
        """Reference ``MapPointCulling`` (LocalMapping.cc:346-386): kill
        landmarks with found/visible < 0.25, or with < 3 observations
        after 2 keyframes."""
        if not self.recent_lm:
            self._note_new_landmarks(kf_id)
            return
        counts = self.map.observation_counts()
        keep_list = []
        for lm_ids, born_kf in self.recent_lm:
            lm_ids = lm_ids[self.map.lm_valid[lm_ids]]
            age = self.map.n_kf - born_kf
            ratio = self.map.lm_found[lm_ids] / np.maximum(self.map.lm_visible[lm_ids], 1)
            bad = ratio < 0.25
            if age >= 2:
                bad |= counts[lm_ids] < 3
            self.map.remove_landmarks(lm_ids[bad])
            self.counts["mp_culled"] += int(bad.sum())
            if age < 3:
                keep_list.append((lm_ids[~bad], born_kf))
        self.recent_lm = keep_list
        self._note_new_landmarks(kf_id)

    def _note_new_landmarks(self, kf_id: int):
        ids = self.map.kf_lm_idx[kf_id]
        ids = ids[ids >= 0]
        born = ids[self.map.lm_first_kf[ids] == kf_id]
        if born.size:
            self.recent_lm.append((born.copy(), self.map.n_kf))

    # ------------------------------------------------------------------
    def _triangulate_new_points(self, kf_id: int, n_neighbors: int = 0):
        """Reference ``CreateNewMapPoints`` (LocalMapping.cc:388-713):
        epipolar-gated matching of unbound features against the best
        covisible keyframes, DLT triangulation, parallax/reprojection/
        positive-depth checks. Depth sensors already provide close points,
        so this adds the *far* structure that stabilizes rotation.

        The neighbors that pass the baseline gate are enqueued in one
        ``_triangulate_batch`` call with a single download of its compacted
        results."""
        if n_neighbors <= 0:
            # mono relies on wide-baseline pairs: nn=30 (LocalMapping.cc:391-394)
            n_neighbors = 30 if self.is_mono else 10
        neighbors = self.map.best_covisible(kf_id, n_neighbors, min_weight=1)
        if neighbors.size == 0:
            return
        m = self.map
        unbound1 = (m.kf_lm_idx[kf_id] < 0) & m.kf_feat_valid[kf_id]
        # mono maps have arbitrary scale: gate the baseline against the
        # median scene depth instead of meters (reference
        # LocalMapping.cc:434-446: ratioBaselineDepth > 0.01)
        if self.is_mono:
            lm_here = m.kf_lm_idx[kf_id]
            lm_here = lm_here[lm_here >= 0]
            if lm_here.size == 0:
                return
            center1 = lie.np_se3_centers(m.kf_pose[kf_id])
            med_depth = float(np.median(
                np.linalg.norm(m.lm_pos[lm_here] - center1[None, :], axis=-1)))
            min_baseline = 0.01 * med_depth
        else:
            min_baseline = 0.08
        if unbound1.sum() < 10:
            return

        # the neighbor batch: at most TRI_NEIGHBORS_CAP (32 for mono), and
        # of those the ones with baseline and unbound features enough;
        # keyframe feature blocks gather from the device mirror by id
        nb_all = neighbors[: 32 if self.is_mono else TRI_NEIGHBORS_CAP]
        c1 = lie.np_se3_centers(m.kf_pose[kf_id])
        baselines = np.linalg.norm(
            lie.np_se3_centers(m.kf_pose[nb_all]) - c1[None, :], axis=-1)
        unbound2_all = (m.kf_lm_idx[nb_all] < 0) & m.kf_feat_valid[nb_all]
        pv_all = (baselines >= min_baseline) & (unbound2_all.sum(1) >= 10)
        if not pv_all.any():
            return
        nb_all, unbound2_all = nb_all[pv_all], unbound2_all[pv_all]
        c, up = self.dev_cache.ensure(m, np.concatenate([[kf_id], nb_all])), self._dev
        f1_b, f2_b, X_b, cnt_b = (a.cpu().numpy() for a in _triangulate_batch(
            self.geo_cam, float(self.cfg.orb.scale_factor),
            up(np.int64(kf_id), torch.int64), up(m.kf_pose[kf_id], torch.float32),
            up(unbound1, torch.bool), up(nb_all.astype(np.int64), torch.int64),
            up(m.kf_pose[nb_all], torch.float32), up(unbound2_all, torch.bool),
            c.d_uv, c.d_desc, c.d_oct, c.d_angle))

        created_all = []
        claimed1 = ~unbound1
        for a in range(len(nb_all)):
            n = int(cnt_b[a])
            if n > TRI_CAP:
                # no silent caps: compaction dropped the tail
                log("triangulation: %d accepted pairs beyond the %d download cap dropped"
                    % (n - TRI_CAP, TRI_CAP))
                n = TRI_CAP
            if n == 0:
                continue
            k2 = int(nb_all[a])
            f1s = f1_b[a][:n].astype(np.int64)
            f2s = f2_b[a][:n].astype(np.int64)
            X = X_b[a][:n]
            # features already claimed by an earlier neighbor this pass
            keep = ~claimed1[f1s]
            f1s, f2s, X = f1s[keep], f2s[keep], X[keep]
            # drop features on the neighbor side already bound/claimed
            good2 = m.kf_lm_idx[k2, f2s] < 0
            f1s, f2s, X = f1s[good2], f2s[good2], X[good2]
            if f1s.size == 0:
                continue
            claimed1[f1s] = True
            vecs = X - c1[None, :]
            dd = np.linalg.norm(vecs, axis=-1)
            normals = vecs / np.maximum(dd[:, None], 1e-9)
            octv = m.kf_octave[kf_id][f1s]
            sf = self.cfg.orb.scale_factor ** octv.astype(np.float32)
            ids = m.add_landmarks(
                X.astype(np.float32), m.kf_desc[kf_id][f1s], kf_id, f1s,
                normals.astype(np.float32), (dd * sf).astype(np.float32),
                (dd * sf / self.cfg.orb.scale_factor ** (self.cfg.orb.n_levels - 1)
                 ).astype(np.float32))
            m.kf_lm_idx[k2, f2s] = ids
            created_all.append(ids)
        if created_all:
            created = np.concatenate(created_all)
            self.counts["triangulated"] += int(created.size)
            self.recent_lm.append((created, self.map.n_kf))

    def _reproj_ok(self, X, Tcw, uv, octave, chi2=5.991):
        """Host reprojection gate. The scale factor 1.2 is the JAX
        package's literal, not the configured one (equal for KITTI)."""
        Tcw = np.asarray(Tcw, np.float32)
        pc = lie.np_quat_rotate(Tcw[:4], X.astype(np.float32)) + Tcw[4:7]
        z = pc[:, 2]
        proj = np_geo_project(self.geo_cam, pc)
        err2 = (proj[:, 0] - uv[:, 0]) ** 2 + (proj[:, 1] - uv[:, 1]) ** 2
        sigma2 = 1.2 ** (2 * octave.astype(np.float32))
        return (z > 0.1) & np.nan_to_num(err2 < chi2 * sigma2, nan=False)

    # ------------------------------------------------------------------
    def local_bundle_adjustment(self, kf_id: int, iterations: int = 10, n_iters=None):
        """Assemble the covisibility window and run the Schur BA
        (reference ``Optimizer::LocalBundleAdjustment`` semantics: current
        keyframe + covisible neighbors optimized, their landmarks, plus
        fixed observer keyframes; writeback under a map version bump)."""
        w = self.map.covisibility_weights(kf_id)
        order = np.argsort(-w)
        opt_ids = [kf_id] + [int(k) for k in order if w[k] > 0][: BA_POSES_CAP // 2 - 1]
        opt_set = np.array(opt_ids, np.int64)

        tbl = self.map.kf_lm_idx[opt_set]
        lm_ids = np.unique(tbl[tbl >= 0])
        lm_ids = lm_ids[self.map.lm_valid[lm_ids]][:BA_LM_CAP]
        if lm_ids.size < 30:
            return

        # fixed observers: other keyframes seeing these landmarks
        mask = np.zeros(self.map.capacity_lm, bool)
        mask[lm_ids] = True
        valid_kfs = self.map.valid_kf_ids()
        sees = (
            (mask[np.clip(self.map.kf_lm_idx[valid_kfs], 0, None)]
             & (self.map.kf_lm_idx[valid_kfs] >= 0)).sum(axis=1)
        )
        opt_lookup = set(opt_ids)
        fixed_pool = [int(k) for k, s in zip(valid_kfs, sees) if s > 0 and k not in opt_lookup]
        n_fixed_slots = BA_POSES_CAP - len(opt_set)
        fixed_set = np.array(fixed_pool[:n_fixed_slots], np.int64)
        window = np.concatenate([opt_set, fixed_set])
        pose_fixed = np.zeros(BA_POSES_CAP, bool)
        pose_fixed[len(opt_set):] = True
        # the map's origin keyframe is always gauge-fixed (reference
        # Optimizer.cc local BA: InitKFid keyframes get setFixed(true))
        for i, k in enumerate(window):
            if k == 0:
                pose_fixed[i] = True
        # if nothing is fixed at all, pin the oldest pose in the window
        if not pose_fixed[: len(window)].any():
            anchor = int(np.argmin(self.map.kf_frame_id[window]))
            pose_fixed[anchor] = True

        Kw = BA_POSES_CAP
        poses = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (Kw, 1))
        pose_valid = np.zeros(Kw, bool)
        poses[: len(window)] = self.map.kf_pose[window]
        pose_valid[: len(window)] = True

        obs_kf, obs_feat, obs_mask, obs_uv, obs_ur = self.map.gather_observations(
            window, lm_ids, self.obs_cap)
        c = self.dev_cache.ensure(self.map, window)
        if self.map.last_dropped_obs:
            # no silent caps: dense covisibility exceeded the D-per-landmark
            # budget (the reference local BA keeps every observer)
            log("local BA: %d observations beyond the %d-per-landmark cap dropped"
                % (self.map.last_dropped_obs, self.obs_cap))
            self.counts["lba_dropped_obs"] += int(self.map.last_dropped_obs)
        # observation pixels, pseudo-stereo columns and weights gather from
        # the device feature mirror; only the index tables are uploaded
        up, f32 = self._dev, torch.float32
        kf_global = window[np.clip(obs_kf, 0, len(window) - 1)]
        kfg_dev = up(kf_global, torch.int64)
        feat_dev = up(obs_feat, torch.int64)
        mask_dev = up(obs_mask, torch.bool)
        obs_ur_dev = torch.where(mask_dev, c.d_ur[kfg_dev, feat_dev], -1.0)
        oct_dev = c.d_oct[kfg_dev, feat_dev].clamp(0, self.inv_sigma2.shape[0] - 1).long()

        problem = local_ba.BAProblem(
            poses=up(poses, f32),
            pose_fixed=up(pose_fixed, torch.bool),
            pose_valid=up(pose_valid, torch.bool),
            landmarks=up(self.map.lm_pos[lm_ids], f32),
            lm_valid=torch.ones(lm_ids.size, dtype=torch.bool, device=self.device),
            obs_kf=up(obs_kf, torch.int64),
            obs_uv=c.d_uv[kfg_dev, feat_dev],
            obs_ur=obs_ur_dev,
            obs_inv_sigma2=self.inv_sigma2[oct_dev],
            obs_mask=mask_dev,
        )
        # one enqueue of the whole solve, then one download of its results
        res = local_ba.bundle_adjust(problem, self.geo_cam, iterations=iterations,
                                     n_iters=n_iters)
        new_poses = res.poses.cpu().numpy()
        new_lms = res.landmarks.cpu().numpy()
        inl = res.obs_inlier.cpu().numpy()
        self.map.kf_pose[window] = new_poses[: len(window)]
        self.map.lm_pos[lm_ids] = new_lms
        self.counts["lba_runs"] += 1

        # drop observations classified outlier (unbind feature slots)
        bad_obs = (~inl) & obs_mask
        if bad_obs.any():
            mrows, dcols = np.nonzero(bad_obs)
            kfg = window[obs_kf[mrows, dcols]]
            self.map.kf_lm_idx[kfg, obs_feat[mrows, dcols]] = -1
            self.map.cull_orphans(lm_ids[np.unique(mrows)])
            self.counts["lba_outlier_obs"] += int(bad_obs.sum())
        self.map.version += 1

    # ------------------------------------------------------------------
    def _keyframe_culling(self, kf_id: int):
        """Reference ``KeyFrameCulling`` (LocalMapping.cc:902-1054): a
        covisible keyframe is redundant if ≥ 90% of its landmarks are seen
        by ≥ 3 other keyframes. Inertial maps (LocalMapping.cc:1012-1019)
        keep at least 21 keyframes and the two newest, cull at 50% for the
        stereo and RGB-D sensors, and relink the IMU chain first."""
        neighbors = self.map.best_covisible(kf_id, 20, min_weight=15)
        if neighbors.size == 0:
            return
        inertial_map = self.cfg.inertial
        if inertial_map and self.map.valid_kf_ids().size <= 21:
            return
        redundant_th = 0.5 if (inertial_map and self.cfg.sensor != IMU_MONOCULAR) else 0.9
        counts = self.map.observation_counts()
        for k in neighbors:
            if k == 0:  # keep the origin keyframe
                continue
            if inertial_map and k >= kf_id - 2:
                continue
            ids = self.map.kf_lm_idx[k]
            lm = ids[ids >= 0]
            if lm.size < 30:
                continue
            redundant = (counts[lm] >= 4).mean()  # self + 3 others
            if redundant > redundant_th:
                if inertial_map and not self._relink_imu_chain(int(k)):
                    continue
                self.map.remove_keyframe(int(k))
                self.counts["kf_culled"] += 1

    # ------------------------------------------------------------------
    # the inertial mapping plane
    # ------------------------------------------------------------------
    def _check_vi_excitation(self, kf_id: int):
        """The reference's bad-IMU detection (LocalMapping.cc:129-146):
        after IMU initialization and before VIBA2, the last two keyframe
        baselines summing < 2 cm within the first 10 s of excited time mean
        an unreliable initialization: ``bad_imu`` asks for a map reset."""
        if self._viba_stage >= 2:
            return
        m = self.map
        kfs = m.valid_kf_ids()
        kfs = kfs[kfs <= kf_id]
        if kfs.size < 3:
            return
        c = lie.np_se3_centers(m.kf_pose[kfs[-3:]])
        dist = np.linalg.norm(c[2] - c[1]) + np.linalg.norm(c[1] - c[0])
        if dist > 0.05:
            self._t_init += float(m.kf_timestamp[kfs[-1]] - m.kf_timestamp[kfs[-2]])
        if self._t_init < 10.0 and dist < 0.02:
            log("not enough motion for the IMU initialization: the map is flagged for reset "
                "(bad IMU)")
            self.bad_imu = True

    def _temporal_chain(self, kf_id: int, length: int) -> np.ndarray:
        """The ``kf_prev_imu`` chain back from ``kf_id`` (inclusive), oldest
        first (the reference's vpOptimizableKFs, Optimizer.cc:2392-2410)."""
        chain = [int(kf_id)]
        k = int(kf_id)
        while len(chain) < length:
            p = int(self.map.kf_prev_imu[k])
            if p < 0 or not self.map.kf_valid[p]:
                break
            chain.append(p)
            k = p
        return np.asarray(chain[::-1], np.int64)

    def _build_vi_problem(self, chain: np.ndarray, n_fixed: int):
        """The VI-BA problem over the temporal keyframe ``chain`` (oldest
        first, the first ``n_fixed`` states anchors): the landmarks the
        optimizable states see (at most ``VI_LM_CAP``, ``VI_OBS_CAP``
        observations each) and one factor per consecutive pair, invalid
        where the chain has no preintegration between them."""
        m = self.map
        K = len(chain)
        up, f32 = self._dev, torch.float32
        Twb = lie.np_se3_inv(lie.np_se3_mul(np.tile(self._T_bc, (K, 1)), m.kf_pose[chain]))
        tbl = m.kf_lm_idx[chain[n_fixed:]]
        lm_ids = np.unique(tbl[tbl >= 0])
        lm_ids = lm_ids[m.lm_valid[lm_ids]][:VI_LM_CAP]
        obs_kf, obs_feat, obs_mask, obs_uv, obs_ur = m.gather_observations(chain, lm_ids,
                                                                            VI_OBS_CAP)
        kf_global = chain[np.clip(obs_kf, 0, K - 1)]
        octv = np.clip(m.kf_octave[kf_global, obs_feat].astype(np.int64), 0,
                       self.inv_sigma2.shape[0] - 1)
        preints, valid = [], []
        for a in range(K - 1):
            k_next = int(chain[a + 1])
            ok = k_next in m.imu_preint and int(m.kf_prev_imu[k_next]) == int(chain[a])
            valid.append(ok)
            preints.append(m.imu_preint[k_next] if ok else imu_frontend.zero_preint_numpy())
        meas = imu_frontend.stack_preints(preints, self.device)
        dts = np.maximum(np.array([float(t[0]) for t in preints]), 1e-3)
        icfg = self.cfg.imu
        info_bg = np.minimum(1.0 / np.maximum(icfg.gyro_walk ** 2 * dts, 1e-12), 1e8)
        info_ba = np.minimum(1.0 / np.maximum(icfg.acc_walk ** 2 * dts, 1e-12), 1e8)
        fixed = np.zeros(K, bool)
        fixed[:n_fixed] = True
        if not fixed.any():
            fixed[0] = True
        problem = inertial_ba.VIBAProblem(
            Twb=up(Twb, f32), vel=up(m.kf_vel[chain], f32), bg=up(m.kf_bg[chain], f32),
            ba=up(m.kf_ba[chain], f32), state_fixed=up(fixed, torch.bool),
            state_valid=torch.ones(K, dtype=torch.bool, device=self.device),
            T_cb=up(self._T_cb, f32), landmarks=up(m.lm_pos[lm_ids], f32),
            lm_valid=torch.ones(lm_ids.size, dtype=torch.bool, device=self.device),
            obs_kf=up(obs_kf, torch.int64), obs_uv=up(obs_uv, f32), obs_ur=up(obs_ur, f32),
            obs_inv_sigma2=self.inv_sigma2[up(octv, torch.int64)],
            obs_mask=up(obs_mask, torch.bool),
            pair_i=torch.arange(K - 1, device=self.device),
            pair_j=torch.arange(1, K, device=self.device), pair_meas=meas,
            pair_valid=up(np.asarray(valid, bool), torch.bool),
            info_bg=up(info_bg.astype(np.float32), f32),
            info_ba=up(info_ba.astype(np.float32), f32))
        return problem, lm_ids, (obs_kf, obs_feat, obs_mask)

    def local_inertial_bundle_adjustment(self, kf_id: int):
        """``Optimizer::LocalInertialBA``: 10 optimizable states of the
        temporal chain ending at ``kf_id`` and 5 fixed anchors before them,
        the joint visual, preintegration and bias-walk solve, written back."""
        chain = self._temporal_chain(kf_id, self.VI_OPT_WINDOW + self.VI_FIX_WINDOW)
        if len(chain) < 3:
            return
        n_fixed = max(len(chain) - self.VI_OPT_WINDOW, 1)
        problem, lm_ids, obs = self._build_vi_problem(chain, n_fixed)
        res = inertial_ba.vi_bundle_adjust(problem, self.geo_cam,
                                           iterations=LOCAL_VIBA_ITERATIONS)
        self._vi_writeback(chain, n_fixed, lm_ids, res, *obs)
        self.counts["vi_lba_runs"] += 1

    def full_inertial_ba(self, kf_id: int):
        """``Optimizer::FullInertialBA`` over the whole temporal chain
        ending at ``kf_id`` (at most ``FULL_VIBA_MAX_STATES``: a longer chain
        anchors on its oldest retained state, logged), its first state fixed."""
        chain = self._temporal_chain(kf_id, FULL_VIBA_MAX_STATES)
        if len(chain) == FULL_VIBA_MAX_STATES:
            log("full inertial BA: the temporal chain hit the %d-state cap; older states "
                "anchor" % FULL_VIBA_MAX_STATES)
        if len(chain) < 4:
            return
        with record_function("map.full_inertial_ba"):
            problem, lm_ids, obs = self._build_vi_problem(chain, n_fixed=1)
            res = inertial_ba.vi_bundle_adjust(problem, self.geo_cam,
                                               iterations=FULL_VIBA_ITERATIONS)
            self._vi_writeback(chain, 1, lm_ids, res, *obs)
        self.counts["full_inertial_ba_runs"] += 1

    def _vi_writeback(self, chain, n_fixed, lm_ids, res, obs_kf, obs_feat, obs_mask):
        """The solved states and landmarks into the map (one download);
        observations classified outlier are unbound."""
        m = self.map
        K, M = len(chain), lm_ids.size
        down = torch.cat([res.Twb.reshape(-1), res.vel.reshape(-1), res.bg.reshape(-1),
                          res.ba.reshape(-1), res.landmarks.reshape(-1),
                          res.obs_inlier.to(torch.float32).reshape(-1)]).cpu().numpy()
        Twb, vel, bg, ba, lms, inl = np.split(down, np.cumsum([7 * K, 3 * K, 3 * K, 3 * K,
                                                               3 * M]))
        Tcw = lie.np_se3_mul(np.tile(self._T_cb, (K, 1)),
                             lie.np_se3_inv(Twb.reshape(K, 7).astype(np.float32)))
        upd = chain[n_fixed:]
        m.kf_pose[upd] = Tcw[n_fixed:]
        m.kf_vel[upd] = vel.reshape(K, 3)[n_fixed:]
        m.kf_bg[upd] = bg.reshape(K, 3)[n_fixed:]
        m.kf_ba[upd] = ba.reshape(K, 3)[n_fixed:]
        if M:
            m.lm_pos[lm_ids] = lms.reshape(M, 3)
        bad = (inl.reshape(obs_mask.shape) < 0.5) & obs_mask
        if bad.any():
            rows, cols = np.nonzero(bad)
            m.kf_lm_idx[chain[obs_kf[rows, cols]], obs_feat[rows, cols]] = -1
            m.cull_orphans(lm_ids[np.unique(rows)])
            self.counts["vi_outlier_obs"] += int(bad.sum())
        m.version += 1

    def maybe_viba(self, timestamp: float):
        """The VIBA1 / VIBA2 schedule after IMU initialization
        (LocalMapping.cc:218-256): a full inertial BA 5 s after the
        initialization and another 15 s after it."""
        m = self.map
        if not (self.cfg.inertial and m.imu_initialized) or self._imu_init_time is None:
            return
        due = {0: 5.0, 1: 15.0}.get(self._viba_stage)
        if due is None or timestamp - self._imu_init_time < due:
            return
        kfs = m.valid_kf_ids()
        if kfs.size:
            self.full_inertial_ba(int(kfs[-1]))
        self._viba_stage += 1

    def maybe_initialize_imu(self):
        """The 3-stage IMU initialization (``LocalMapping::InitializeIMU``):
        gyro bias from the rotations, the linear gravity / velocity / scale
        bootstrap, the joint refinement (``optim.inertial.imu_initialization``;
        the scale is free for IMU_MONOCULAR only), once the map has 6
        keyframes over 1 s, as in the JAX package; for IMU_MONOCULAR the
        reference's 10 over 2 s and accel-bias prior 1e10 (the JAX package's
        1 s and 1e6 let the monocular scale and gravity take the visual
        noise and the accel bias: a third of the true scale on the
        EuRoC-shaped drive of ``chip_smoke.py`` phase 13, in both packages).
        On success the map is
        re-expressed gravity-down and metric (``Map::ApplyScaledRotation``),
        the keyframes take their velocities and biases, and the device
        feature mirror is reset (the rescale moved its pseudo-stereo
        columns). Returns the applied Sim3 (new ← old world) or None."""
        m = self.map
        if not self.cfg.inertial or m.imu_initialized:
            return None
        mono = self.cfg.sensor == IMU_MONOCULAR
        min_kf, min_span_s, prior_a = (10, 2.0, 1e10) if mono else (6, 1.0, 1e6)
        kfs = m.valid_kf_ids()
        if kfs.size < min_kf:
            return None
        if float(m.kf_timestamp[kfs[-1]] - m.kf_timestamp[kfs[0]]) < min_span_s:
            return None
        pairs_ok = np.zeros(kfs.size - 1, bool)
        preints = []
        for i in range(kfs.size - 1):
            k = int(kfs[i + 1])
            if k in m.imu_preint and int(m.kf_prev_imu[k]) == int(kfs[i]):
                pairs_ok[i] = True
                preints.append(m.imu_preint[k])
            else:
                preints.append(imu_frontend.zero_preint_numpy())
        if pairs_ok.sum() < min_kf - 1:
            return None
        K = kfs.size
        Twb = lie.np_se3_inv(lie.np_se3_mul(np.tile(self._T_bc, (K, 1)), m.kf_pose[kfs]))
        with record_function("map.imu_init"):
            out = inertial.imu_initialization(
                self._dev(Twb, torch.float32), imu_frontend.stack_preints(preints, self.device),
                self._dev(pairs_ok, torch.bool), prior_a=prior_a, fix_scale=not mono)
            down = torch.cat([out["scale"].reshape(1), out["cost"].reshape(1), out["Rwg"],
                              out["velocities"].reshape(-1), out["bias"].bg,
                              out["bias"].ba]).cpu().numpy()
        scale, cost, Rwg = float(down[0]), float(down[1]), down[2:6]
        self.counts["imu_init_attempts"] += 1
        if not np.isfinite(cost) or scale < 1e-2 or scale > 1e2:
            return None
        # the new world: gravity down and metric, X_new = s · R_gw · X_old
        q_gw = np.concatenate([Rwg[:1], -Rwg[1:4]]).astype(np.float32)
        S_align = np.concatenate([q_gw, np.zeros(3, np.float32),
                                  [np.float32(scale)]]).astype(np.float32)
        # the velocities are metric in the old world frame
        m.kf_vel[kfs] = down[6:6 + 3 * K].reshape(K, 3)
        m.kf_bg[kfs] = down[6 + 3 * K:9 + 3 * K]
        m.kf_ba[kfs] = down[9 + 3 * K:12 + 3 * K]
        apply_scaled_rotation(m, S_align, vel_metric_preserved=True)
        self.dev_cache.reset(m.capacity_kf)   # the rescale moved the mirrored uR
        m.imu_initialized = True
        self._imu_init_time = float(m.kf_timestamp[kfs[-1]])
        self._viba_stage = 0
        return S_align

    def _relink_imu_chain(self, k: int) -> bool:
        """Before keyframe ``k`` of an inertial map is culled, its successor
        on the temporal chain absorbs its preintegration
        (``Preintegrated::MergePrevious``, LocalMapping.cc ~990-1040). False
        when the chain cannot be kept (then ``k`` stays): ``k`` is the
        chain's tail, a link is missing, or the merged span exceeds 3 s
        (0.5 s before IMU initialization)."""
        m = self.map
        p = int(m.kf_prev_imu[k])
        succ = np.nonzero(m.kf_prev_imu[: m.n_kf] == k)[0]
        if succ.size == 0:
            return False          # the chain's tail: tracking integrates against it
        n = int(succ[0])
        if p < 0 or k not in m.imu_preint or n not in m.imu_preint:
            return False
        span = float(m.kf_timestamp[n] - m.kf_timestamp[p])
        if span > (3.0 if m.imu_initialized else 0.5):
            return False
        merged = pre.merge(imu_frontend.preint_from_numpy(m.imu_preint[k], self.device),
                           imu_frontend.preint_from_numpy(m.imu_preint[n], self.device))
        m.imu_preint[n] = imu_frontend.preint_to_numpy(merged)
        m.kf_prev_imu[n] = p
        del m.imu_preint[k]
        m.kf_prev_imu[k] = -1
        self.counts["imu_chain_relinks"] += 1
        return True
