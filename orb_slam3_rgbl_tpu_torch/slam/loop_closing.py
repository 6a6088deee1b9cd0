"""Loop closing: detection, Sim3 verification, map correction (counterpart
of ``orb_slam3_rgbl_tpu.slam.loop_closing``; reference ``LoopClosing.cc``).

``NewDetectCommonRegions`` → ``DetectCommonRegionsFromBoW`` (BoW candidates
→ Sim3 RANSAC → guided projection → OptimizeSim3) → ``CorrectLoop`` (Sim3
propagation of the covisible window, duplicate fusion, essential-graph
optimization) → global BA. Candidates pass a 3-consecutive-keyframe
temporal-consistency gate; the essential graph holds the spanning chain,
covisibility edges of weight ≥ 100 and all accumulated loop edges;
``SearchAndFuse`` projects the loop-side landmarks into the Sim3-corrected
covisible window before the pose graph.

The host half (gates, tie rules, map surgery) is numpy, as in the JAX
package. The device half — the keyframe database's scores, descriptor and
windowed matching against the keyframes' device mirror, Sim3 RANSAC and
refinement, the pose graph and the global BA — runs on the closer's device
with the real numbers of pairs, nodes, edges and observations. Each stage
runs inside a ``torch.profiler.record_function`` span named
``loop.<stage>`` (``LOOP_SPANS``), and ``stats`` keeps what each keyframe,
candidate and event cost and found.

With ``cfg.vocab_path`` set the database scores with that trained tree
vocabulary (``retrieval.tree_vocab``), loaded onto the closer's device; the
LSH words of ``retrieval.vocab`` otherwise. Cross-map merging lives in
``slam.merging`` and ``System``.

The halves are split the way ``System``'s worker threads call them:
``detect_only`` (index, and with ``index_only`` nothing more, the loop
worker's load shedding) reads the map and mutates only the database and
the consistency state; ``apply_event`` mutates the whole map;
``_gba_assemble`` snapshots the map, ``_gba_iterate`` solves on the
snapshot alone (stopping between chunks when its ``abort_event`` is set)
and ``_apply_gba`` writes back. The RANSAC draws are taken under
``rng_lock``, which the owner of the generator shares with its other users.

An inertial map whose IMU is initialized corrects its loop with the 4-DoF
essential graph (translation and yaw; ``optimize_pose_graph_4dof``), and
its global BA is the whole-map inertial one (``optim/global_inertial_ba``:
every keyframe's pose, velocity and biases and every landmark, in one call
of ``GBA_VI_ITERATIONS`` LM iterations, as the reference's
``RunGlobalBundleAdjustment`` calls ``FullInertialBA(7)``,
``LoopClosing.cc:2284-2287``); the JAX package runs the visual global BA
there. Every other map keeps the visual global BA.
``prewarm`` has no counterpart: it warms XLA's compile tiers.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from orb_slam3_rgbl_tpu_torch.config import SlamConfig
from orb_slam3_rgbl_tpu_torch.device import resolve
from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.ops import matching
from orb_slam3_rgbl_tpu_torch.optim import global_ba, global_inertial_ba, pose_graph
from orb_slam3_rgbl_tpu_torch.optim.inertial_ba import VIBAProblem
from orb_slam3_rgbl_tpu_torch.optim.local_ba import BAProblem
from orb_slam3_rgbl_tpu_torch.optim import sim3 as sim3_opt
from orb_slam3_rgbl_tpu_torch.retrieval.keyframe_db import KeyFrameDatabase
from orb_slam3_rgbl_tpu_torch.retrieval.tree_vocab import TreeVocabulary
from orb_slam3_rgbl_tpu_torch.slam import ba_assembly, imu_frontend
from orb_slam3_rgbl_tpu_torch.slam.frame import inv_scale_sigma2
from orb_slam3_rgbl_tpu_torch.slam.local_mapping import DeviceKfCache, _i32_words
from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState, dedup_kf_bindings
from orb_slam3_rgbl_tpu_torch.utils.logging import log

LOOP_SPANS = ("loop.index", "loop.detect", "loop.verify", "loop.fuse", "loop.pose_graph",
              "loop.gba")
RANSAC_HYPOTHESES = 512
GBA_CG_ITERS = 64
GBA_CHUNK = 2   # LM iterations per solver call; damping and the Huber phase restart with each
GBA_VI_ITERATIONS = 7   # LM iterations of the inertial global BA, one call, Huber on each


class GBASnapshot(NamedTuple):
    """The global BA's snapshot (``LoopCloser._gba_assemble``): the
    whole-map problem, its keyframe ids and landmark ids, the poses and the
    landmarks' generations as they stood, the problem's sum tables, and
    the route picked for it: the camera, the solve
    (``solve(snapshot, iterations, abort_event)`` → result, None once
    aborted) and the plain cost (``cost(problem, cam)``)."""
    problem: Union[BAProblem, VIBAProblem]
    window: np.ndarray
    lm_ids: np.ndarray
    pose_before: np.ndarray
    lm_gen_before: np.ndarray
    segments: object
    cam: object
    solve: Callable
    cost: Callable


@dataclasses.dataclass
class LoopEvent:
    kf_cur: int
    kf_matched: int
    n_inliers: int
    S12: np.ndarray  # Sim3 cur←matched (camera frames)


class LoopCloser:
    def __init__(self, config: SlamConfig, map_state: MapState, run_gba: bool = True,
                 device=None, generator: Optional[torch.Generator] = None,
                 dev_cache: Optional[DeviceKfCache] = None):
        """``generator``: the caller's source of RANSAC draws (a CPU
        generator; the draws are uploaded). ``dev_cache``: the mapping
        plane's device mirror of keyframe features, shared when there is
        one; without it the closer keeps its own, backfilled from the map."""
        self.cfg = config
        self.cam = config.camera
        self.map = map_state
        self.device = resolve(device)
        self.generator = generator
        self.rng_lock = threading.Lock()   # replaced by an owner that shares the generator
        self.dev_cache = dev_cache if dev_cache is not None else DeviceKfCache(
            map_state.n_features, device=self.device)
        vocabulary = (TreeVocabulary.load(config.vocab_path, device=self.device)
                      if config.vocab_path else None)
        self.db = KeyFrameDatabase(map_state.capacity_kf, vocabulary=vocabulary,
                                   device=self.device)
        self.fix_scale = config.sensor != 0  # everything but pure mono
        self.last_loop_kf = -9999
        self.events: list = []
        # temporal-consistency state: [(covisibility group set, count)]
        # (reference mvConsistentGroups, consistency threshold 3)
        self.consistency_th = 3
        self._consistent_groups: list = []
        # accumulated loop constraints fed to every future essential graph
        # (reference KeyFrame::mLoopEdges): (kf_a, kf_b, S_ab (8,), weight)
        self.extra_edges: list = []
        self.run_gba = run_gba
        # wired by System: schedules the global BA after a correction;
        # None → ``_global_ba()`` with its default budget
        self.gba_dispatch = None
        self._pending_fusion = None
        # what the plane did and what it cost on the host's clock
        self.stats = {"keyframes": [], "candidates": [], "events": []}
        self.counts = {"inertial_gba_runs": 0}

    def _dev(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def on_keyframe(self, kf_id: int) -> Optional[LoopEvent]:
        """Index the new keyframe, detect and (if verified) correct a loop.
        Returns the LoopEvent when a loop was closed."""
        event = self.detect_only(kf_id)
        if event is not None:
            self.apply_event(event)
        return event

    def detect_only(self, kf_id: int, index_only: bool = False) -> Optional[LoopEvent]:
        """Detection half: reads the map, mutates only the database and the
        consistency state. ``index_only``: index the keyframe and stop (the
        loop worker's load shedding while the mapping plane is busy: the
        database must still see every keyframe)."""
        m = self.map
        t0 = time.perf_counter()
        with record_function("loop.index"):
            # index first: detect_candidates queries kf_id's stored
            # signature (itself and its covisibles are excluded)
            c = self.dev_cache.ensure(m, [kf_id])
            self.db.add(kf_id, c.d_desc[kf_id], c.d_valid[kf_id])
        t1 = time.perf_counter()
        event = None
        # reference skips detection until the map holds ≥ 12 KFs
        # (LoopClosing.cc:356) and right after a correction
        if not index_only and m.n_kf >= 12 and kf_id > self.last_loop_kf + 5:
            with record_function("loop.detect"):
                event = self._detect(kf_id)
        self.stats["keyframes"].append({
            "kf": int(kf_id), "index_ms": (t1 - t0) * 1e3,
            "detect_ms": (time.perf_counter() - t1) * 1e3, "index_only": index_only})
        return event

    def apply_event(self, event: LoopEvent, run_pose_graph: bool = True):
        """Correction half: mutates the whole map, so it runs serialized
        with every other map mutation (the reference stops LocalMapping for
        CorrectLoop)."""
        self._correct_loop(event, run_pose_graph=run_pose_graph)
        self.last_loop_kf = event.kf_cur
        self.events.append(event)

    # ------------------------------------------------------------------
    def _detect(self, kf_id: int) -> Optional[LoopEvent]:
        m = self.map
        cands = self.db.detect_candidates(m, kf_id, n_candidates=3)
        covis = None
        gated = []
        for cand in cands:
            # candidates temporally adjacent are odometry, not loops
            if abs(int(m.kf_frame_id[cand]) - int(m.kf_frame_id[kf_id])) < 30:
                continue
            # candidates already sharing landmarks are connected structure
            # (the tracker re-entered a mapped region), not a loop
            if covis is None:
                covis = m.covisibility_weights(kf_id)
            if covis[cand] > 5:
                continue
            gated.append(int(cand))
        # temporal consistency (reference LoopClosing.cc:396): a
        # candidate's covisibility group must intersect groups seen on the
        # previous consecutive keyframes ≥ consistency_th times before
        # geometric verification is attempted
        new_groups = []
        consistent = []
        for cand in gated:
            group = set(int(k) for k in m.best_covisible(cand, 10, min_weight=1))
            group.add(cand)
            count = 0
            for pg, pc in self._consistent_groups:
                if group & pg:
                    count = max(count, pc + 1)
            new_groups.append((group, count))
            # count here is nCurrentConsistency (prev + 1): a candidate
            # needs th+1 consecutive detecting keyframes
            if count >= self.consistency_th:
                consistent.append(cand)
        self._consistent_groups = new_groups
        for cand in consistent:
            with record_function("loop.verify"):
                ev = self._verify_candidate(kf_id, cand)
            if ev is not None:
                self._consistent_groups = []
                return ev
        return None

    def _ransac_draws(self, n_pairs: int) -> torch.Tensor:
        """(RANSAC_HYPOTHESES, 3) minimal-set draws in [0, n_pairs) from the
        caller's generator."""
        if self.generator is None:
            raise ValueError("LoopCloser needs the caller's torch.Generator for Sim3 RANSAC")
        with self.rng_lock:
            return torch.randint(0, n_pairs, (RANSAC_HYPOTHESES, 3), generator=self.generator,
                                 device=self.generator.device)

    def _pair_tensors(self, kf_id, cand, f1, f2, lm1, lm2):
        """The Sim3 solvers' arguments for feature pairs (f1 of ``kf_id``,
        f2 of ``cand``) bound to landmarks (lm1, lm2): camera-frame points,
        keypoints and pixel variances, on the device."""
        m = self.map
        p1 = lie.np_se3_apply(m.kf_pose[kf_id], m.lm_pos[lm1])
        p2 = lie.np_se3_apply(m.kf_pose[cand], m.lm_pos[lm2])
        # the reference's literal 1.2, not cfg.orb.scale_factor
        s1 = (1.2 ** (2 * m.kf_octave[kf_id, f1])).astype(np.float32)
        s2 = (1.2 ** (2 * m.kf_octave[cand, f2])).astype(np.float32)
        f32 = torch.float32
        return (self._dev(p1, f32), self._dev(p2, f32), self._dev(m.kf_uv[kf_id, f1], f32),
                self._dev(m.kf_uv[cand, f2], f32), self._dev(s1, f32), self._dev(s2, f32))

    def _verify_candidate(self, kf_id: int, cand: int) -> Optional[LoopEvent]:
        """Descriptor match on landmark-bound features → Sim3 RANSAC →
        refinement → guided matches and a second refinement; thresholds
        follow the reference's 20 (BoW) / ≥ 25 (projection) ladder."""
        t0 = time.perf_counter()
        rec = {"kf": int(kf_id), "cand": int(cand), "pairs": 0, "ransac": 0, "refined": 0,
               "guided_pairs": 0, "guided": 0, "accepted": False}
        self.stats["candidates"].append(rec)
        try:
            return self._verify_candidate_inner(kf_id, cand, rec)
        finally:
            rec["ms"] = (time.perf_counter() - t0) * 1e3

    def _verify_candidate_inner(self, kf_id: int, cand: int, rec: dict) -> Optional[LoopEvent]:
        m = self.map
        b1 = m.kf_lm_idx[kf_id] >= 0
        b2 = m.kf_lm_idx[cand] >= 0
        if b1.sum() < 20 or b2.sum() < 20:
            return None
        c = self.dev_cache.ensure(m, [kf_id, cand])
        d = matching.distance_table(c.d_desc[kf_id], c.d_desc[cand],
                                    self._dev(b1, torch.bool), self._dev(b2, torch.bool))
        idx, _ = matching.mutual_best_match(d, c.d_angle[kf_id], c.d_angle[cand],
                                            th=matching.TH_LOW, ratio=0.75, check_rotation=True)
        idx = idx.cpu().numpy()
        f1 = np.nonzero(idx >= 0)[0]
        if f1.size < 20:
            return None
        f2 = idx[f1]
        lm1 = m.kf_lm_idx[kf_id, f1]
        lm2 = m.kf_lm_idx[cand, f2]
        # same-id pairs are covisible structure, not loop evidence
        distinct = lm1 != lm2
        f1, f2, lm1, lm2 = f1[distinct], f2[distinct], lm1[distinct], lm2[distinct]
        rec["pairs"] = int(f1.size)
        if f1.size < 20:
            return None

        p1, p2, uv1, uv2, s1, s2 = self._pair_tensors(kf_id, cand, f1, f2, lm1, lm2)
        all_pairs = torch.ones(f1.size, dtype=torch.bool, device=self.device)
        res = sim3_opt.sim3_ransac(p1, p2, uv1, uv2, s1, s2, all_pairs, self.cam,
                                   n_hypotheses=RANSAC_HYPOTHESES, fix_scale=self.fix_scale,
                                   draws=self._ransac_draws(f1.size))
        # the refinement is enqueued before the RANSAC count is read: one
        # download serves both gates
        S12, inl, n = sim3_opt.optimize_sim3(res.S12, p1, p2, uv1, uv2, 1.0 / s1, 1.0 / s2,
                                             res.inliers, self.cam, fix_scale=self.fix_scale)
        down = torch.cat([S12, res.n_inliers[None].to(S12.dtype), n[None].to(S12.dtype),
                          inl.to(S12.dtype)]).cpu().numpy()
        S12_np, n_ransac, n = down[:8].astype(np.float32), int(down[8]), int(down[9])
        inl_np = down[10:] > 0.5
        rec["ransac"], rec["refined"] = n_ransac, n
        if n_ransac < 20 or n < 25:
            return None

        # SearchBySim3 escalation: project the candidate neighbourhood's
        # landmarks into the current keyframe through the estimated Sim3 to
        # grow the correspondence set, then refine once more with everything
        ext = self._guided_sim3_matches(kf_id, cand, S12_np, exclude_f1=f1[inl_np])
        if ext is not None:
            g_f1, g_f2, g_lm1, g_lm2 = ext
            a_f1 = np.concatenate([f1[inl_np], g_f1])
            a_f2 = np.concatenate([f2[inl_np], g_f2])
            a_lm1 = np.concatenate([lm1[inl_np], g_lm1])
            a_lm2 = np.concatenate([lm2[inl_np], g_lm2])
            rec["guided_pairs"] = int(a_f1.size)
            q1, q2, qu1, qu2, w1, w2 = self._pair_tensors(kf_id, cand, a_f1, a_f2, a_lm1, a_lm2)
            S12b, inl2, n2 = sim3_opt.optimize_sim3(
                self._dev(S12_np, torch.float32), q1, q2, qu1, qu2, 1.0 / w1, 1.0 / w2,
                torch.ones(a_f1.size, dtype=torch.bool, device=self.device), self.cam,
                fix_scale=self.fix_scale)
            down = torch.cat([S12b, n2[None].to(S12b.dtype), inl2.to(S12b.dtype)]).cpu().numpy()
            n2 = int(down[8])
            rec["guided"] = n2
            if n2 >= n:
                S12b_np = down[:8].astype(np.float32)
                if not self._verify_with_neighbors(kf_id, cand, S12b_np):
                    return None
                inl2_np = down[9:] > 0.5
                self._pending_fusion = (a_lm1[inl2_np], a_lm2[inl2_np])
                rec["accepted"] = True
                return LoopEvent(kf_cur=kf_id, kf_matched=cand, n_inliers=n2, S12=S12b_np)

        if not self._verify_with_neighbors(kf_id, cand, S12_np):
            return None
        # landmark fusion pairs: current landmark → matched (older) landmark
        self._pending_fusion = (lm1[inl_np], lm2[inl_np])
        rec["accepted"] = True
        return LoopEvent(kf_cur=kf_id, kf_matched=cand, n_inliers=n, S12=S12_np)

    def _verify_with_neighbors(self, kf_id: int, cand: int, S12: np.ndarray,
                               min_matches: int = 25, need_pass: int = 1) -> bool:
        """Multi-keyframe geometric verification (reference
        ``DetectCommonRegionsFromBoW``, LoopClosing.cc:843-897): the
        hypothesis is projected into covisible keyframes of the current one
        and must find matches there too. A perceptually aliased match fits
        one view but not its neighbourhood."""
        m = self.map
        neighbors = [int(k) for k in m.best_covisible(kf_id, 3, min_weight=1)
                     if int(k) != cand][:2]
        if not neighbors:
            return True   # nothing to check against (tiny map)
        T_cur_inv = lie.np_se3_inv(m.kf_pose[kf_id])
        passed = 0
        for nk in neighbors:
            # hypothesis pose of neighbour nk in the candidate's world:
            # S_nk_w = sim3(T_nk_cur) ∘ S12 ∘ sim3(T_cand_w)
            T_nk_cur = lie.np_se3_mul(m.kf_pose[nk], T_cur_inv)
            S_nk_w = lie.np_sim3_mul(
                lie.np_sim3_from_se3(T_nk_cur),
                lie.np_sim3_mul(S12, lie.np_sim3_from_se3(m.kf_pose[cand])))
            if self._count_loop_matches(nk, cand, S_nk_w) >= min_matches:
                passed += 1
                if passed >= need_pass:
                    return True
        return False

    def _neighborhood_landmarks(self, kf: int, n_covisible: int, cap: int) -> np.ndarray:
        """Live landmarks seen by ``kf`` and its best covisibles, ascending,
        at most ``cap``."""
        m = self.map
        kfs = [kf] + [int(k) for k in m.best_covisible(kf, n_covisible, min_weight=1)]
        tbl = m.kf_lm_idx[np.asarray(kfs)]
        lms = np.unique(tbl[tbl >= 0])
        return lms[m.lm_valid[lms]][:cap]

    def _project_and_match(self, lms: np.ndarray, S_kw: np.ndarray, kf: int, kp_valid,
                           radius: float, th: float):
        """Project landmarks ``lms`` through the Sim3 ``S_kw`` into keyframe
        ``kf`` (on the host, as the gates are) and windowed-match them
        against its features on the device, octaves ignored. Returns
        (idx (n,) matched feature or −1, dist (n,)) as numpy."""
        m = self.map
        pc = lie.np_sim3_apply(S_kw, m.lm_pos[lms])
        z = pc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = self.cam.fx * pc[:, 0] / z + self.cam.cx
            v = self.cam.fy * pc[:, 1] / z + self.cam.cy
        ok = z > 0.1
        ok &= np.nan_to_num((u >= 0) & (u < self.cam.width)
                            & (v >= 0) & (v < self.cam.height), nan=False)
        proj_uv = np.stack([np.nan_to_num(u), np.nan_to_num(v)], 1).astype(np.float32)
        n = lms.size
        c = self.dev_cache.ensure(m, [kf])
        zeros_p = torch.zeros(n, dtype=torch.int32, device=self.device)
        zeros_k = torch.zeros(m.n_features, dtype=torch.int32, device=self.device)
        idx, dist = matching.windowed_projection_match(
            self._dev(proj_uv, torch.float32), self._dev(ok, torch.bool),
            self._dev(_i32_words(m.lm_desc[lms]), torch.int32), zeros_p,
            c.d_uv[kf], c.d_valid[kf] if kp_valid is None else self._dev(kp_valid, torch.bool),
            c.d_desc[kf], zeros_k,
            torch.full((n,), radius, dtype=torch.float32, device=self.device), th=th)
        both = torch.stack([idx.to(torch.float32), dist]).cpu().numpy()   # one download
        return both[0].astype(np.int64), both[1]

    def _count_loop_matches(self, kf: int, cand: int, S_kw: np.ndarray,
                            radius: float = 7.5) -> int:
        """Project the candidate neighbourhood's landmarks through the
        hypothesis Sim3 into keyframe ``kf`` and count windowed descriptor
        matches (the counting half of SearchByProjection)."""
        lms = self._neighborhood_landmarks(cand, 10, self.map.n_features)
        if lms.size == 0:
            return 0
        idx, _ = self._project_and_match(lms, S_kw, kf, None, radius, matching.TH_HIGH)
        return int((idx >= 0).sum())

    def _guided_sim3_matches(self, kf_id: int, cand: int, S12: np.ndarray,
                             exclude_f1: np.ndarray, radius: float = 7.5):
        """Sim3-guided projection matching: candidate-side landmarks (its
        covisible neighbourhood) projected into the current keyframe
        through ``S12 · T2w``; windowed descriptor match against features
        not yet in the correspondence set."""
        m = self.map
        lms = self._neighborhood_landmarks(cand, 10, m.n_features)
        if lms.size == 0:
            return None
        S_1w = lie.np_sim3_mul(np.asarray(S12, np.float32),
                               lie.np_sim3_from_se3(m.kf_pose[cand]))
        kp_valid = (m.kf_lm_idx[kf_id] >= 0) & m.kf_feat_valid[kf_id]
        kp_valid[exclude_f1] = False
        idx, dist = self._project_and_match(lms, S_1w, kf_id, kp_valid, radius, matching.TH_HIGH)
        hit = np.nonzero(idx >= 0)[0]
        if hit.size == 0:
            return None
        order = hit[np.argsort(dist[hit], kind="stable")]
        feats_of = idx[order]
        first = np.unique(feats_of, return_index=True)[1]
        win_p, win_f = order[first], feats_of[first]
        g_lm2 = lms[win_p]
        g_f1 = win_f
        g_lm1 = m.kf_lm_idx[kf_id, g_f1]
        sel = (g_lm1 >= 0) & (g_lm1 != g_lm2)
        if not sel.any():
            return None
        g_f1, g_lm1, g_lm2 = g_f1[sel], g_lm1[sel], g_lm2[sel]
        # feature index of lm2 in the candidate keyframe (for uv/octave)
        pos_in_cand = np.full(m.capacity_lm, -1, np.int32)
        row = m.kf_lm_idx[cand]
        pos_in_cand[row[row >= 0]] = np.nonzero(row >= 0)[0]
        g_f2 = pos_in_cand[g_lm2]
        sel2 = g_f2 >= 0
        return g_f1[sel2], g_f2[sel2], g_lm1[sel2], g_lm2[sel2]

    # ------------------------------------------------------------------
    def _search_and_fuse(self, ev: LoopEvent) -> int:
        """Reference ``SearchAndFuse`` (LoopClosing.cc:2115) preceded by the
        Sim3 propagation of the current covisible window
        (LoopClosing.cc:1115-1177): project the loop-side landmarks into the
        current keyframe's covisible window through the loop-corrected
        poses, replace duplicates and add missed observations. The
        corrected poses serve the projection only: the pose graph writes
        the final geometry. Returns the number of landmarks replaced."""
        m = self.map
        window = [int(k) for k in m.best_covisible(ev.kf_cur, 30, min_weight=1)]
        window = [ev.kf_cur] + [k for k in window if k != ev.kf_cur]
        # corrected Sim3 world→cam of the current KF: S_cw = S12 · T_mw
        S_cw = lie.np_sim3_mul(ev.S12.astype(np.float32),
                               lie.np_sim3_from_se3(m.kf_pose[ev.kf_matched]))
        T_cur_inv = lie.np_se3_inv(m.kf_pose[ev.kf_cur])

        loop_lms = self._neighborhood_landmarks(ev.kf_matched, 15, 2 * m.n_features)
        if loop_lms.size == 0:
            return 0
        identity = np.arange(m.capacity_lm, dtype=np.int32)
        remap = identity.copy()
        for k in window[:12]:
            # corrected pose of window KF k: S_kw = (T_kc as Sim3) · S_cw
            T_kc = lie.np_se3_mul(m.kf_pose[k], T_cur_inv)
            S_kw = lie.np_sim3_mul(lie.np_sim3_from_se3(T_kc), S_cw)
            idx, d = self._project_and_match(loop_lms, S_kw, k, None, 4.0, matching.TH_LOW)
            hit = np.nonzero(idx >= 0)[0]
            if hit.size == 0:
                continue
            order = hit[np.argsort(d[hit], kind="stable")]
            feats_of = idx[order]
            first = np.unique(feats_of, return_index=True)[1]
            win_p, win_f = order[first], feats_of[first]
            src = loop_lms[win_p]
            tgt = m.kf_lm_idx[k, win_f]
            # a landmark already bound at another slot of this keyframe
            # must not bind twice (reference Fuse: MapPoint::IsInKeyFrame)
            row = m.kf_lm_idx[k]
            present = np.zeros(m.capacity_lm, bool)
            present[row[row >= 0]] = True
            free = (tgt < 0) & ~present[src]
            m.kf_lm_idx[k, win_f[free]] = src[free]
            dup = (tgt >= 0) & (tgt != src)
            if dup.any():
                # the loop-side landmark always wins (reference
                # SearchAndFuse replaces the current MapPoints by the loop
                # points unconditionally): the old side's geometry is the
                # trusted one
                a, b = src[dup], tgt[dup]
                fresh = a != b
                remap[b[fresh]] = a[fresh]
        n_replaced = 0
        if (remap != identity).any():
            for _ in range(4):
                nxt = remap[remap]
                if np.array_equal(nxt, remap):
                    break
                remap = nxt
            bound = m.kf_lm_idx >= 0
            m.kf_lm_idx[bound] = remap[m.kf_lm_idx[bound]]
            losers = np.nonzero(remap != identity)[0]
            winners = remap[losers]
            np.add.at(m.lm_found, winners, m.lm_found[losers])
            np.add.at(m.lm_visible, winners, m.lm_visible[losers])
            with m.alloc_lock:
                m.lm_valid[losers] = False
                m.lm_gen[losers] += 1
                m.lm_free.extend(int(i) for i in losers)
            n_replaced = int(losers.size)
        # restore the one-observation-per-(KF, landmark) invariant after
        # every fusion pass (Replace collisions can alias two slots)
        dedup_kf_bindings(m)
        return n_replaced

    def _essential_edges(self, valid, slot, ev: LoopEvent):
        """Essential-graph edge set (reference ``OptimizeEssentialGraph``):
        sequential spanning chain + covisibility edges of weight ≥ 100 +
        all accumulated loop edges + the new loop constraint. Structural
        edges measure the current relative geometry, in one batch."""
        m = self.map
        K = valid.size
        ei = list(range(1, K))
        ej = list(range(0, K - 1))
        w = [1.0] * (K - 1)
        _, W = m.covisibility_matrix()
        hi, hj = np.nonzero(np.triu(W >= 100, k=1))
        adjacent = np.abs(hi - hj) <= 1   # the chain already covers these
        hi, hj = hi[~adjacent], hj[~adjacent]
        ei += hi.tolist()
        ej += hj.tolist()
        w += [1.0] * len(hi)
        nodes = np.concatenate([m.kf_pose[valid], np.ones((K, 1), np.float32)], 1)
        Si = nodes[np.asarray(ei, np.int64)]
        Sj = nodes[np.asarray(ej, np.int64)]
        Sij = list(lie.np_sim3_mul(Si, lie.np_sim3_inv(Sj)))
        # accumulated loop edges keep their measured constraints
        for (a, b, Sab, wt) in self.extra_edges:
            if m.kf_valid[a] and m.kf_valid[b] and int(a) in slot and int(b) in slot:
                ei.append(slot[int(a)])
                ej.append(slot[int(b)])
                Sij.append(np.asarray(Sab, np.float32))
                w.append(wt)
        # the new loop edge: S_cur←matched = S12
        ei.append(slot[ev.kf_cur])
        ej.append(slot[ev.kf_matched])
        w.append(10.0)
        Sij.append(ev.S12.astype(np.float32))
        return ei, ej, Sij, w

    def _pose_graph_problem(self, nodes, fixed_slot: int, ei, ej, Sij, w):
        K, E = len(nodes), len(ei)
        return pose_graph.PoseGraphProblem(
            nodes=self._dev(nodes, torch.float32),
            node_fixed=self._dev(np.arange(K) == fixed_slot, torch.bool),
            node_valid=torch.ones(K, dtype=torch.bool, device=self.device),
            edge_i=self._dev(np.asarray(ei, np.int64), torch.int64),
            edge_j=self._dev(np.asarray(ej, np.int64), torch.int64),
            edge_Sij=self._dev(np.stack(Sij), torch.float32),
            edge_weight=self._dev(np.asarray(w, np.float32), torch.float32),
            edge_valid=torch.ones(E, dtype=torch.bool, device=self.device))

    def _correct_loop(self, ev: LoopEvent, run_pose_graph: bool = True):
        """Reference ``CorrectLoop`` (LoopClosing.cc:969-1214): fuse the
        loop-side landmarks into the Sim3-corrected covisible window,
        optimize the essential graph over the full accumulated edge set,
        re-anchor landmarks, record the constraint for future graphs.
        ``run_pose_graph=False`` keeps the keyframe poses as they are (the
        fusion, the landmark writeback, the recorded edge and the global BA
        still run): ``tools/triage_ate.py``'s ``nopg`` mode."""
        m = self.map
        t0 = time.perf_counter()
        rec = {"kf_cur": int(ev.kf_cur), "kf_matched": int(ev.kf_matched),
               "n_inliers": int(ev.n_inliers), "gba": "skipped"}
        self.stats["events"].append(rec)
        # duplicate fusion first (in the corrected frame), so the pose
        # graph benefits from the strengthened covisibility
        with record_function("loop.fuse"):
            rec["fused_search"] = self._search_and_fuse(ev)
        rec["fuse_ms"] = (time.perf_counter() - t0) * 1e3

        t1 = time.perf_counter()
        valid = m.valid_kf_ids()
        K = valid.size
        slot = {int(k): i for i, k in enumerate(valid)}
        nodes = np.concatenate([m.kf_pose[valid], np.ones((K, 1), np.float32)], axis=1)
        old_nodes = nodes.copy()
        ei, ej, Sij, w = self._essential_edges(valid, slot, ev)
        rec["nodes"], rec["edges"] = int(K), len(ei)
        new_nodes, rec["pose_graph"] = old_nodes, "skipped"
        if run_pose_graph:
            with record_function("loop.pose_graph"):
                problem = self._pose_graph_problem(nodes, slot[ev.kf_matched], ei, ej, Sij, w)
                if self.cfg.inertial and m.imu_initialized:
                    # gravity makes roll, pitch and scale observable: translation
                    # and yaw only (OptimizeEssentialGraph4DoF, LoopClosing.cc:1183)
                    out = pose_graph.optimize_pose_graph_4dof(problem, iterations=20)
                    rec["pose_graph_dof"] = 4
                else:
                    out = pose_graph.optimize_pose_graph(problem, iterations=20,
                                                         fix_scale=self.fix_scale)
                costs = torch.stack([pose_graph.pose_graph_cost(problem, problem.nodes),
                                     pose_graph.pose_graph_cost(problem, out)])
                down = torch.cat([out.reshape(-1), costs]).cpu().numpy()
            new_nodes = down[:-2].reshape(K, 8).astype(np.float32)
            rec["pg_cost_before"], rec["pg_cost_after"] = float(down[-2]), float(down[-1])
            rec["pose_graph"] = "applied"
        # last line of defence: never write a diverged f32 solve into the
        # map. A correction moves poses by about the loop drift, not by
        # orders of magnitude: reject wholesale and keep the detected edge
        drift_bound = 10.0 * (1.0 + np.abs(old_nodes[:, 4:7]).max())
        if (not np.isfinite(new_nodes).all()
                or np.abs(new_nodes[:, 4:7] - old_nodes[:, 4:7]).max() > drift_bound):
            log("loop correction REJECTED: pose-graph result out of bounds")
            rec["pose_graph"] = "rejected"
            new_nodes = old_nodes
        rec["pose_graph_ms"] = (time.perf_counter() - t1) * 1e3
        # landmark correction via reference keyframes: X ← S_ref_new⁻¹ · S_ref_old · X.
        # A landmark whose reference keyframe was culled re-anchors through
        # the cull-redirect chain to a surviving observer
        lm_ids = np.nonzero(m.lm_valid)[0]
        ref = m.lm_ref_kf[lm_ids]
        ref_slot = np.array([slot.get(m.live_ref_kf(int(r)), 0) for r in ref], np.int64)
        S_old = old_nodes[ref_slot]
        S_new = new_nodes[ref_slot]
        m.lm_pos[lm_ids] = lie.np_sim3_apply(lie.np_sim3_inv(S_new),
                                             lie.np_sim3_apply(S_old, m.lm_pos[lm_ids]))
        # pose writeback (the scale drops into SE3 as in the reference)
        m.kf_pose[valid] = lie.np_sim3_to_se3(new_nodes)

        # fuse loop duplicate landmarks (current ones replaced by matched)
        if self._pending_fusion is not None:
            cur_lms, old_lms = self._pending_fusion
            rec["fused_pairs"] = self._fuse(cur_lms, old_lms)
            self._pending_fusion = None
        # the constraint joins every future essential graph
        self.extra_edges.append(
            (int(ev.kf_cur), int(ev.kf_matched), ev.S12.astype(np.float32), 10.0))
        m.version += 1
        rec["correct_ms"] = (time.perf_counter() - t0) * 1e3

        # global BA after the correction (the reference launches it when
        # the map holds < 200 KFs)
        if self.run_gba and m.n_kf < 200:
            if self.gba_dispatch is not None:
                self.gba_dispatch()
            else:
                self._global_ba()

    # ------------------------------------------------------------------
    def _global_ba(self, iterations: int = 6):
        t0 = time.perf_counter()
        with record_function("loop.gba"):
            snapshot = self._gba_assemble()
            cost_before = snapshot.cost(snapshot.problem, snapshot.cam)
            self._apply_gba(self._gba_iterate(snapshot, iterations))
        if self.stats["events"]:
            self.stats["events"][-1].update(gba_cost_before=float(cost_before),
                                            gba_ms=(time.perf_counter() - t0) * 1e3)

    def _gba_assemble(self) -> GBASnapshot:
        """Snapshot half of the global BA: the whole-map problem from the
        live arrays, with the per-pose observation table the solver sums
        through, the poses as they stand and the landmarks' generations.
        On an inertial map whose IMU is initialized the problem is the
        whole-map inertial one (``ba_assembly.build_full_vi_problem``) with
        its observation and pair tables. The one place that picks the
        visual or the inertial route: the snapshot carries its camera,
        solve and cost."""
        m = self.map
        inv_s2 = inv_scale_sigma2(self.cfg.orb.n_levels, self.cfg.orb.scale_factor,
                                  device="cpu").numpy()
        inertial = self.cfg.inertial and m.imu_initialized
        if inertial:
            problem, window, lm_ids, _, _ = ba_assembly.build_full_vi_problem(
                m, inv_s2, self.cfg.imu, device=self.device)
            segments = global_inertial_ba.make_segments(problem)
            solve, cost = self._solve_inertial, global_inertial_ba.vi_cost
        else:
            # the real numbers of poses and landmarks: no padding tiers
            problem, window, lm_ids, _, _ = ba_assembly.build_full_problem(
                m, inv_s2, min_pose_tier=1, min_lm_tier=1, device=self.device)
            # built (and sized, which waits for the device once) here, so
            # that nothing in the solve does
            segments = global_ba.PoseSegments(problem.obs_kf, problem.obs_mask,
                                              problem.poses.shape[0])
            solve, cost = self._solve_visual, global_ba.ba_cost
        cam = self.cfg.geo_camera if inertial else self.cam
        return GBASnapshot(problem, window, lm_ids, m.kf_pose.copy(), m.lm_gen[lm_ids].copy(),
                           segments, cam, solve, cost)

    def _gba_iterate(self, snapshot: GBASnapshot, iterations: int = 6, abort_event=None):
        """Solve half: the snapshot's solve on the frozen snapshot. Touches
        no live map state; returns None once ``abort_event`` (the
        reference's ``mbStopGBA``) is seen set."""
        res = snapshot.solve(snapshot, iterations, abort_event)
        return None if res is None else (snapshot.window, snapshot.lm_ids, res,
                                         snapshot.pose_before, snapshot.lm_gen_before)

    def _solve_visual(self, s: GBASnapshot, iterations: int, abort_event):
        """``iterations`` LM iterations, ``GBA_CHUNK`` a call (the chunks keep
        the solver's damping and Huber schedule as the JAX package runs
        them), ``abort_event`` polled before each chunk."""
        problem, res = s.problem, None
        for it in range(0, iterations, GBA_CHUNK):
            if abort_event is not None and abort_event.is_set():
                return None
            res = global_ba.global_bundle_adjust(problem, s.cam, s.segments,
                                                 iterations=min(GBA_CHUNK, iterations - it),
                                                 cg_iters=GBA_CG_ITERS)
            problem = problem._replace(poses=res.poses, landmarks=res.landmarks)
        return res

    def _solve_inertial(self, s: GBASnapshot, iterations: int, abort_event):
        """One call of ``GBA_VI_ITERATIONS`` LM iterations, Huber on each
        (``iterations`` is the visual solve's), ``abort_event`` polled
        before it."""
        if abort_event is not None and abort_event.is_set():
            return None
        res = global_inertial_ba.global_inertial_bundle_adjust(
            s.problem, s.cam, s.segments, iterations=GBA_VI_ITERATIONS,
            cg_iters=GBA_CG_ITERS, huber_iters=GBA_VI_ITERATIONS)
        self.counts["inertial_gba_runs"] += 1
        return res

    def _gba_on_map(self, res, K: int):
        """A solve's keyframe states as the map holds them: (K, 7) camera
        poses, and the velocities and gyro and accel biases ((K, 3) each)
        of a result that carries body states, its poses turned through
        T_cb; None in their place after the visual solve."""
        if not hasattr(res, "Twb"):
            return res.poses.cpu().numpy().astype(np.float32)[:K], None
        down = torch.cat([res.Twb.reshape(-1), res.vel.reshape(-1), res.bg.reshape(-1),
                          res.ba.reshape(-1)]).cpu().numpy()
        Twb, *states = np.split(down, np.cumsum([7 * K, 3 * K, 3 * K]))
        T_cb = imu_frontend.extrinsics(self.cfg.imu)[1]
        poses = lie.np_se3_mul(np.tile(T_cb, (K, 1)), lie.np_se3_inv(Twb.reshape(K, 7)))
        return poses.astype(np.float32), [a.reshape(K, 3) for a in states]

    def _apply_gba(self, out) -> bool:
        """Staged GBA writeback + correction propagation (reference
        ``RunGlobalBundleAdjustment`` tail): keyframes and landmarks
        created after the snapshot are corrected through their anchor
        keyframe; landmarks culled and recycled meanwhile are left alone
        (generation check). Returns whether the result was written."""
        window, lm_ids, res, pose_before, lm_gen_before = out
        m = self.map
        rec = self.stats["events"][-1] if self.stats["events"] else {}
        new_poses, states = self._gba_on_map(res, len(window))
        new_lms = res.landmarks.cpu().numpy().astype(np.float32)[: len(lm_ids)]
        rec.update(gba_poses=len(window), gba_landmarks=len(lm_ids),
                   gba_cost_after=float(res.cost))
        # reject a diverged solve wholesale (guards exist inside the
        # solver; this is the final writeback gate)
        bound = 10.0 * (1.0 + np.abs(pose_before[window][:, 4:7]).max())
        if (not np.isfinite(new_poses).all() or not np.isfinite(new_lms).all()
                or np.abs(new_poses[:, 4:7] - pose_before[window][:, 4:7]).max() > bound):
            log("GBA result REJECTED: out of bounds")
            rec["gba"] = "rejected"
            return False
        in_window = np.zeros(m.capacity_kf, bool)
        in_window[window] = True
        in_solve = np.zeros(m.capacity_lm, bool)
        still = m.lm_gen[lm_ids] == lm_gen_before
        in_solve[lm_ids[still]] = True

        before_all = m.kf_pose.copy()
        fresh_kfs = [int(k) for k in m.valid_kf_ids() if not in_window[k]]
        m.kf_pose[window] = new_poses
        if states is not None:
            m.kf_vel[window], m.kf_bg[window], m.kf_ba[window] = states
        ok = still & m.lm_valid[lm_ids]
        m.lm_pos[lm_ids[ok]] = new_lms[ok]

        # keyframes created after the snapshot: T_k ← (T_k ∘ T_a⁻¹) ∘ T_a'
        # with anchor a = the most covisible solved keyframe
        for k in fresh_kfs:
            w = m.covisibility_weights(k)
            w[~in_window] = 0
            anchor = int(np.argmax(w))
            if w[anchor] == 0:
                anchor = int(window[-1])
            T_rel = lie.np_se3_mul(before_all[k], lie.np_se3_inv(before_all[anchor]))
            m.kf_pose[k] = lie.np_se3_mul(T_rel, m.kf_pose[anchor])
            if states is not None:
                # its velocity turns with its world rotation's correction,
                # R_wc' · R_cw (the reference's Rcor); its biases stay
                q_new = m.kf_pose[k, :4] * np.float32([1, -1, -1, -1])
                m.kf_vel[k] = lie.np_quat_rotate(
                    q_new[None], lie.np_quat_rotate(before_all[k, :4][None], m.kf_vel[k][None]))[0]

        # landmarks created after the snapshot: re-anchor through their
        # reference keyframe's before/after poses
        fresh_lm = np.nonzero(m.lm_valid & ~in_solve)[0]
        if fresh_lm.size:
            ref = np.asarray([m.live_ref_kf(int(r)) for r in m.lm_ref_kf[fresh_lm]], np.int64)
            Xc = lie.np_se3_apply(before_all[ref], m.lm_pos[fresh_lm])
            m.lm_pos[fresh_lm] = lie.np_se3_apply(lie.np_se3_inv(m.kf_pose[ref]), Xc)
        m.version += 1
        rec["gba"] = "applied"
        return True

    def _fuse(self, cur_lms: np.ndarray, old_lms: np.ndarray) -> int:
        """Replace each current-side landmark with its loop-matched older
        twin in every binding (``MapPoint::Replace`` semantics). Returns
        the number of landmarks replaced."""
        m = self.map
        remap = np.arange(m.capacity_lm, dtype=np.int32)
        keep = cur_lms != old_lms
        remap[cur_lms[keep]] = old_lms[keep]
        bound = m.kf_lm_idx >= 0
        m.kf_lm_idx[bound] = remap[m.kf_lm_idx[bound]]
        losers = np.unique(cur_lms[keep])
        with m.alloc_lock:
            m.lm_valid[losers] = False
            m.lm_gen[losers] += 1
            m.lm_free.extend(int(i) for i in losers)
        dedup_kf_bindings(m)
        return int(losers.size)
