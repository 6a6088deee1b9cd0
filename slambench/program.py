"""The system under test: the port's whole-map bundle adjustment as its loop
closer builds it after a correction (``slam/loop_closing.LoopCloser.
_gba_assemble``), solved with the schedule the cell fixes.

One solve: ``ba_assembly.build_full_problem`` over the map (no padding
tiers), ``global_ba.PoseSegments`` of its observation table, the LM
iterations ``chunk`` at a time through ``global_ba.global_bundle_adjust``
(the loop closer's ``_gba_iterate`` calls 2 at a time; the cells call all 16
at once, so the damping carries over), and the poses, landmarks and cost
downloaded to the host. Each stage runs inside a ``record_function`` span of
the benchmark's own, which the traced run reads.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera
from orb_slam3_rgbl_tpu_torch.optim import global_ba
from orb_slam3_rgbl_tpu_torch.slam import ba_assembly
from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState

SPAN_SOLVE = "gba.solve"
SPAN_ASSEMBLE = "gba.assemble"
SPAN_CHUNK = "gba.chunk"
SPAN_DOWNLOAD = "gba.download"


def make_map(config: dict, maparr: dict) -> MapState:
    """The generated map as the program holds it."""
    K, N = maparr["kf_lm_idx"].shape
    M = len(maparr["lm_pos"])
    m = MapState.create(config["capacity_kf"], config["capacity_lm"], N)
    m.kf_pose[:K] = maparr["kf_pose"]
    m.kf_valid[:K] = True
    m.kf_frame_id[:K] = np.arange(K)
    m.kf_timestamp[:K] = np.arange(K, dtype=np.float64)
    m.kf_uv[:K] = maparr["kf_uv"]
    m.kf_ur[:K] = maparr["kf_ur"]
    m.kf_octave[:K] = maparr["kf_octave"]
    m.kf_feat_valid[:K] = True
    m.kf_lm_idx[:K] = maparr["kf_lm_idx"]
    m.lm_pos[:M] = maparr["lm_pos"]
    m.lm_valid[:M] = True
    m.n_kf, m.n_lm = K, M
    return m


def make_camera(config: dict) -> PinholeCamera:
    c = config["camera"]
    return PinholeCamera(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"],
                         width=c["width"], height=c["height"], bf=c["bf"])


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Solver:
    """The whole-map solve of one map, run again and again on the same,
    unchanged map."""

    def __init__(self, config: dict, cell: dict, maparr: dict, inv_sigma2: np.ndarray,
                 device: torch.device):
        self.map = make_map(config, maparr)
        self.cam = make_camera(config)
        self.inv_s2 = inv_sigma2
        self.max_obs = int(config["max_obs"])
        self.schedule = cell["schedule"]
        self.device = device
        self.shapes = None

    def _assemble(self):
        problem, window, lm_ids, _, _ = ba_assembly.build_full_problem(
            self.map, self.inv_s2, max_obs=self.max_obs, min_pose_tier=1, min_lm_tier=1,
            device=self.device)
        segments = global_ba.PoseSegments(problem.obs_kf, problem.obs_mask,
                                          problem.poses.shape[0])
        self.n_kf, self.n_lm = len(window), len(lm_ids)
        return problem, segments

    def _chunk(self, problem, segments, poses, lms, n: int):
        s = self.schedule
        return global_ba.global_bundle_adjust(
            problem._replace(poses=poses, landmarks=lms), self.cam, segments,
            iterations=n, cg_iters=s["cg_steps"], huber_iters=s["huber_iterations"])

    def warm(self):
        """One LM iteration at the solve's own shapes: every kernel and
        allocation the solve makes is made once before the window."""
        problem, segments = self._assemble()
        res = self._chunk(problem, segments, problem.poses, problem.landmarks, 1)
        res.poses.cpu(), res.landmarks.cpu(), float(res.cost)
        self.shapes = dict(K=int(problem.poses.shape[0]), M=int(problem.landmarks.shape[0]),
                           n_kf=self.n_kf, n_lm=self.n_lm,
                           D=int(problem.obs_kf.shape[1]),
                           n_obs=int(problem.obs_mask.sum()),
                           L=int(segments.table.shape[1]))
        _sync(self.device)

    def solve(self, spans: list):
        """One solve; appends (name, start, end) host-clock spans to
        ``spans``. Returns poses (K, 7), landmarks (M, 3) and the cost.

        ``build_full_problem`` pads the keyframes and landmarks to powers of
        two even at tier 1; the padding is the program's and is solved with
        the rest."""
        s = self.schedule
        t0 = time.perf_counter()
        with record_function(SPAN_SOLVE):
            with record_function(SPAN_ASSEMBLE):
                problem, segments = self._assemble()
                _sync(self.device)
            t1 = time.perf_counter()
            poses, lms = problem.poses, problem.landmarks
            done = 0
            while done < s["lm_iterations"]:
                n = min(s["chunk"], s["lm_iterations"] - done)
                with record_function(SPAN_CHUNK):
                    res = self._chunk(problem, segments, poses, lms, n)
                poses, lms = res.poses, res.landmarks
                done += n
            with record_function(SPAN_DOWNLOAD):
                # as the loop closer's writeback takes them: past the padding
                out = (res.poses.cpu().numpy()[: self.n_kf],
                       res.landmarks.cpu().numpy()[: self.n_lm], float(res.cost))
        spans += [(SPAN_SOLVE, t0, time.perf_counter()), (SPAN_ASSEMBLE, t0, t1)]
        return out
