"""The whole-map visual-inertial bundle adjustment after a loop correction
on a stereo-inertial map (``FullInertialBA(7)``): the map of ``vi_mapgen``,
the port's solve (``optim/global_inertial_ba``, as the loop closer builds it
through ``ba_assembly.build_full_vi_problem``), the float64 ``vi_reference``
and seven compared numbers, bound to the roles that
``slambench/problems/__init__.py`` sets out.

An answer is the tuple (poses (K, 7) Tcw as quaternion and translation,
landmarks (M, 3), cost, velocities (K, 3), gyro biases (K, 3), accelerometer
biases (K, 3)). The compared numbers are the visual problem's four
(``compare``: camera centres, rotations, landmarks in pixels, the cost's
share; a landmark behind its first observer in both answers by its 3D gap,
``_landmark_gap_px``) and the largest gap of a keyframe's velocity (m/s), gyro bias
(rad/s) and accelerometer bias (m/s²) to the reference's.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from orb_slam3_rgbl_tpu_torch.config import ImuConfig
from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.optim import global_inertial_ba
from orb_slam3_rgbl_tpu_torch.slam import ba_assembly, imu_frontend
from slambench import compare, mapgen, program, roofline, vi_mapgen
from slambench import vi_reference as plain
from slambench.reference import Arith

SPAN_SOLVE = "gba.solve"
SPAN_PREFIX = "gba."
SPAN_ASSEMBLE = "gba.assemble"
SPAN_CHUNK = "gba.chunk"
SPAN_DOWNLOAD = "gba.download"
NAMES = compare.NAMES + ("vel_gap_mps", "bg_gap", "ba_gap")
REFERENCE = plain.__file__


def make_map(config: dict, cell: dict, seed: int) -> dict:
    return vi_mapgen.generate(config, cell, seed)


def imu_config(config: dict) -> ImuConfig:
    imu = config["imu"]
    return ImuConfig(T_body_cam=tuple(float(v) for v in imu["T_b_c1"]),
                     noise_gyro=imu["noise_gyro"], noise_acc=imu["noise_acc"],
                     gyro_walk=imu["gyro_walk"], acc_walk=imu["acc_walk"],
                     frequency=imu["frequency_hz"])


class Solver:
    """The whole-map inertial solve of one map, as the loop closer runs it
    (one call of ``lm_iterations``), run again and again on the same map."""

    def __init__(self, config: dict, cell: dict, maparr: dict, device: torch.device):
        m = program.make_map(config, maparr)
        K = len(maparr["kf_pose"])
        m.kf_timestamp[:K] = maparr["kf_time"]
        m.kf_vel[:K], m.kf_bg[:K], m.kf_ba[:K] = maparr["kf_vel"], maparr["kf_bg"], maparr["kf_ba"]
        m.kf_prev_imu[1:K] = np.arange(K - 1)
        rows = maparr["preint"]
        for k in range(1, K):
            flat, parts, i = rows[k - 1], [], 0
            for _, shape in imu_frontend.PREINT_LAYOUT:
                n = int(np.prod(shape))
                parts.append(flat[i:i + n].reshape(shape).copy())
                i += n
            m.imu_preint[k] = tuple(parts)
        m.imu_initialized = True
        self.map = m
        self.cam = program.make_camera(config)
        self.imu = imu_config(config)
        _, self.T_cb = imu_frontend.extrinsics(self.imu)
        self.inv_s2 = mapgen.inv_sigma2(config["orb"])
        self.max_obs = int(config["max_obs"])
        self.schedule = cell["schedule"]
        self.device = device
        self.shapes = None

    def _assemble(self):
        problem, window, lm_ids, _, _ = ba_assembly.build_full_vi_problem(
            self.map, self.inv_s2, self.imu, max_obs=self.max_obs, device=self.device)
        self.n_kf, self.n_lm = len(window), len(lm_ids)
        return problem, global_inertial_ba.make_segments(problem)

    def _solve(self, problem, segments, iterations: int):
        s = self.schedule
        return global_inertial_ba.global_inertial_bundle_adjust(
            problem, self.cam, segments, iterations=iterations, cg_iters=s["cg_steps"],
            huber_iters=s["huber_iterations"])

    def warm(self):
        """One LM iteration at the solve's own shapes: every kernel and
        allocation the solve makes is made once before the window."""
        problem, segments = self._assemble()
        res = self._solve(problem, segments, 1)
        self._download(res)
        self.shapes = dict(K=int(problem.Twb.shape[0]), M=int(problem.landmarks.shape[0]),
                           n_kf=self.n_kf, n_lm=self.n_lm, D=int(problem.obs_kf.shape[1]),
                           n_obs=int(problem.obs_mask.sum()),
                           L=int(segments.obs.table.shape[1]),
                           n_pairs=int(problem.pair_i.shape[0]),
                           n_valid_pairs=int(problem.pair_valid.sum()))
        program._sync(self.device)

    def _download(self, res):
        """(poses (K, 7) Tcw, landmarks, cost, velocities, gyro and accel
        biases) on the host: one download, the poses through T_cb as the
        loop closer writes them back."""
        K, M = self.n_kf, self.n_lm
        down = torch.cat([res.Twb.reshape(-1), res.vel.reshape(-1), res.bg.reshape(-1),
                          res.ba.reshape(-1), res.landmarks.reshape(-1),
                          res.cost.reshape(1).to(torch.float32)]).cpu().numpy()
        Twb, vel, bg, ba, lms, cost = np.split(down, np.cumsum([7 * K, 3 * K, 3 * K, 3 * K,
                                                                3 * M]))
        Tcw = lie.np_se3_mul(np.tile(self.T_cb, (K, 1)), lie.np_se3_inv(Twb.reshape(K, 7)))
        return (Tcw.astype(np.float32), lms.reshape(M, 3), float(cost[0]), vel.reshape(K, 3),
                bg.reshape(K, 3), ba.reshape(K, 3))

    def solve(self, spans: list):
        """One solve; appends (name, start, end) host-clock spans to
        ``spans``; returns the answer (the module docstring)."""
        t0 = time.perf_counter()
        with record_function(SPAN_SOLVE):
            with record_function(SPAN_ASSEMBLE):
                problem, segments = self._assemble()
                program._sync(self.device)
            t1 = time.perf_counter()
            with record_function(SPAN_CHUNK):
                res = self._solve(problem, segments, self.schedule["lm_iterations"])
            with record_function(SPAN_DOWNLOAD):
                out = self._download(res)
        spans += [(SPAN_SOLVE, t0, time.perf_counter()), (SPAN_ASSEMBLE, t0, t1)]
        return out


def _answer(sol: dict):
    return (program_pose7(sol["R"], sol["t"]), sol["X"], sol["cost"], sol["vel"], sol["bg"],
            sol["ba"])


def program_pose7(R, t):
    return np.concatenate([mapgen.matrix_to_quat(R), t], -1)


class Reference:
    """The float64 reference's answer with what ``compare`` needs."""

    def __init__(self, sol: dict, maparr: dict, cam: dict):
        self.visual = compare.against((sol["R"], sol["t"], sol["X"], sol["cost"]), maparr, cam)
        self.vel, self.bg, self.ba = sol["vel"], sol["bg"], sol["ba"]


def reference(config: dict, cell: dict, maparr: dict, device, stats: dict = None,
              control: bool = False):
    """The float64 reference as a ``Reference``; with ``control`` the
    reference in TF32 (float32, every product's operands rounded to TF32),
    as an answer."""
    arith = Arith(torch.float32, tf32=True) if control else Arith(torch.float64)
    sol = plain.run(maparr, config, cell, mapgen.inv_sigma2(config["orb"]), arith, device, stats)
    return _answer(sol) if control else Reference(sol, maparr, config["camera"])


def _gap(a, b) -> float:
    d = np.linalg.norm(np.asarray(a, np.float64) - b, axis=1)
    return float(np.inf) if not np.isfinite(d).all() else float(d.max())


def _landmark_gap_px(X: np.ndarray, ref: compare.Reference) -> float:
    """``compare``'s landmark gap, except where a landmark lies behind its
    first observer in both answers: the inertial solve moves an occasional
    landmark there (one whose second observation is an outlier: its
    observations then fall inactive and it sheds their cost), reference
    and program alike, and an image no longer measures the two. Its gap is
    then its 3D gap seen from that camera, fx · |X − X_ref| / |z_ref| px:
    at least the image gap that the same small move would make in front of
    the camera (fx · Δ / z across the ray, bf · Δz / z² along it). Behind
    in one answer only, or nearer than 1 mm to the camera's plane, it reads
    infinite, as in ``compare``."""
    R, t = ref.R[ref.first_kf], ref.t[ref.first_kf]
    X = np.asarray(X, np.float64)
    d = np.linalg.norm(compare._image(R, t, X, ref.cam) - compare._image(R, t, ref.X, ref.cam),
                       axis=1)
    z, z_ref = (np.einsum("mij,mj->mi", R, Y)[:, 2] + t[:, 2] for Y in (X, ref.X))
    behind = (z < -1e-3) & (z_ref < -1e-3)
    d = np.where(behind, ref.cam["fx"] * np.linalg.norm(X - ref.X, axis=1) / np.abs(z_ref), d)
    return float(np.inf) if np.isnan(d).any() else float(np.max(d))


def gaps(out, ref: Reference) -> dict:
    poses, landmarks, cost, vel, bg, ba = out
    return {**compare.gaps(poses, landmarks, cost, ref.visual),
            "landmark_gap_px": _landmark_gap_px(landmarks, ref.visual),
            "vel_gap_mps": _gap(vel, ref.vel), "bg_gap": _gap(bg, ref.bg),
            "ba_gap": _gap(ba, ref.ba)}


def unchanged(maparr: dict, stats: dict, ref: Reference) -> dict:
    return gaps((maparr["kf_pose"], maparr["lm_pos"], stats["start_cost"], maparr["kf_vel"],
                 maparr["kf_bg"], maparr["kf_ba"]), ref)


def no_pairs(solve_fn):
    """``global_inertial_bundle_adjust`` with every pair invalid."""
    def broken(problem, *a, **k):
        return solve_fn(problem._replace(pair_valid=torch.zeros_like(problem.pair_valid)),
                        *a, **k)
    return broken


def faults(solver: Solver, out, ref: Reference) -> dict:
    """One landmark of the answer moved by (1, 1, 1) m; the solve with every
    inertial pair invalid."""
    moved = out[1].copy()
    moved[0] += np.float32(1.0)
    found = {"fault_answer_altered": gaps((out[0], moved) + tuple(out[2:]), ref)}
    orig = global_inertial_ba.global_inertial_bundle_adjust
    global_inertial_ba.global_inertial_bundle_adjust = no_pairs(orig)
    try:
        found["fault_no_pairs"] = gaps(solver.solve([]), ref)
    finally:
        global_inertial_ba.global_inertial_bundle_adjust = orig
    return found


F = roofline.F
IDX = roofline.IDX


def roofline_counts(shapes: dict, schedule: dict) -> dict:
    """{'bytes', 'flops'} of one inertial solve, the least work from its
    shapes alone, as ``roofline.counts`` counts the visual one: the real
    states ``n_kf``, landmarks ``n_lm``, observations ``n_obs`` and pairs
    ``n_pairs``, float32 values, each stage's inputs read once and its
    outputs written once. Beside the visual terms (with 15-wide state
    vectors and 15×15 preconditioner blocks): a linearization reads each
    pair's preintegration (143 values) and writes its residual, Jacobian
    and weights (15 + 450 + 15), counted at 2 operations a Jacobian entry
    and 300 for the residual; the gradient and preconditioner read those and
    add each side's 15×15 block (15³ multiply-adds) and invert each state's
    block (15³); a CG step reads each pair's Jacobian and weights and makes
    J·v and Jᵀ·u (2 × 450 multiply-adds), and applies each state's 15×15
    block; the acceptance re-evaluates each pair's residual."""
    n, K, M, P = shapes["n_obs"], shapes["n_kf"], shapes["n_lm"], shapes["n_pairs"]
    its, cg = schedule["lm_iterations"], schedule["cg_steps"]
    obs_in = n * (IDX + 4 * F)
    state = (16 * K + 3 * M) * F                  # Twb (7), v, bg, ba; landmarks
    vec = (15 * K + 3 * M) * F
    precond = (225 * K + 9 * M) * F
    pre_in = P * 143 * F
    pair_out = P * 480 * F

    lin_bytes = obs_in + state + n * 31 * F + pre_in + pair_out
    lin_flops = n * (30 + 2 * (9 + 54 + 27)) + P * (300 + 2 * 450)
    grad_bytes = n * 31 * F + pair_out + vec + precond
    grad_flops = (n * 2 * (18 + 9 + 108 + 27) + P * 2 * 2 * (15 ** 3 + 15 ** 2)
                  + K * 2 * 15 ** 3 + M * 2 * 27)
    cg_bytes = n * (28 * F + IDX) + P * 465 * F + 4 * vec + precond + 3 * vec
    cg_flops = (n * (2 * 27 + 3 + 2 * 27) + P * (2 * 2 * 450 + 15) + K * (2 * 225 + 6 * 15)
                + M * (18 + 3 * 12))
    acc_bytes = obs_in + state + pre_in + vec + state
    acc_flops = n * (30 + 2 * 9) + P * 300
    final_bytes = obs_in + state + pre_in
    return {
        "bytes": its * (lin_bytes + grad_bytes + cg * cg_bytes + acc_bytes) + final_bytes,
        "flops": its * (lin_flops + grad_flops + cg * cg_flops + acc_flops) + acc_flops,
    }


def pair_hv_counts(shapes: dict) -> dict:
    """{'bytes', 'flops'} of one ``gba_pair_hv`` launch, the least: each
    pair's Jacobian, weights and endpoints read once (450 + 15 values, 2
    indices), each state's visual pose sum (6), vector, damping (15 each),
    mask and two pair-table entries read once, each state's product (15)
    and the dot written once; 2 × 450 multiply-adds a pair (J·v, Jᵀ·u), its
    15 weights, and 3 operations an output (damping, mask, dot)."""
    K, P = shapes["n_kf"], shapes["n_pairs"]
    return {"bytes": P * (465 * F + 2 * IDX) + K * ((6 + 15 + 15 + 15) * F + 1 + 2 * IDX) + F,
            "flops": P * (2 * 2 * 450 + 15) + K * 15 * 4}

