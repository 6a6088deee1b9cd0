"""The whole-map visual-inertial bundle adjustment (``optim/global_inertial_ba``)
on the CPU, with float32 inputs:

* the solve against the benchmark's plain float64 reference
  (``slambench/vi_reference.py``) on a seeded stereo-inertial hall map of 12
  keyframes and 300 landmarks, the cell's schedule (7 LM iterations × 64 CG
  steps, Huber on each): tolerances 30–600× above the float32 solve's
  readings (pose 6.8e-6 m and 6.1e-5°, landmarks 7.2e-4 px, cost 1.6e-7 of
  itself, velocity 6.0e-6 m/s, biases 1.7e-7 rad/s and 3.7e-6 m/s²), while
  the map as handed over is off by more than each tolerance; the pairs' and
  the visual cost each fall to a bounded share of where they started;
* against the dense Schur solve ``inertial_ba.vi_bundle_adjust`` at
  convergence (no Huber, CG steps above the unknowns): two different
  linear solvers over the same factors reach the same minimum, 1e-3 m of
  the poses, 2e-3 m/s of the velocities and a median 1e-3 m of the
  landmarks (float32 normal equations with preintegration weights of 1e8;
  a landmark held weakly in depth slides along its ray);
* two solves give the same bits;
* ``gba_cuda.pair_hv_plain`` against the pairs' blocks of the dense
  Hessian built in float64: 1e-5 of the largest value; the 15-wide
  ``precond_plain`` against float64 block inverses: 1e-5; the 15-wide
  ``cg_update_plain`` and ``cg_direction_plain`` the textbook step;
* the pair table (``PoseSegments`` over the pairs' endpoints), the accept
  test and damping that both whole-map solves share (``lm_accept``), and
  the whole-map assembly: one pair a link of the temporal chain, invalid
  without a preintegration."""

import copy
import json

import numpy as np
import pytest
import torch

from orb_slam3_rgbl_tpu_torch import cuda_build
from orb_slam3_rgbl_tpu_torch.ops import gba_cuda
from orb_slam3_rgbl_tpu_torch.optim import global_inertial_ba as giba
from orb_slam3_rgbl_tpu_torch.optim.global_ba import PoseSegments, lm_accept
from orb_slam3_rgbl_tpu_torch.optim import inertial_ba
from slambench import mapgen
from slambench.problems import vi_gba

SEED = 2147483659
CELL = "slambench/workloads/euroc_mh_stereo_inertial_map.viba_one_call.json"
CONFIG = "slambench/configs/euroc_mh_stereo_inertial_map.json"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(n_keyframes=12, landmarks_per_kf=25):
    with open(CELL) as f:
        cell = json.load(f)
    with open(CONFIG) as f:
        config = json.load(f)
    cell, config = copy.deepcopy(cell), copy.deepcopy(config)
    cell["n_keyframes"] = n_keyframes
    config["map"]["new_landmarks_per_kf"] = landmarks_per_kf
    return cell, config


@pytest.fixture(scope="module")
def solved():
    """The small map, its solver, two solves and the float64 reference."""
    cell, config = small()
    maparr = vi_gba.make_map(config, cell, SEED)
    solver = vi_gba.Solver(config, cell, maparr, torch.device("cpu"))
    solver.warm()
    a, b = solver.solve([]), solver.solve([])
    stats = {}
    ref = vi_gba.reference(config, cell, maparr, "cpu", stats)
    return maparr, solver, a, b, ref, stats


TOLERANCE = {"pose_gap_m": 1e-3, "pose_gap_deg": 1e-2, "landmark_gap_px": 0.2, "cost_gap": 5e-5,
             "vel_gap_mps": 2e-3, "bg_gap": 1e-4, "ba_gap": 1e-3}


def test_solve_matches_the_float64_reference(solved):
    maparr, solver, a, _, ref, stats = solved
    assert solver.shapes["n_kf"] == 12 and solver.shapes["n_lm"] == 300
    assert solver.shapes["n_pairs"] == solver.shapes["n_valid_pairs"] == 11
    assert stats["accepted"] >= 5
    got = vi_gba.gaps(a, ref)
    assert set(got) == set(vi_gba.NAMES) == set(TOLERANCE)
    assert all(got[k] <= TOLERANCE[k] for k in TOLERANCE), got
    still = vi_gba.unchanged(maparr, stats, ref)
    assert all(still[k] > TOLERANCE[k] for k in TOLERANCE), still
    problem, segments = solver._assemble()
    res = giba.global_inertial_bundle_adjust(problem, solver.cam, segments, 7, 64, 7)
    assert float(res.cost) == a[2]
    _assert_converged(problem, res, solver.cam)


def _cost_parts(problem, cam):
    """(visual, inertial) plain cost of a problem as it stands."""
    inertial = inertial_ba._inertial_cost(problem)
    return float(giba.vi_cost(problem, cam) - inertial), float(inertial)


def _assert_converged(problem, res, cam):
    """The pairs' cost ends below 1e-3 of where it started (observed 4e-5
    and 1e-5 on the two test maps), the visual cost below a fifth (observed
    an eighth and an eleventh: the outliers' floor). With the pairs'
    covariance as the reference computes it (``vi_mapgen``) the visual part
    dominates the end cost, so the two are bounded apart."""
    end = problem._replace(Twb=res.Twb, vel=res.vel, bg=res.bg, ba=res.ba,
                           landmarks=res.landmarks)
    (v0, i0), (v1, i1) = _cost_parts(problem, cam), _cost_parts(end, cam)
    assert i1 < 1e-3 * i0 and v1 < 0.2 * v0, ((v0, i0), (v1, i1))


def test_two_solves_give_the_same_bits(solved):
    _, _, a, b, _, _ = solved
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_no_pairs_leaves_velocities_and_biases(solved):
    """With every pair invalid nothing moves a velocity or a bias."""
    maparr, solver, _, _, _, _ = solved
    problem, segments = solver._assemble()
    res = vi_gba.no_pairs(giba.global_inertial_bundle_adjust)(problem, solver.cam, segments,
                                                              iterations=2, cg_iters=16)
    for f in ("vel", "bg", "ba"):
        assert torch.equal(getattr(res, f)[0], getattr(problem, f)[0])
        assert (getattr(res, f) - getattr(problem, f)).abs().max() < 1e-5, f


def _vi_problem(n_keyframes, landmarks_per_kf, seed=7):
    cell, config = small(n_keyframes, landmarks_per_kf)
    maparr = vi_gba.make_map(config, cell, seed)
    solver = vi_gba.Solver(config, cell, maparr, torch.device("cpu"))
    problem, segments = solver._assemble()
    return problem, segments, solver.cam


def test_matches_the_dense_schur_solve_at_convergence():
    problem, segments, cam = _vi_problem(6, 10)
    K, M = problem.Twb.shape[0], problem.landmarks.shape[0]
    n = 15 * K + 3 * M
    mine = giba.global_inertial_bundle_adjust(problem, cam, segments, iterations=12,
                                              cg_iters=n + 10, huber_iters=0)
    dense = inertial_ba.vi_bundle_adjust(problem, cam, iterations=12, huber_iters=0)
    c_m = lambda T: torch.as_tensor(T[:, 4:7])                                  # noqa: E731
    assert (c_m(mine.Twb) - c_m(dense.Twb)).abs().max() < 1e-3
    assert (mine.vel - dense.vel).abs().max() < 2e-3
    # a landmark held weakly in depth may slide far along its ray in either
    assert (mine.landmarks - dense.landmarks).abs().median() < 1e-3
    _assert_converged(problem, mine, cam)
    np.testing.assert_allclose(float(mine.cost), float(dense.cost), rtol=2e-2)


def _pair_operands(K=9, seed=0):
    """A chain of K states with K − 1 pairs, one more pair (3, 7) so that a
    state has three entries, random Jacobians and weights, state 0 fixed."""
    g = torch.Generator().manual_seed(seed)
    pair_i = torch.tensor(list(range(K - 1)) + [3])
    pair_j = torch.tensor(list(range(1, K)) + [7])
    P = len(pair_i)
    J = torch.randn(P, 15, 30, generator=g) * 10
    w = torch.rand(P, 15, generator=g) * 100 + 1
    w[2] = 0.0                                                   # an invalid pair
    v = torch.randn(K, 15, generator=g)
    lam = torch.rand(K, 15, generator=g)
    free = (torch.arange(K) != 0)[:, None]
    Hp = torch.randn(K, 6, generator=g) * 50
    return J, w, pair_i, pair_j, v, lam, free, Hp


def test_pair_table_lists_each_states_entries_in_order():
    J, w, pair_i, pair_j, *_ = _pair_operands()
    P = len(pair_i)
    seg = PoseSegments(torch.stack([pair_i, pair_j], 1), torch.ones((P, 2), dtype=torch.bool), 9)
    assert torch.equal(giba.pair_segments(pair_i, pair_j, 9).table, seg.table)
    for k in range(9):
        want = [2 * p + s for p in range(P) for s in range(2)
                if int((pair_i, pair_j)[s][p]) == k]
        row = [int(e) for e in seg.table[k] if e < 2 * P]
        assert row == want
    assert seg.table.shape == (9, 3)
    vals = torch.randn(2 * P, 4)
    want = torch.zeros(9, 4, dtype=torch.float64).index_add_(
        0, torch.stack([pair_i, pair_j], 1).reshape(-1), vals.double())
    torch.testing.assert_close(seg.sum(vals).double(), want, rtol=1e-6, atol=1e-5)


def test_plain_pair_hv_matches_the_dense_pair_blocks():
    J, w, pair_i, pair_j, v, lam, free, Hp = _pair_operands()
    K, P = v.shape[0], J.shape[0]
    table = giba.pair_segments(pair_i, pair_j, K).table
    lm_half = torch.tensor(3.5)
    Hv, pAp = gba_cuda.pair_hv_plain(Hp, J, w, pair_i, pair_j, table, v, lam, free, lm_half)
    H = np.zeros((15 * K, 15 * K))
    for p in range(P):
        rows = np.zeros((15, 15 * K))
        i, j = int(pair_i[p]), int(pair_j[p])
        rows[:, 15 * i:15 * i + 15] = J[p, :, :15].double().numpy()
        rows[:, 15 * j:15 * j + 15] = J[p, :, 15:].double().numpy()
        H += rows.T @ (w[p].double().numpy()[:, None] * rows)
    vv = v.double().numpy().reshape(-1)
    mask = np.repeat(free.numpy()[:, 0], 15)
    want = (H @ vv + np.pad(Hp.double().numpy(), ((0, 0), (0, 9))).reshape(-1)
            + lam.double().numpy().reshape(-1) * vv) * mask
    got = Hv.double().numpy().reshape(-1)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert not Hv[0].any()
    scale = float(np.abs(vv * want).sum())
    assert abs(float(pAp) - (vv @ want + 3.5)) <= 1e-5 * scale


def test_pair_product_on_the_cpu_is_the_plain_version_and_launches_nothing():
    J, w, pair_i, pair_j, v, lam, free, Hp = _pair_operands(seed=1)
    table = giba.pair_segments(pair_i, pair_j, v.shape[0]).table
    before = dict(cuda_build.launch_counts)
    got = gba_cuda.PairProduct(J, w, pair_i, pair_j, table, lam, free)(Hp, v, torch.tensor(1.0))
    want = gba_cuda.pair_hv_plain(Hp, J, w, pair_i, pair_j, table, v, lam, free,
                                  torch.tensor(1.0))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert cuda_build.launch_counts == before and "gba_pair_hv" in cuda_build.launch_counts


def test_plain_15_wide_preconditioner_and_cg_updates():
    g = torch.Generator().manual_seed(5)
    K, M = 7, 11
    A = torch.randn(K, 15, 15, generator=g)
    Minv_s = (A @ A.mT + 15 * torch.eye(15)).inverse()
    Minv_l = torch.randn(M, 3, 3, generator=g)
    free, lm_free = (torch.arange(K) != 0)[:, None], (torch.arange(M) != 4)[:, None]
    v_s, v_l = torch.randn(K, 15, generator=g), torch.randn(M, 3, generator=g)
    bj = gba_cuda.BlockJacobi(Minv_s, Minv_l, free, lm_free)
    z_s, z_l = bj(v_s, v_l)
    want = np.einsum("kij,kj->ki", Minv_s.double().numpy(), v_s.double().numpy())
    want *= free.numpy()
    assert np.abs(z_s.double().numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert not z_l[4].any() and not z_s[0].any()
    rz, pAp = torch.tensor(2.0), torch.tensor(0.5)
    x, rr, p, Ap = ((torch.randn(K, 15, generator=g), torch.randn(M, 3, generator=g))
                    for _ in range(4))
    xo, ro, z = bj.update(rz, pAp, x, rr, p, Ap)
    torch.testing.assert_close(xo[0], x[0] + 4 * p[0])
    torch.testing.assert_close(ro[0], rr[0] - 4 * Ap[0])
    assert all(torch.equal(a, b) for a, b in zip(z, bj(*ro)))
    po = gba_cuda.cg_direction(torch.tensor(1.0), torch.tensor(4.0), z, p)
    torch.testing.assert_close(po[0], z[0] + 0.25 * p[0])


@pytest.mark.parametrize("cost_new, n_new, kept", [
    (9.0, 10, True),              # lower, and keeps every active observation
    (9.0, 5, True),               # keeps half
    (9.0, 4, False),              # empties the active set below half
    (10.0, 10, False),            # not lower
    (float("nan"), 10, False),    # diverged
    (float("inf"), 10, False),
])
def test_lm_accept_is_the_one_test_and_damping_of_both_solves(cost_new, n_new, kept):
    """``global_ba.lm_accept``, which the visual and the inertial solve
    share: the step and the damping after it, 1e-3 × 0.4 or × 5, exactly
    as the float32 products round; the clamps at 1e-8 and 1e4."""
    lam = torch.tensor(1e-3)
    accept, lam2 = lm_accept(torch.tensor(10.0), torch.tensor(10), torch.tensor(cost_new),
                             torch.tensor(n_new), lam)
    assert bool(accept) == kept
    assert torch.equal(lam2, lam * 0.4 if kept else lam * 5.0)
    _, low = lm_accept(torch.tensor(10.0), torch.tensor(1), torch.tensor(1.0), torch.tensor(1),
                       torch.tensor(1e-8))
    _, high = lm_accept(torch.tensor(1.0), torch.tensor(1), torch.tensor(2.0), torch.tensor(1),
                        torch.tensor(1e4))
    assert float(low) == pytest.approx(1e-8) and float(high) == pytest.approx(1e4)


def test_whole_map_assembly_links_the_temporal_chain():
    cell, config = small(8, 10)
    maparr = vi_gba.make_map(config, cell, 3)
    solver = vi_gba.Solver(config, cell, maparr, torch.device("cpu"))
    m = solver.map
    # keyframe 5 lost its preintegration; keyframe 6 follows 4 (5 was relinked)
    del m.imu_preint[5]
    m.kf_prev_imu[6] = 4
    problem, window, lm_ids, _, _ = vi_gba.ba_assembly.build_full_vi_problem(
        m, solver.inv_s2, solver.imu, device="cpu")
    assert list(window) == list(range(8)) and len(lm_ids) == 80
    assert problem.pair_i.tolist() == [0, 1, 2, 3, 4, 4, 6]
    assert problem.pair_j.tolist() == [1, 2, 3, 4, 5, 6, 7]
    assert problem.pair_valid.tolist() == [True] * 4 + [False] + [True] * 2
    assert problem.state_fixed.tolist() == [True] + [False] * 7
    dt = float(problem.pair_meas.dt[0])
    assert dt == pytest.approx(config["map"]["kf_dt_s"])
    assert float(problem.info_ba[0]) == pytest.approx(1.0 / (config["imu"]["acc_walk"] ** 2 * dt),
                                                      rel=1e-5)
    assert float(problem.info_bg[0]) == pytest.approx(1e8)
    # the body poses: T_cw = T_cb · Twb⁻¹ gives the map's poses back
    from orb_slam3_rgbl_tpu_torch.geometry import lie
    Tcw = lie.np_se3_mul(np.tile(solver.T_cb, (8, 1)), lie.np_se3_inv(problem.Twb.numpy()))
    R = mapgen.quat_to_matrix(Tcw[:, :4])
    R_map = mapgen.quat_to_matrix(m.kf_pose[:8, :4])
    assert np.abs(R - R_map).max() < 1e-5 and np.abs(Tcw[:, 4:] - m.kf_pose[:8, 4:]).max() < 1e-5
