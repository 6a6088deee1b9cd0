"""The CG step's products of the whole-map bundle adjustment
(``ops/gba_cuda``) on the CPU: the plain versions that the CPU takes and the
kernels (``csrc/gba.cu``) are held to on the card.

* ``hv_plain``, finished as ``global_ba``'s ``H_apply_dot`` finishes it,
  against P·(JᵀWJ + Λ)·P·v built densely in float64 from the same Jacobians
  (P: the free poses and valid landmarks), on a problem with masked slots,
  a fixed pose, an invalid pose and invalid landmarks: 1e-5 of the largest
  value (float32 sums of a few hundred terms);
* ``precond_plain`` against the damped diagonal blocks of the same dense
  matrix, inverted in float64 and applied in float64: 1e-5;
* on CPU tensors the wrappers return the plain versions' bits and launch
  nothing; the plain CG updates are the textbook step;
* the H·v kernel's blocks hold whole landmarks and start on 16 bytes where
  the slot count allows.

On a card (``gpu``, skipped without one): ``gba_pair_hv`` and the 15-wide
``gba_cg_update`` and ``gba_cg_direction`` give their plain versions' bits;
``gba_hv`` on a 15-wide state vector gives the bits of its pose columns
alone (the visual solve's path); a whole inertial solve waits for nothing,
repeats to the bit and launches each CG kernel once a step; the loop
closer runs it on an initialized inertial map and writes back poses,
velocities and biases."""

import numpy as np
import pytest
import torch

from orb_slam3_rgbl_tpu_torch import cuda_build, synthetic
from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera
from orb_slam3_rgbl_tpu_torch.ops import gba_cuda
from orb_slam3_rgbl_tpu_torch.optim import global_ba
from orb_slam3_rgbl_tpu_torch.optim.local_ba import _linearize

CAM = PinholeCamera(fx=718.856, fy=718.856, cx=607.19, cy=185.22, width=1241, height=376,
                    bf=386.14)


@pytest.fixture(scope="module")
def linearized():
    """One Huber linearization of a 10-pose, 300-landmark map, D = 5:
    pose 0 fixed, pose 7 invalid, every 9th landmark invalid, and the
    masked slots of the generator beside them."""
    prob, _, _ = synthetic.synth_gba_problem(10, 300, 5, CAM, seed=5, device="cpu")
    K, M = prob.poses.shape[0], prob.landmarks.shape[0]
    prob = prob._replace(pose_valid=torch.arange(K) != 7,
                         lm_valid=torch.arange(M) % 9 != 4)
    r, Jp, Jl, w, *_ = _linearize(prob, CAM, True, torch.ones_like(prob.obs_mask))
    seg = global_ba.PoseSegments(prob.obs_kf, prob.obs_mask, K)
    pose_free = ((~prob.pose_fixed) & prob.pose_valid)[:, None]
    lm_free = prob.lm_valid[:, None]
    live = w != 0
    assert 0.3 < float(live.float().mean()) < 0.99 and bool((prob.obs_mask & ~live).any())
    return prob, Jp, Jl, w, seg, pose_free, lm_free


def _dense(prob, Jp, Jl, w):
    """(JᵀWJ in float64 over the (6K + 3M) unknowns, poses first)."""
    K, M = prob.poses.shape[0], prob.landmarks.shape[0]
    D = prob.obs_kf.shape[1]
    J = np.zeros((M * D * 3, 6 * K + 3 * M))
    jp, jl = Jp.double().numpy(), Jl.double().numpy()
    kf = prob.obs_kf.numpy()
    for m in range(M):
        for d in range(D):
            rows = slice(3 * (m * D + d), 3 * (m * D + d) + 3)
            J[rows, 6 * kf[m, d]: 6 * kf[m, d] + 6] = jp[m, d]
            J[rows, 6 * K + 3 * m: 6 * K + 3 * m + 3] = jl[m, d]
    W = np.repeat(w.double().numpy().reshape(-1), 3)
    return J.T @ (W[:, None] * J)


def _free_mask(pose_free, lm_free):
    return np.concatenate([np.repeat(pose_free.numpy()[:, 0], 6),
                           np.repeat(lm_free.numpy()[:, 0], 3)])


def _close(got, want, rel):
    want = np.asarray(want, np.float64)
    assert np.abs(np.asarray(got, np.float64) - want).max() <= rel * np.abs(want).max()


def test_plain_hv_matches_dense_normal_equations(linearized):
    prob, Jp, Jl, w, seg, pose_free, lm_free = linearized
    K, M = prob.poses.shape[0], prob.landmarks.shape[0]
    g = torch.Generator().manual_seed(1)
    v_p = torch.randn(K, 6, generator=g) * pose_free
    v_l = torch.randn(M, 3, generator=g) * lm_free
    lam_p = torch.rand(K, 6, generator=g) * 1e3
    lam_l = torch.rand(M, 3, generator=g) * 1e2

    Hp, Hv_l, lm_half = gba_cuda.hv_plain(Jp, Jl, w, prob.obs_kf, seg, v_p, v_l, lam_l, lm_free)
    Hv_p = (Hp + lam_p * v_p) * pose_free            # H_apply_dot's pose half

    P = _free_mask(pose_free, lm_free)
    v = np.concatenate([v_p.double().numpy().reshape(-1), v_l.double().numpy().reshape(-1)])
    lam = np.concatenate([lam_p.double().numpy().reshape(-1), lam_l.double().numpy().reshape(-1)])
    want = P * ((_dense(prob, Jp, Jl, w) + np.diag(lam)) @ (P * v))
    _close(Hv_p.reshape(-1), want[:6 * K], 1e-5)
    _close(Hv_l.reshape(-1), want[6 * K:], 1e-5)
    np.testing.assert_allclose(float(lm_half), want[6 * K:] @ v[6 * K:], rtol=1e-5)
    assert not Hv_p[~pose_free[:, 0]].any() and not Hv_l[~lm_free[:, 0]].any()


def test_plain_preconditioner_matches_dense_block_inverses(linearized):
    prob, Jp, Jl, w, seg, pose_free, lm_free = linearized
    K, M = prob.poses.shape[0], prob.landmarks.shape[0]
    H = _dense(prob, Jp, Jl, w)
    blocks = [(6 * k, 6, bool(pose_free[k])) for k in range(K)] + \
             [(6 * K + 3 * m, 3, bool(lm_free[m])) for m in range(M)]
    inv = []
    for a, n, free in blocks:
        B = H[a:a + n, a:a + n]
        B = B + 1e-3 * np.diag(np.diag(B)) + 1e-7 * np.eye(n) if free else np.eye(n)
        inv.append(np.linalg.inv(B))
    Minv_p = torch.tensor(np.stack(inv[:K]), dtype=torch.float32)
    Minv_l = torch.tensor(np.stack(inv[K:]), dtype=torch.float32)
    g = torch.Generator().manual_seed(2)
    r_p, r_l = torch.randn(K, 6, generator=g), torch.randn(M, 3, generator=g)

    z_p, z_l = gba_cuda.precond_plain(Minv_p, Minv_l, r_p, r_l, pose_free, lm_free)
    r = np.concatenate([r_p.double().numpy().reshape(-1), r_l.double().numpy().reshape(-1)])
    mats = list(Minv_p.double().numpy()) + list(Minv_l.double().numpy())
    want = np.concatenate([Mi @ r[a:a + n] for Mi, (a, n, _) in zip(mats, blocks)])
    want *= _free_mask(pose_free, lm_free)
    _close(z_p.reshape(-1), want[:6 * K], 1e-5)
    _close(z_l.reshape(-1), want[6 * K:], 1e-5)
    assert not z_p[~pose_free[:, 0]].any() and not z_l[~lm_free[:, 0]].any()


def test_cpu_wrappers_take_the_plain_path_and_launch_nothing(linearized):
    prob, Jp, Jl, w, seg, pose_free, lm_free = linearized
    K, M = prob.poses.shape[0], prob.landmarks.shape[0]
    g = torch.Generator().manual_seed(3)
    v_p, v_l, lam_l = torch.randn(K, 6, generator=g), torch.randn(M, 3, generator=g), \
        torch.rand(M, 3, generator=g)
    Minv_p, Minv_l = torch.randn(K, 6, 6, generator=g), torch.randn(M, 3, 3, generator=g)
    before = dict(cuda_build.launch_counts)
    got = gba_cuda.HessianProduct(Jp, Jl, w, prob.obs_kf, seg, lam_l, lm_free)(v_p, v_l)
    want = gba_cuda.hv_plain(Jp, Jl, w, prob.obs_kf, seg, v_p, v_l, lam_l, lm_free)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = gba_cuda.BlockJacobi(Minv_p, Minv_l, pose_free, lm_free)(v_p, v_l)
    want = gba_cuda.precond_plain(Minv_p, Minv_l, v_p, v_l, pose_free, lm_free)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    bj = gba_cuda.BlockJacobi(Minv_p, Minv_l, pose_free, lm_free)
    rz, pAp = torch.rand((), generator=g) + 0.5, torch.rand((), generator=g) + 0.5
    x, p, Ap = ((torch.randn(K, 6, generator=g), torch.randn(M, 3, generator=g)) for _ in range(3))
    got = bj.update(rz, pAp, x, (v_p, v_l), p, Ap)
    want = gba_cuda.cg_update_plain(bj, rz, pAp, x, (v_p, v_l), p, Ap)
    assert all(torch.equal(a, b) for gp, wp in zip(got, want) for a, b in zip(gp, wp))
    got = gba_cuda.cg_direction(pAp, rz, x, p)
    assert all(torch.equal(a, b) for a, b in zip(got, gba_cuda.cg_direction_plain(pAp, rz, x, p)))
    assert cuda_build.launch_counts == before
    assert {"gba_hv", "gba_pose_sum", "gba_cg_update", "gba_cg_direction"} <= set(
        cuda_build.launch_counts)


def test_plain_cg_updates_are_the_textbook_step():
    """alpha = rz / pAp, x + alpha p, r − alpha Ap, z = M⁻¹ r; beta =
    rz_new / rz, z + beta p; a pAp of 0 is clamped to 1e-20."""
    g = torch.Generator().manual_seed(4)
    x, rr, p, Ap = ((torch.randn(3, 6, generator=g), torch.randn(5, 3, generator=g))
                    for _ in range(4))
    rz, pAp = torch.tensor(2.0), torch.tensor(0.5)
    xo, ro, z = gba_cuda.cg_update_plain(lambda a, b: (2 * a, -b), rz, pAp, x, rr, p, Ap)
    for i in range(2):
        torch.testing.assert_close(xo[i], x[i] + 4 * p[i])
        torch.testing.assert_close(ro[i], rr[i] - 4 * Ap[i])
    torch.testing.assert_close(z[0], 2 * ro[0])
    torch.testing.assert_close(z[1], -ro[1])
    po = gba_cuda.cg_direction_plain(torch.tensor(1.0), torch.tensor(4.0), z, p)
    torch.testing.assert_close(po[1], z[1] + 0.25 * p[1])
    xo, _, _ = gba_cuda.cg_update_plain(lambda a, b: (a, b), torch.tensor(1e-20), torch.tensor(0.0),
                                        x, rr, p, Ap)
    torch.testing.assert_close(xo[0], x[0] + p[0])


@pytest.mark.parametrize("D", [1, 3, 5, 8, 13, 64, 65, 200, 256])
def test_hv_blocks_hold_whole_landmarks_on_16_bytes(D):
    lpb = gba_cuda.landmarks_per_block(D)
    assert lpb >= 1 and lpb * D <= gba_cuda.THREADS
    aligned = [n for n in range(1, gba_cuda.THREADS // D + 1) if n * D % 4 == 0]
    if aligned:
        # Jp and Jl tiles start on 16 bytes, and no aligned choice holds more landmarks
        assert lpb == max(aligned) and (lpb * D * 18 * 4) % 16 == 0 and (lpb * D * 9 * 4) % 16 == 0
    else:
        assert lpb == gba_cuda.THREADS // D
    if D == 8:                              # both cells: 32 landmarks, 256 slots a block
        assert lpb == 32


@pytest.mark.parametrize("D", [0, 257])
def test_hv_refuses_more_slots_than_a_block(D):
    with pytest.raises(ValueError):
        gba_cuda.landmarks_per_block(D)


# --- the 15-wide states of the inertial solve, on the card ------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pair_operands(K, seed, device):
    """A temporal chain of K states and every 5th state tied to the one
    three ahead as well, random Jacobians and weights, state 0 fixed, one
    pair invalid."""
    from orb_slam3_rgbl_tpu_torch.optim import global_inertial_ba as giba
    g = torch.Generator().manual_seed(seed)
    extra = torch.arange(0, K - 3, 5)
    pair_i = torch.cat([torch.arange(K - 1), extra])
    pair_j = torch.cat([torch.arange(1, K), extra + 3])
    P = len(pair_i)
    J = torch.randn(P, 15, 30, generator=g) * 10
    w = torch.rand(P, 15, generator=g) * 1e4
    w[P // 2] = 0.0
    v = torch.randn(K, 15, generator=g)
    lam = torch.rand(K, 15, generator=g)
    free = (torch.arange(K) != 0)[:, None]
    Hp = torch.randn(K, 6, generator=g) * 50
    lm_half = torch.randn((), generator=g)
    table = giba.pair_segments(pair_i, pair_j, K).table
    return [t.to(device) for t in (J, w, pair_i, pair_j, table, lam, free, Hp, v, lm_half)]


@pytest.mark.gpu
@pytest.mark.parametrize("K", [199, 2048, 5])
def test_pair_hv_kernel_gives_its_plain_versions_bits(cuda, K):
    """``gba_pair_hv`` against ``pair_hv_plain`` on the card and on the CPU:
    the same bits (each product and sum rounded once, in the same order);
    one launch a call; two calls the same bits."""
    J, w, pair_i, pair_j, table, lam, free, Hp, v, lm_half = _pair_operands(K, K, cuda)
    op = gba_cuda.PairProduct(J, w, pair_i, pair_j, table, lam, free)
    before = cuda_build.launch_counts["gba_pair_hv"]
    got = op(Hp, v, lm_half)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["gba_pair_hv"] == before + 1
    want = gba_cuda.pair_hv_plain(Hp, J, w, pair_i, pair_j, table, v, lam, free, lm_half)
    on_cpu = gba_cuda.pair_hv_plain(*(t.cpu() for t in (Hp, J, w, pair_i, pair_j, table, v, lam,
                                                         free, lm_half)))
    for a, b, c in zip(got, want, on_cpu):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    assert all(torch.equal(a, b) for a, b in zip(got, op(Hp, v, lm_half)))


@pytest.mark.gpu
def test_15_wide_cg_kernels_give_their_plain_versions_bits(cuda):
    """The 15-wide ``gba_cg_update`` (the step's updates, then the 15×15
    apply) and ``gba_cg_direction`` against the separate PyTorch operations:
    the same bits; the apply alone within 1e-5 of the plain version."""
    g = torch.Generator().manual_seed(15)
    K, M = 199, 29_851
    Minv_s = torch.randn(K, 15, 15, generator=g).to(cuda)
    Minv_l = torch.randn(M, 3, 3, generator=g).to(cuda)
    free = (torch.arange(K, device=cuda) != 0)[:, None]
    lm_free = (torch.arange(M, device=cuda) % 7 != 3)[:, None]
    bj = gba_cuda.BlockJacobi(Minv_s, Minv_l, free, lm_free)
    v_s, v_l = torch.randn(K, 15, generator=g).to(cuda), torch.randn(M, 3, generator=g).to(cuda)
    for a, b in zip(bj(v_s, v_l), gba_cuda.precond_plain(Minv_s, Minv_l, v_s, v_l, free,
                                                         lm_free)):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-5
    rz, pAp, rz_new = (torch.rand((), generator=g).to(cuda) + 0.5 for _ in range(3))
    x, rr, p, Ap = ((torch.randn(K, 15, generator=g).to(cuda),
                     torch.randn(M, 3, generator=g).to(cuda)) for _ in range(4))
    counts = cuda_build.launch_counts
    before = (counts["gba_cg_update"], counts["gba_cg_direction"])
    xo, ro, zo = bj.update(rz, pAp, x, rr, p, Ap)
    po = gba_cuda.cg_direction(rz_new, rz, zo, p)
    torch.cuda.synchronize()
    assert (counts["gba_cg_update"], counts["gba_cg_direction"]) == (before[0] + 1, before[1] + 1)
    xw, rw, zw = gba_cuda.cg_update_plain(bj, rz, pAp, x, rr, p, Ap)
    pw = gba_cuda.cg_direction_plain(rz_new, rz, zo, p)
    for got_, want_ in ((xo, xw), (ro, rw), (zo, zw), (po, pw)):
        assert all(torch.equal(a, b) for a, b in zip(got_, want_))
    with pytest.raises(ValueError):
        bj.update(rz, pAp, x, rr, (p[0][:, :6].contiguous(), p[1]), Ap)


@pytest.mark.gpu
def test_hv_reads_the_pose_columns_of_15_wide_states(cuda):
    """``gba_hv`` on a (K, 15) vector gives the bits it gives on its pose
    columns alone: the 6-wide path is the visual solve's, unchanged."""
    from orb_slam3_rgbl_tpu_torch.optim import global_ba as gba
    g = torch.Generator().manual_seed(6)
    M, D, K = 20_000, 8, 199
    Jp = (torch.randn(M, D, 3, 6, generator=g) * 50).to(cuda)
    Jl = (torch.randn(M, D, 3, 3, generator=g) * 50).to(cuda)
    live = torch.rand(M, D, generator=g) < 0.7
    w = torch.where(live, torch.rand(M, D, generator=g) + 0.1, 0.0).to(cuda)
    obs_kf = torch.randint(0, K, (M, D), generator=g).to(cuda)
    lam_l = torch.rand(M, 3, generator=g).to(cuda)
    lm_free = torch.ones(M, 1, dtype=torch.bool, device=cuda)
    seg = gba.PoseSegments(obs_kf, live.to(cuda), K)
    hv = gba_cuda.HessianProduct(Jp, Jl, w, obs_kf, seg, lam_l, lm_free)
    v_s, v_l = torch.randn(K, 15, generator=g).to(cuda), torch.randn(M, 3, generator=g).to(cuda)
    wide = hv(v_s, v_l)
    narrow = hv(v_s[:, :6].contiguous(), v_l)
    assert all(torch.equal(a, b) for a, b in zip(wide, narrow))


@pytest.mark.gpu
def test_inertial_solve_on_the_card(cuda):
    """A whole inertial solve on a small hall map: no wait for the device,
    the same bits twice, one launch each of ``gba_hv``, ``gba_pose_sum``,
    ``gba_pair_hv``, ``gba_cg_update`` and ``gba_cg_direction`` a CG step
    (one more ``gba_cg_update`` a linearization), and the CPU run's answer
    within 1e-3 m, 1e-3 m/s and 1e-2 of the cost."""
    import test_torch_global_inertial_ba as t
    from orb_slam3_rgbl_tpu_torch.optim import global_inertial_ba as giba
    from slambench.problems import vi_gba
    cell, config = t.small(24, 60)
    maparr = vi_gba.make_map(config, cell, t.SEED)
    on = {d: vi_gba.Solver(config, cell, maparr, torch.device(d)) for d in ("cuda", "cpu")}
    problem, segments = on["cuda"]._assemble()
    its, cg = 3, 20
    names = ("gba_hv", "gba_pose_sum", "gba_pair_hv", "gba_cg_update", "gba_cg_direction")
    counts = cuda_build.launch_counts
    before = {k: counts[k] for k in names}

    def run():
        return giba.global_inertial_bundle_adjust(problem, on["cuda"].cam, segments,
                                                  iterations=its, cg_iters=cg)
    giba.global_inertial_bundle_adjust(problem, on["cuda"].cam, segments, iterations=1, cg_iters=2)
    torch.cuda.synchronize()
    before = {k: counts[k] for k in names}
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert {k: counts[k] - before[k] for k in names} == dict(
        gba_hv=its * cg, gba_pose_sum=its * cg, gba_pair_hv=its * cg,
        gba_cg_update=its * (cg + 1), gba_cg_direction=its * cg)
    again = run()
    for f in first._fields:
        assert torch.equal(getattr(first, f), getattr(again, f)), f
    p_c, s_c = on["cpu"]._assemble()
    cpu = giba.global_inertial_bundle_adjust(p_c, on["cpu"].cam, s_c, iterations=its, cg_iters=cg)
    assert (first.Twb.cpu()[:, 4:] - cpu.Twb[:, 4:]).abs().max() < 1e-3
    assert (first.vel.cpu() - cpu.vel).abs().max() < 1e-3
    np.testing.assert_allclose(float(first.cost), float(cpu.cost), rtol=1e-2)


@pytest.mark.gpu
def test_the_loop_closers_inertial_ba_on_the_card(cuda):
    """``LoopCloser`` on an initialized stereo-inertial map on the card:
    the snapshot is the whole-map inertial problem, its solve (one call of 7
    LM iterations) waits for nothing and gives the same bits twice, and the
    writeback moves poses, velocities and biases."""
    import test_torch_global_inertial_ba as t
    from orb_slam3_rgbl_tpu_torch.config import IMU_STEREO, OrbConfig, SlamConfig
    from orb_slam3_rgbl_tpu_torch.slam import loop_closing
    from slambench.problems import vi_gba
    cell, config = t.small(24, 60)
    maparr = vi_gba.make_map(config, cell, t.SEED)
    solver = vi_gba.Solver(config, cell, maparr, cuda)
    orb = config["orb"]
    cfg = SlamConfig(sensor=IMU_STEREO, camera=solver.cam, imu=solver.imu,
                     orb=OrbConfig(n_features=orb["n_features"], n_levels=orb["n_levels"],
                                   scale_factor=orb["scale_factor"]))
    m = solver.map
    closer = loop_closing.LoopCloser(cfg, m, device=cuda)
    snapshot = closer._gba_assemble()
    assert isinstance(snapshot[0], loop_closing.VIBAProblem)
    assert snapshot[0].Twb.device.type == "cuda" and int(snapshot[0].pair_valid.sum()) == 23
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = closer._gba_iterate(snapshot, 6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    again = closer._gba_iterate(snapshot, 6)
    for f in out[2]._fields:
        assert torch.equal(getattr(out[2], f), getattr(again[2], f)), f
    assert closer.counts["inertial_gba_runs"] == 2
    live = m.valid_kf_ids()
    before = {f: getattr(m, f)[live].copy() for f in ("kf_pose", "kf_vel", "kf_bg", "kf_ba")}
    assert closer._apply_gba(out) is True
    for f, a in before.items():
        assert np.abs(getattr(m, f)[live] - a).max() > 0, f
    assert float(out[2].cost) < 0.5 * float(vi_gba.global_inertial_ba.vi_cost(snapshot[0],
                                                                              cfg.geo_camera))
