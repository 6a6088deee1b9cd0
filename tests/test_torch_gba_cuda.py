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
  the slot count allows;
* the LM iteration's entry points (``global_ba.linearize`` and ``lm_cost``,
  ``gba_cuda.apply_step``) on CPU tensors return, bit for bit, what the solver computed before its
  kernels (``local_ba._linearize``, the gradient and block einsums,
  ``PoseSegments.sum``, the ``lie`` update), for stereo and mono slots,
  Huber on and off, masked slots, invalid landmarks, a fixed and an invalid
  pose, a landmark behind its cameras, a distorted pinhole and a KB8 camera.

On a card (``gpu``, skipped without one): ``gba_pair_hv`` and the 15-wide
``gba_cg_update`` and ``gba_cg_direction`` give their plain versions' bits;
``gba_hv`` on a 15-wide state vector gives the bits of its pose columns
alone (the visual solve's path); a whole inertial solve waits for nothing,
repeats to the bit and launches each CG kernel once a step; the loop
closer runs it on an initialized inertial map and writes back poses,
velocities and biases. The LM iteration's kernels (``gba_linearize``,
``gba_pose_blocks``, ``gba_cost``, ``gba_apply_step``) against their plain
versions for the cases above and at the EuRoC cell's shapes (M 32,768, D 8,
~72% live): 1e-5 of the largest value, the active count and mask exact, the
accept test's cost the linearization's to the bit, two calls the same bits; a
visual solve launches each once an LM iteration, repeats to the bit and
runs no cuBLAS kernel in its ``gba.linearize`` and ``gba.accept`` spans."""

import numpy as np
import pytest
import torch

from orb_slam3_rgbl_tpu_torch import cuda_build, synthetic
from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.geometry.camera import KannalaBrandt8Camera, PinholeCamera
from orb_slam3_rgbl_tpu_torch.ops import gba_cuda
from orb_slam3_rgbl_tpu_torch.optim import global_ba
from orb_slam3_rgbl_tpu_torch.optim.local_ba import _linearize

CAM = PinholeCamera(fx=718.856, fy=718.856, cx=607.19, cy=185.22, width=1241, height=376,
                    bf=386.14)
CAMS = {"pinhole": CAM,
        # EuRoC's left camera with its radial-tangential terms, TUM-VI's fisheye
        "distorted": PinholeCamera(fx=458.654, fy=457.296, cx=367.215, cy=248.375, k1=-0.28340811,
                                   k2=0.07395907, p1=0.00019359, p2=1.76187114e-05, k3=0.01,
                                   width=752, height=480, bf=47.9),
        "kb8": KannalaBrandt8Camera(fx=190.978, fy=190.973, cx=254.932, cy=256.897, k0=0.00348,
                                    k1=0.000715, k2=-0.00205, k3=0.000203, width=512, height=512)}
LM_CASES = {"stereo_mono_huber": ("pinhole", True), "no_huber": ("pinhole", False),
            "distorted": ("distorted", True), "kb8": ("kb8", True)}    # (camera, Huber)


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


# --- the LM iteration outside CG ----------------------------------------------

def lm_problem(cam, K, M, D, seed, device, live=1.0):
    """``synth_gba_problem``'s map with every pose turned by a small rotation,
    1/σ² of eight pyramid levels, the second slot of every landmark mono,
    pose 0 fixed, pose K // 2 invalid, every 9th landmark invalid and
    landmark 5 thrown behind its cameras; ``live`` keeps that share of the
    observed slots."""
    prob, _, _ = synthetic.synth_gba_problem(K, M, D, cam, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed)
    q = torch.cat([torch.ones(K, 1), 0.01 * torch.randn(K, 3, generator=g)], 1)
    poses = prob.poses.clone()
    poses[1:, :4] = (q / q.norm(dim=1, keepdim=True))[1:]
    lms = prob.landmarks.clone()
    lms[5, 2] -= 100.0
    ur = prob.obs_ur.clone()
    ur[:, 1] = -1.0
    inv_s2 = 1.44 ** -torch.randint(0, 8, (M, D), generator=g).float()
    mask = prob.obs_mask & (torch.rand(M, D, generator=g) < live)
    prob = prob._replace(poses=poses, landmarks=lms, obs_ur=ur, obs_inv_sigma2=inv_s2,
                         obs_mask=mask, pose_valid=torch.arange(K) != K // 2,
                         lm_valid=torch.arange(M) % 9 != 4)
    return type(prob)(*(t.to(device) for t in prob))


def test_camera_params_name_the_model_and_its_terms():
    for name, model in (("pinhole", gba_cuda.PINHOLE), ("distorted", gba_cuda.PINHOLE_DISTORTED),
                        ("kb8", gba_cuda.KB8)):
        cam = CAMS[name]
        got, params = gba_cuda.camera_params(cam, global_ba.HUBER)
        values = np.frombuffer(bytes(params), np.float32)
        assert got == model and values.shape == (12,)
        np.testing.assert_array_equal(values[:5], np.float32([cam.fx, cam.fy, cam.cx, cam.cy,
                                                              cam.bf]))
        terms = ((cam.k0, cam.k1, cam.k2, cam.k3, 0) if name == "kb8" else
                 (cam.k1, cam.k2, cam.p1, cam.p2, cam.k3) if name == "distorted" else (0,) * 5)
        np.testing.assert_array_equal(values[5:10], np.float32(terms))
        np.testing.assert_array_equal(values[10:], np.float32([np.sqrt(7.815), np.sqrt(5.991)]))
        _, params = gba_cuda.camera_params(cam, None)
        np.testing.assert_array_equal(np.frombuffer(bytes(params), np.float32)[10:], 0)


@pytest.mark.parametrize("case", LM_CASES)
def test_lm_wrappers_on_the_cpu_give_the_solvers_former_bits(case):
    cam_name, huber = LM_CASES[case]
    cam = CAMS[cam_name]
    prob = lm_problem(cam, 10, 300, 5, 7, "cpu")
    K, (M, D) = prob.poses.shape[0], prob.obs_kf.shape
    seg = global_ba.PoseSegments(prob.obs_kf, prob.obs_mask, K)
    lm_free = prob.lm_valid[:, None]
    before = dict(cuda_build.launch_counts)
    lin = global_ba.linearize(prob, cam, seg, huber, lm_free)
    # the solver's code before its kernels, op for op
    r, Jp, Jl, w, chi2, active, cost = _linearize(prob, cam, huber, torch.ones_like(prob.obs_mask))
    wr = w[..., None] * r
    wJp = w[..., None, None] * Jp
    want = dict(Jp=Jp, Jl=Jl, w=w, cost=cost, n_active=active.sum(),
                g_p=seg.sum(torch.einsum("mdij,mdi->mdj", Jp, wr)),
                Hpp_diag=seg.sum((wJp.transpose(-1, -2) @ Jp).reshape(M, D, 36)),
                g_l=torch.einsum("mdij,mdi->mj", Jl, wr) * lm_free,
                Hll_diag=torch.einsum("mdij,md,mdik->mjk", Jl, w, Jl))
    for field, t in want.items():
        assert torch.equal(getattr(lin, field), t), field
    got = global_ba.lm_cost(prob, cam, huber)
    assert torch.equal(got[0], cost) and torch.equal(got[1], active.sum())
    *_, chi2_f, active_f, cost_f = _linearize(prob, cam, False, torch.ones_like(prob.obs_mask))
    got = global_ba.lm_cost(prob, cam, False, per_slot=True)
    for a, b in zip(got, (cost_f, active_f.sum(), chi2_f, active_f)):
        assert torch.equal(a, b)
    g = torch.Generator().manual_seed(8)
    dp, dl = torch.randn(K, 6, generator=g) * 0.01, torch.randn(M, 3, generator=g) * 0.01
    new_p, new_l = gba_cuda.apply_step(dp, prob.poses, dl, prob.landmarks)
    assert torch.equal(new_p, lie.se3_normalize(lie.se3_mul(lie.se3_exp(dp), prob.poses)))
    assert torch.equal(new_l, prob.landmarks + dl)
    assert cuda_build.launch_counts == before
    # the case holds what it names: live stereo and mono slots, masked slots,
    # a slot behind its camera, the invalid landmarks' and pose's slots out
    considered = prob.obs_mask & prob.lm_valid[:, None] & prob.pose_valid[prob.obs_kf]
    live = w != 0
    mono = prob.obs_ur < 0
    assert (live & mono).any() and (live & ~mono).any() and (~prob.obs_mask).any()
    assert (considered & ~active).any() and float(cost) >= 1e7
    assert not live[~prob.lm_valid].any() and not live[prob.obs_kf == K // 2].any()
    assert bool((w[live] < prob.obs_inv_sigma2[live]).any()) == huber


# --- the LM iteration's kernels, on the card ----------------------------------

LM_TOL = 1e-5       # of the largest value: float32 sums in other orders


def _lm_case(case, device):
    """(problem, camera, Huber) of a card test case: the CPU cases at
    K 10, M 300, D 5, or the EuRoC cell's shapes (K 199, M 32,768, D 8,
    ~72% of the slots live)."""
    if case == "euroc_shape":
        cam = PinholeCamera(fx=456.715, fy=456.715, cx=364.44, cy=256.95, width=752, height=480,
                            bf=50.274)
        return lm_problem(cam, 199, 32_768, 8, 19, device, live=0.8), cam, True
    cam_name, huber = LM_CASES[case]
    return lm_problem(CAMS[cam_name], 10, 300, 5, 7, device), CAMS[cam_name], huber


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(LM_CASES) + ["euroc_shape"])
def test_lm_kernels_match_their_plain_versions(cuda, case):
    """``linearize`` (``gba_linearize`` + ``gba_pose_blocks``), ``cost``
    (``gba_linearize`` without Jacobians + ``gba_pose_blocks``' sum) and
    ``apply_step`` against their plain
    versions on the card: ``LM_TOL`` of the largest value, the active
    count and the active mask exact, the landmarks' update bit for bit; the
    accept test's cost the linearization's to the bit; two calls the same
    bits; one launch of each kernel a call."""
    prob, cam, huber = _lm_case(case, cuda)
    K, (M, D) = prob.poses.shape[0], prob.obs_kf.shape
    seg = global_ba.PoseSegments(prob.obs_kf, prob.obs_mask, K)
    lm_free = prob.lm_valid[:, None]
    counts = cuda_build.launch_counts
    names = ("gba_linearize", "gba_pose_blocks", "gba_cost", "gba_apply_step")
    before = {k: counts[k] for k in names}
    got = global_ba.linearize(prob, cam, seg, huber, lm_free)
    total, n_active = global_ba.lm_cost(prob, cam, huber)
    torch.cuda.synchronize()
    want = global_ba.linearize_plain(prob, cam, seg, huber, lm_free)
    live = want.w != 0
    if case == "euroc_shape":
        share = float(live.float().mean())
        assert 0.6 < share < 0.8, share
    assert torch.equal(got.w != 0, live) and _rel(got.w, want.w) <= LM_TOL
    # a slot of weight 0 holds zeros, so H·v's plain version reads finite values
    assert not got.Jp[~live].any() and not got.Jl[~live].any()
    for field in ("Jp", "Jl"):
        a, b = getattr(got, field)[live], getattr(want, field)[live]
        assert _rel(a, b) <= LM_TOL, (field, _rel(a, b))
    for field in ("g_p", "Hpp_diag", "g_l", "Hll_diag", "cost"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.shape == b.shape and _rel(a, b) <= LM_TOL, (field, _rel(a, b))
    assert got.n_active.dtype == torch.int64 and torch.equal(got.n_active, want.n_active)
    assert not got.g_l[~lm_free[:, 0]].any()
    assert torch.equal(total, got.cost) and torch.equal(n_active, got.n_active)
    again = global_ba.linearize(prob, cam, seg, huber, lm_free)
    for field in ("w", "g_p", "Hpp_diag", "g_l", "Hll_diag", "cost", "n_active"):
        assert torch.equal(getattr(got, field), getattr(again, field)), field
    assert torch.equal(got.Jp[live], again.Jp[live]) and torch.equal(got.Jl[live], again.Jl[live])
    # the final pass: each slot's chi² and active mask
    c, n, chi2, active = global_ba.lm_cost(prob, cam, False, per_slot=True)
    c_w, n_w, chi2_w, active_w = global_ba.cost_plain(prob, cam, False, per_slot=True)
    assert torch.equal(active, active_w) and torch.equal(n, n_w) and _rel(c, c_w) <= LM_TOL
    assert _rel(chi2[active], chi2_w[active]) <= LM_TOL
    g = torch.Generator().manual_seed(M)
    dp = (torch.randn(K, 6, generator=g) * 0.01).to(cuda)
    dp[0] = 0.0
    dl = (torch.randn(M, 3, generator=g) * 0.01).to(cuda)
    new_p, new_l = gba_cuda.apply_step(dp, prob.poses, dl, prob.landmarks)
    want_p, want_l = gba_cuda.apply_step_plain(dp, prob.poses, dl, prob.landmarks)
    assert _rel(new_p, want_p) <= LM_TOL and torch.equal(new_l, want_l)
    assert torch.equal(new_p[0], prob.poses[0])            # a zero step keeps the pose
    torch.cuda.synchronize()
    assert {k: counts[k] - before[k] for k in names} == dict(
        gba_linearize=2, gba_pose_blocks=2, gba_cost=2, gba_apply_step=1)


def _span_kernels(prof, spans):
    """{span: names of the kernels that start inside its device windows} of
    a ``torch.profiler`` session, for the ``gba.*`` spans named."""
    windows, kernels = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        if name in spans:
            windows.append((name, e.start_ns(), e.end_ns()))
        elif not name.startswith(("gba.", "Memcpy", "Memset")):
            kernels.append((name, e.start_ns()))
    found = {s: [] for s in spans}
    for span, lo, hi in windows:
        found[span] += [n for n, t in kernels if lo <= t <= hi]
    return found


@pytest.mark.gpu
def test_visual_solve_on_the_card_goes_through_the_lm_kernels(cuda):
    """A 4-iteration visual solve on the card: no wait for the device, one
    launch of ``gba_linearize``, ``gba_pose_blocks`` and ``gba_apply_step``
    an LM iteration and one ``gba_cost`` an iteration and once more in
    ``gba.final``; the same bits twice; the accept test's cost pass on
    ``gba_linearize_kernel`` and ``gba_pose_blocks_kernel``, and no cuBLAS
    gemm or gemv inside its ``gba.linearize`` and ``gba.accept`` spans; the
    CPU solve's cost within 1e-3."""
    prob, cam, _ = _lm_case("euroc_shape", cuda)
    prob = prob._replace(lm_valid=torch.ones_like(prob.lm_valid),
                         landmarks=prob.landmarks.clone())
    prob.landmarks[5, 2] += 100.0
    K = prob.poses.shape[0]
    seg = global_ba.PoseSegments(prob.obs_kf, prob.obs_mask, K)
    its, cg = 4, 16

    def run():
        return global_ba.global_bundle_adjust(prob, cam, seg, iterations=its, cg_iters=cg)
    global_ba.global_bundle_adjust(prob, cam, seg, iterations=1, cg_iters=2)
    torch.cuda.synchronize()
    counts = cuda_build.launch_counts
    names = ("gba_linearize", "gba_pose_blocks", "gba_apply_step", "gba_cost")
    before = {k: counts[k] for k in names}
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert {k: counts[k] - before[k] for k in names} == dict(
        gba_linearize=its, gba_pose_blocks=its, gba_apply_step=its, gba_cost=its + 1)
    again = run()
    for f in first._fields:
        assert torch.equal(getattr(first, f), getattr(again, f)), f
    assert float(first.cost) < 0.5 * float(global_ba.ba_cost(prob, cam))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    found = _span_kernels(prof, ("gba.linearize", "gba.accept"))
    assert any("gba_linearize_kernel" in n for n in found["gba.linearize"]), found
    for kernel in ("gba_linearize_kernel", "gba_pose_blocks_kernel"):
        assert any(kernel in n for n in found["gba.accept"]), (kernel, found)
    blas = [n for names_ in found.values() for n in names_ if "gemm" in n or "gemv" in n]
    assert not blas, blas
    p_c = type(prob)(*(t.cpu() for t in prob))
    seg_c = global_ba.PoseSegments(p_c.obs_kf, p_c.obs_mask, K)
    on_cpu = global_ba.global_bundle_adjust(p_c, cam, seg_c, iterations=its, cg_iters=cg)
    np.testing.assert_allclose(float(first.cost), float(on_cpu.cost), rtol=1e-3)
