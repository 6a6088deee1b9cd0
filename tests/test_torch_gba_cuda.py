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
  the slot count allows."""

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
