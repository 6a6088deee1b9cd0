"""Port vs JAX: the Schur bundle adjustment on the same f32 problem
(seeded numpy, through ``convert.ba_problem_from_numpy``) and the map →
problem assembly.

Tolerances: one linearization and one damped Schur step to 1e-4 of each
array's scale (3e-4 on the pose step, see there); ten iterations of ``bundle_adjust`` on a small well-posed
problem (8 poses, 256 landmarks, 4 observations each, 5% gross outliers)
to 1e-4 m / 1e-4 rad on poses and landmarks, 1e-3 relative on the final
cost, inlier masks equal on ≥ 99.5% of observations (observed: 5e-7 m on
poses, 4.3e-5 m on landmarks, 1e-7 on the cost, equal masks);
``ba_assembly`` exact. JAX runs with x64 off, as outside the test suite."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu.optim import local_ba as j_ba
from orb_slam3_rgbl_tpu.slam import ba_assembly as j_asm
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from orb_slam3_rgbl_tpu_torch.optim import local_ba as t_ba
from orb_slam3_rgbl_tpu_torch.slam import ba_assembly as t_asm

from test_torch_map_ops import _assert_equal, _build

K, M, D = 8, 256, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cams():
    jcfg = j_syn.synthetic_rgbl_config()
    return jcfg.camera, convert.config_from_dict(dataclasses.asdict(jcfg)).camera


def _problem(rng, cam):
    """Eight cameras along a weaving line, 256 landmarks in front of them,
    each seen by 4 of the cameras with 0.5 px noise, a pseudo-stereo
    column on half the observations, 5% gross outliers, a few masked
    observations, one invalid landmark and one invalid pose slot; the
    first pose is fixed, the others start 5 cm / 0.3° off and the
    landmarks 10 cm off."""
    poses = np.zeros((K, 7), np.float32)
    for k in range(K):
        q = np.array([1.0, 0, 0, 0]) + rng.normal(0, 0.01, 4)
        poses[k] = np.concatenate([q / np.linalg.norm(q), [-0.5 * k, 0.05 * np.sin(k), -0.4 * k]])
    X = np.stack([rng.uniform(-5, 5, M), rng.uniform(-2, 1.5, M), rng.uniform(6, 25, M)], 1)
    X = X.astype(np.float32)
    obs_kf = np.stack([rng.permutation(K - 1)[:D] for _ in range(M)]).astype(np.int32)
    pc = t_lie.np_se3_apply(poses[obs_kf], X[:, None, :])
    u = cam.fx * pc[..., 0] / pc[..., 2] + cam.cx
    v = cam.fy * pc[..., 1] / pc[..., 2] + cam.cy
    uv = np.stack([u, v], -1) + rng.normal(0, 0.5, (M, D, 2))
    ur = np.where(rng.uniform(size=(M, D)) < 0.5,
                  uv[..., 0] - cam.bf / pc[..., 2] + rng.normal(0, 0.5, (M, D)), -1.0)
    out = rng.uniform(size=(M, D)) < 0.05
    uv[out] += rng.uniform(-30, 30, (int(out.sum()), 2))
    mask = rng.uniform(size=(M, D)) < 0.97
    lm_valid = np.ones(M, bool)
    lm_valid[-1] = False
    pose_valid = np.ones(K, bool)
    pose_valid[-1] = False                      # slot K-1 is padding: nothing observes it
    start = poses.copy()
    start[1:, 4:] += rng.normal(0, 0.05, (K - 1, 3))
    dq = np.concatenate([np.ones((K - 1, 1)), rng.normal(0, 0.0025, (K - 1, 3))], 1)
    start[1:, :4] = t_lie.np_quat_mul(dq / np.linalg.norm(dq, axis=1, keepdims=True),
                                      poses[1:, :4])
    f = np.float32
    arrays = dict(poses=start.astype(f), pose_fixed=np.arange(K) == 0, pose_valid=pose_valid,
                  landmarks=(X + rng.normal(0, 0.1, X.shape)).astype(f), lm_valid=lm_valid,
                  obs_kf=obs_kf, obs_uv=uv.astype(f), obs_ur=ur.astype(f),
                  obs_inv_sigma2=(1.0 / 1.44 ** rng.integers(0, 4, (M, D))).astype(f),
                  obs_mask=mask)
    return arrays, poses, X


def _jax_problem(arrays):
    return j_ba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _scaled_close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def test_linearize_and_schur_step_match_jax(rng, cams):
    cam_j, cam_t = cams
    arrays, _, _ = _problem(rng, cam_j)
    P_t = convert.ba_problem_from_numpy(arrays, device="cpu")
    assert P_t.obs_kf.dtype == torch.int64 and P_t.poses.dtype == torch.float32
    with jax.enable_x64(False):
        P_j = _jax_problem(arrays)
        lin_j = j_ba._linearize(P_j, cam_j, True, P_j.obs_mask)
        r, Jp, Jl, w = lin_j[:4]
        step_j = j_ba._build_and_solve(P_j, cam_j, r, Jp, Jl, w, jnp.float32(1e-4), K)
        lin_j, step_j = [np.asarray(a) for a in lin_j], [np.asarray(a) for a in step_j]
    lin_t = t_ba._linearize(P_t, cam_t, True, P_t.obs_mask)
    names = ("r", "Jp", "Jl", "w", "chi2", "active", "cost")
    for name, a_t, a_j in zip(names, lin_t, lin_j):
        if name == "active":
            np.testing.assert_array_equal(a_t.numpy(), a_j)
        else:
            _scaled_close(a_t.numpy(), a_j, 1e-4, name)
    # the step from the JAX linearization, so only the solve is compared
    lam = torch.tensor(1e-4)
    step_t = t_ba._build_and_solve(P_t, cam_t, *(torch.from_numpy(np.array(a)) for a in lin_j[:4]), lam, K)
    # the reduced camera system is solved in f32 on both sides: against the
    # same step in f64 the port is 8.4e-5 and JAX 5.4e-5 off, 1.25e-4 from
    # each other, so the pose step is held to 3e-4 where 1e-4 was aimed at
    _scaled_close(step_t[0].numpy(), step_j[0], 3e-4, "delta_poses")
    _scaled_close(step_t[1].numpy(), step_j[1], 1e-4, "delta_landmarks")
    assert np.abs(step_j[0][0]).max() == 0 and np.abs(step_t[0][[0, K - 1]]).max() == 0
    assert np.abs(step_j[0][1:K - 1]).max() > 1e-3


@pytest.mark.parametrize("n_iters", [None, 4])
def test_bundle_adjust_matches_jax(rng, cams, n_iters):
    cam_j, cam_t = cams
    arrays, true_poses, true_X = _problem(rng, cam_j)
    with jax.enable_x64(False):
        r_j = j_ba.bundle_adjust(_jax_problem(arrays), cam_j, iterations=10, n_iters=n_iters)
        r_j = [np.asarray(a) for a in r_j]
    r_t = t_ba.bundle_adjust(convert.ba_problem_from_numpy(arrays, device="cpu"), cam_t,
                             iterations=10, n_iters=n_iters)
    poses_t, lms_t, inl_t, cost_t = (a.numpy() for a in r_t)
    live = arrays["pose_valid"]
    np.testing.assert_allclose(poses_t[live, 4:], r_j[0][live, 4:], atol=1e-4)     # metres
    # rotation between the two solutions, in radians
    dq = t_lie.np_quat_mul(poses_t[live, :4], r_j[0][live, :4] * np.float32([1, -1, -1, -1]))
    assert (2 * np.linalg.norm(dq[:, 1:], axis=1)).max() < 1e-4
    np.testing.assert_allclose(lms_t[arrays["lm_valid"]], r_j[1][arrays["lm_valid"]], atol=1e-4)
    np.testing.assert_allclose(cost_t, r_j[3], rtol=1e-3)
    assert (inl_t == r_j[2]).mean() >= 0.995
    if n_iters is None:
        # and the solve did its job: near the truth, most outliers rejected
        assert np.abs(poses_t[live, 4:] - true_poses[live, 4:]).max() < 0.05
        assert np.median(np.linalg.norm(lms_t[:-1] - true_X[:-1], axis=1)) < 0.2
        assert 0.85 < inl_t[arrays["obs_mask"]].mean() < 0.97


def test_bundle_adjust_zero_iterations_keeps_the_state(rng, cams):
    cam_j, cam_t = cams
    arrays, _, _ = _problem(rng, cam_j)
    res = t_ba.bundle_adjust(convert.ba_problem_from_numpy(arrays, device="cpu"), cam_t, n_iters=0)
    np.testing.assert_array_equal(res.poses.numpy(), arrays["poses"])
    np.testing.assert_array_equal(res.landmarks.numpy(), arrays["landmarks"])
    assert torch.isinf(res.cost)


def test_ba_assembly_matches_jax_exactly():
    """``_tier``, ``build_full_problem`` and ``writeback`` on one map."""
    for n, lo in ((0, 32), (32, 32), (33, 32), (5000, 1024)):
        assert t_asm._tier(n, lo) == j_asm._tier(n, lo)
    jm = _build(3)
    tm = convert.map_state_from_numpy(jm)
    inv_s2 = (1.0 / 1.44 ** np.arange(8)).astype(np.float32)
    with jax.enable_x64(False):
        out_j = j_asm.build_full_problem(jm, inv_s2, max_obs=6)
    out_t = t_asm.build_full_problem(tm, inv_s2, max_obs=6, device="cpu")
    for a_t, a_j in zip(out_t[1:], out_j[1:]):
        np.testing.assert_array_equal(a_t, a_j)
    for name in t_ba.BAProblem._fields:
        a_t, a_j = getattr(out_t[0], name).numpy(), np.asarray(getattr(out_j[0], name))
        assert a_t.shape == a_j.shape, name
        np.testing.assert_array_equal(a_t, a_j, err_msg=name)
    assert out_t[0].poses.shape == (32, 7) and out_t[0].landmarks.shape == (1024, 3)
    assert tm.last_dropped_obs == jm.last_dropped_obs > 0
    # write a perturbed solution back, some observations classed outlier
    rng = np.random.default_rng(1)
    P = out_t[0]
    poses = P.poses.numpy() + rng.normal(0, 0.01, P.poses.shape).astype(np.float32)
    lms = P.landmarks.numpy() + rng.normal(0, 0.01, P.landmarks.shape).astype(np.float32)
    inlier = rng.uniform(size=P.obs_mask.shape) < 0.7
    mask = P.obs_mask.numpy()[: len(out_t[2])]
    for m, asm, (_, window, lm_ids, obs_kf, obs_feat) in ((tm, t_asm, out_t), (jm, j_asm, out_j)):
        asm.writeback(m, window, lm_ids, obs_kf, obs_feat, poses, lms, inlier, mask)
    _assert_equal(tm, jm, "writeback")
    assert tm.version == jm.version and len(tm.lm_free) > 0
