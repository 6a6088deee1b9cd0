"""Port vs JAX: the visual-inertial solvers of ``optim/inertial.py`` on
``tests/test_inertial.py``'s problems (the same float32 inputs, made from
the suite's seeded numpy generator).

Both packages linearize with forward-mode autodiff and run the same damped
steps and accept tests; the f32 rounding of the two libraries differs, so
the results agree to the solve's noise, not to the bit. Tolerances (each
observed ≥ 5× below its bound): pose solves — the pose within 2e-4 (se3
log norm), velocity 1e-3 m/s, biases 1e-4, the same inlier count, the
Hessian / marginal Hessian within 1e-3 of its largest entry; IMU
initialization — the gravity direction within 1e-4 rad, scale 1e-3
relative (observed 2.1e-4: the refinement ends at the f32 noise floor of its
normalized weights, where the two libraries accept different last steps),
gyro bias 1e-5, accel bias 1e-4, velocities 2e-3 m/s, both costs under
1e-10 (within 1e-3 relative with the scale held at 1). JAX runs with x64 off, as outside the test suite."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from orb_slam3_rgbl_tpu.geometry import lie as jlie
from orb_slam3_rgbl_tpu.imu import preintegration as jpre
from orb_slam3_rgbl_tpu.optim import inertial as jin
from orb_slam3_rgbl_tpu.slam import imu_frontend as jfront
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import lie as tlie
from orb_slam3_rgbl_tpu_torch.imu import preintegration as tpre
from orb_slam3_rgbl_tpu_torch.optim import inertial as tin
from orb_slam3_rgbl_tpu_torch.optim.pose_opt import PoseObs as TPoseObs
from orb_slam3_rgbl_tpu_torch.slam import imu_frontend as tfront

import test_inertial as ti
from test_torch_system import one_torch_thread  # noqa: F401  (module fixture)

CPU = torch.device("cpu")
TCAM = convert.config_from_dict(dataclasses.asdict(ti.kitti_rgbl_config())).camera


def T(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return np.asarray(x, np.float32)


def t_meas(m):
    """A JAX Preintegrated (single or stacked) as the port's."""
    flat = jfront.preint_to_numpy(m)
    if np.asarray(flat[0]).ndim == 0:
        return tfront.preint_from_numpy(flat, CPU)
    return tfront.stack_preints([tuple(np.asarray(a)[i] for a in flat)
                                 for i in range(np.asarray(flat[0]).shape[0])], CPU)


def t_state(s):
    return tin.VIState(T(_np(s.Twb)), T(_np(s.vw)), tpre.ImuBias(T(_np(s.bias.bg)),
                                                                 T(_np(s.bias.ba))))


def t_obs(o):
    return TPoseObs(T(_np(o.Xw)), T(_np(o.uv)), T(_np(o.u_right)), T(_np(o.inv_sigma2)),
                    T(np.asarray(o.valid)))


def pose_gap(Ta, Tb) -> float:
    d = tlie.np_se3_mul(_np(Ta), tlie.np_se3_inv(_np(Tb))).astype(np.float64)
    ang = 2 * np.arcsin(min(np.linalg.norm(d[1:4]), 1.0))
    return float(np.hypot(np.linalg.norm(d[4:7]), ang))


def check_state(a, b, v_tol=1e-3, b_tol=1e-4):
    assert pose_gap(a.Twb, b.Twb) < 2e-4, pose_gap(a.Twb, b.Twb)
    assert np.abs(_np(a.vw) - _np(b.vw)).max() < v_tol
    assert np.abs(_np(a.bias.bg) - _np(b.bias.bg)).max() < b_tol
    assert np.abs(_np(a.bias.ba) - _np(b.bias.ba)).max() < b_tol


def check_hessian(Hj, Ht):
    Hj, Ht = np.asarray(Hj, np.float64), Ht.numpy().astype(np.float64)
    assert np.abs(Hj - Ht).max() < 1e-3 * np.abs(Hj).max(), np.abs(Hj - Ht).max()


def _pose_scene(rng):
    """``TestInertialPoseOptimize``'s scene, built by the JAX test's code."""
    states, metas, dt = ti.simulate_vi(rng)
    (R0, v0, p0), (R1, v1, p1) = states[0], states[1]
    with jax.enable_x64(False):
        meas = jpre.preintegrate(jnp.asarray(metas[0][0]), jnp.asarray(metas[0][1]),
                                 jnp.full(len(metas[0][0]), dt, jnp.float32),
                                 jnp.ones(len(metas[0][0]), bool), jpre.ImuBias.zero())
        mat = lambda R: jlie.matrix_to_quat(jnp.asarray(R.astype(np.float32)))  # noqa: E731
        prev = jin.VIState(Twb=jlie.se3(mat(R0), jnp.asarray(p0.astype(np.float32))),
                           vw=jnp.asarray(v0.astype(np.float32)), bias=jpre.ImuBias.zero())
        true_Twb = jlie.se3(mat(R1), jnp.asarray(p1.astype(np.float32)))
        m = 150
        Xw_cam = rng.uniform([-15, -15, 5], [15, 15, 50], (m, 3)).astype(np.float32)
        Xw = np.asarray(jlie.se3_apply(true_Twb, jnp.asarray(Xw_cam)))
        pc = np.asarray(jlie.se3_apply(jlie.se3_inv(true_Twb), jnp.asarray(Xw)))
        uv = np.array(ti.camera.project(ti.CAM, jnp.asarray(pc))) + rng.normal(0, 0.3, (m, 2))
        ur = uv[:, 0] - ti.CAM.bf / pc[:, 2] + rng.normal(0, 0.3, m)
        obs = jin.PoseObs(Xw=jnp.asarray(Xw), uv=jnp.asarray(uv.astype(np.float32)),
                          u_right=jnp.asarray(ur.astype(np.float32)),
                          inv_sigma2=jnp.ones(m, jnp.float32), valid=jnp.ones(m, bool))
        init = jin.VIState(
            Twb=jlie.se3_mul(jlie.se3_exp(jnp.asarray([0.1, -0.05, 0.08, 0.01, 0.02, -0.01],
                                                      jnp.float32)), true_Twb),
            vw=jnp.asarray((v1 + rng.normal(0, 0.2, 3)).astype(np.float32)),
            bias=jpre.ImuBias.zero())
    return prev, init, meas, obs, true_Twb


def test_inertial_pose_optimize_matches_jax(rng):
    prev, init, meas, obs, true_Twb = _pose_scene(rng)
    T_cb = np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32)
    with jax.enable_x64(False):
        sj, nj, Hj = jin.inertial_pose_optimize(init, prev, meas, obs, jnp.asarray(T_cb), ti.CAM)
    st, nt, Ht = tin.inertial_pose_optimize(t_state(init), t_state(prev), t_meas(meas),
                                            t_obs(obs), T(T_cb), TCAM)
    check_state(sj, st)
    assert int(nj) == int(nt) > 120
    check_hessian(Hj, Ht)
    assert pose_gap(st.Twb, true_Twb) < 5e-3


def test_inertial_pose_optimize_prior_matches_jax(rng):
    """``TestInertialPriorChain``'s bad anchor under a moderate prior."""
    prev, init, meas, obs, _ = _pose_scene(rng)
    with jax.enable_x64(False):
        bad = jin.VIState(
            Twb=jlie.se3_mul(jlie.se3_exp(jnp.asarray([0.0, 0.0, 0.0, 0.05, -0.08, 0.06],
                                                      jnp.float32)), prev.Twb),
            vw=prev.vw + jnp.asarray([0.3, -0.2, 0.25], jnp.float32),
            bias=jpre.ImuBias(jnp.asarray([0.05, -0.04, 0.06], jnp.float32),
                              jnp.zeros(3, jnp.float32)))
        L = np.eye(15, dtype=np.float32) * 10.0
        T_cb = np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32)
        cj, pj, nj, Hj = jin.inertial_pose_optimize_prior(init, bad, jnp.asarray(L), meas, obs,
                                                          jnp.asarray(T_cb), ti.CAM)
    ct, pt, nt, Ht = tin.inertial_pose_optimize_prior(t_state(init), t_state(bad), T(L),
                                                      t_meas(meas), t_obs(obs), T(T_cb), TCAM)
    check_state(cj, ct)
    check_state(pj, pt)
    assert int(nj) == int(nt) > 100
    check_hessian(Hj, Ht)


def test_imu_initialization_matches_jax(rng):
    """``TestImuInitialization``'s tilted, scaled, gyro-biased keyframes,
    with the scale free (monocular) and fixed."""
    from scipy.spatial.transform import Rotation

    bg_true = np.array([0.02, -0.01, 0.015])
    states, metas, dt = ti.simulate_vi(rng, n_kf=8, samples_per_kf=60, bg=bg_true)
    R_tilt = Rotation.from_rotvec([0.15, -0.1, 0.0]).as_matrix()
    with jax.enable_x64(False):
        Twb = np.stack([np.concatenate([
            np.asarray(jlie.matrix_to_quat(jnp.asarray((R_tilt.T @ R).astype(np.float32)))),
            ((R_tilt.T @ p) / 2.5).astype(np.float32)]) for R, v, p in states])
        meas = ti.preintegrate_all(metas, dt, jpre.ImuBias.zero())
    valid = np.ones(len(states) - 1, bool)
    valid[3] = False                      # one pair without a chain link
    for fix_scale in (False, True):
        with jax.enable_x64(False):
            oj = jin.imu_initialization(jnp.asarray(Twb), meas, jnp.asarray(valid),
                                        prior_g=1e2, prior_a=1e8, fix_scale=fix_scale)
            gj = np.asarray(jlie.quat_rotate(oj["Rwg"], jnp.asarray([0.0, 0.0, -9.81])))
        ot = tin.imu_initialization(T(Twb), t_meas(meas), T(valid), prior_g=1e2, prior_a=1e8,
                                    fix_scale=fix_scale)
        gt = tlie.quat_rotate(ot["Rwg"], T(np.asarray([0.0, 0.0, -9.81], np.float32))).numpy()
        gj, gt = gj.astype(np.float64), gt.astype(np.float64)
        ang = np.arctan2(np.linalg.norm(np.cross(gj, gt)), gj @ gt)
        assert ang < 1e-4, ang
        assert abs(float(ot["scale"]) - float(oj["scale"])) < 1e-3 * float(oj["scale"])
        assert np.abs(ot["bias"].bg.numpy() - _np(oj["bias"].bg)).max() < 1e-5
        assert np.abs(ot["bias"].ba.numpy() - _np(oj["bias"].ba)).max() < 1e-4
        assert np.abs(ot["velocities"].numpy() - _np(oj["velocities"])).max() < 2e-3
        cj, ct = float(oj["cost"]), float(ot["cost"])
        if fix_scale:          # the poses' scale 2.5 held at 1: a cost well above the noise
            assert abs(ct - cj) < 1e-3 * cj, (ct, cj)
        else:
            # the refinement ends at the f32 noise floor of its normalized
            # weights (~1e-11), where the two libraries' sums accept different steps
            assert cj < 1e-10 and ct < 1e-10, (ct, cj)
        if not fix_scale:
            assert abs(float(ot["scale"]) - 2.5) / 2.5 < 0.05
        else:
            assert float(ot["scale"]) == 1.0
