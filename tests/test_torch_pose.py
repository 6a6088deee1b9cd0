"""Port vs JAX: the 4-round robust pose solve on the same observations."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import torch

from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu.optim import pose_opt as j_pose
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from orb_slam3_rgbl_tpu_torch.optim import pose_opt as t_pose


def _case(rng, cam, M=400):
    """Landmarks in front of the camera seen from a true pose, noisy pixel
    measurements, pseudo-stereo columns on half, 10% gross outliers and a
    few invalid slots; the solve starts from a perturbed pose."""
    X = np.stack([rng.uniform(-8, 8, M), rng.uniform(-2, 1.5, M), rng.uniform(4, 40, M)], 1)
    T_true = np.array([0.999, 0.02, -0.03, 0.01, 0.1, -0.05, 0.3])
    T_true[:4] /= np.linalg.norm(T_true[:4])
    T_true = T_true.astype(np.float32)
    pc = t_lie.np_se3_apply(T_true, X.astype(np.float32))
    u = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
    v = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
    uv = np.stack([u, v], 1) + rng.normal(0, 0.7, (M, 2))
    ur = np.where(rng.uniform(size=M) < 0.5, uv[:, 0] - cam.bf / pc[:, 2] + rng.normal(0, 0.7, M), -1.0)
    out = rng.uniform(size=M) < 0.1
    uv[out] += rng.uniform(-40, 40, (out.sum(), 2))
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 4, M))
    valid = rng.uniform(size=M) < 0.97
    T0 = T_true.copy()
    T0[4:] += np.array([0.15, -0.1, 0.3], np.float32)
    f = np.float32
    return T0, T_true, [X.astype(f), uv.astype(f), ur.astype(f), inv_s2.astype(f), valid]


def test_pose_optimize_matches_jax(rng):
    jcfg = j_syn.synthetic_rgbl_config()
    cam_j = jcfg.camera
    cam_t = convert.config_from_dict(dataclasses.asdict(jcfg)).camera
    T0, T_true, obs = _case(rng, cam_j)
    r_j = j_pose.pose_optimize(jnp.asarray(T0), j_pose.PoseObs(*(jnp.asarray(a) for a in obs)), cam_j)
    r_t = t_pose.pose_optimize(torch.from_numpy(T0),
                               t_pose.PoseObs(*(torch.from_numpy(np.array(a)) for a in obs)), cam_t)
    T_j, T_t = np.asarray(r_j.Tcw, np.float64), r_t.Tcw.numpy().astype(np.float64)
    # both converge to the same optimum; f32 normal equations solved in
    # different orders (the JAX side partly in f64 under the suite's x64):
    # 1e-4 on the unit quaternion and on metres
    np.testing.assert_allclose(T_t, T_j, atol=1e-4)
    np.testing.assert_allclose(T_t[4:], T_true[4:], atol=0.05)      # and near the truth
    np.testing.assert_array_equal(r_t.inliers.numpy(), np.asarray(r_j.inliers))
    assert int(r_t.n_inliers) == int(r_j.n_inliers) > 300
