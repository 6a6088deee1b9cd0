"""Port vs JAX: ``optim/sim3.py`` and ``optim/pnp.rigid_pnp_ransac`` on the
same f32 inputs made from a seed.

* ``_horn_sim3_3pt``: 1e-4 on quaternion (up to sign), translation and
  scale, over minimal sets drawn from a scene 8–50 m deep (observed ≤ 2e-5;
  the two SVDs differ in the last bits and a minimal set amplifies them);
* ``sim3_ransac`` / ``rigid_pnp_ransac``: fed the integers that JAX's
  ``jax.random.randint`` drew, hypothesis for hypothesis: every well-posed
  hypothesis within 1e-4 on the rotation and 5e-4 m on the translation (a
  hypothesis through an outlier lies up to 20 m off; observed 2.4e-4) of JAX's closed
  form on the same minimal set, the same winner, the same inlier mask
  (tolerance 0 on masks and counts);
* ``optimize_sim3`` (10 Gauss-Newton steps): 1e-4 on the Sim3, equal
  inlier masks (observed ≤ 1e-5).

JAX runs with x64 off, as outside the test suite."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu.config import kitti_rgbl_config
from orb_slam3_rgbl_tpu.geometry import lie as j_lie
from orb_slam3_rgbl_tpu.optim import pnp as j_pnp, sim3 as j_sim3
from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera
from orb_slam3_rgbl_tpu_torch.optim import pnp as t_pnp, sim3 as t_sim3

import dataclasses

J_CAM = kitti_rgbl_config().camera
T_CAM = PinholeCamera(**dataclasses.asdict(J_CAM))
TOL = 1e-4
H = 512


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(seed, P=150, outlier_frac=0.2, fix_scale=True, n_pad=0):
    """Matched camera-frame points of two views with gross outliers, their
    keypoints and variances; ``n_pad`` invalid rows at the end."""
    rng = np.random.default_rng(seed)
    p2 = np.stack([rng.uniform(-10, 10, P), rng.uniform(-4, 4, P), rng.uniform(8, 50, P)],
                  axis=1).astype(np.float32)
    tau = np.array([0.4, -0.2, 0.3, 0.04, 0.02, -0.05, 0.0 if fix_scale else 0.1], np.float32)
    with jax.enable_x64(False):
        S12 = np.asarray(j_lie.sim3_exp(jnp.asarray(tau)))
        p1 = np.array(j_lie.sim3_apply(jnp.asarray(S12), jnp.asarray(p2)))
    clean = p1.copy()
    out_idx = rng.choice(P, int(P * outlier_frac), replace=False)
    p1[out_idx] += rng.uniform(2, 5, (len(out_idx), 3)).astype(np.float32)

    def proj(p):
        return np.stack([J_CAM.fx * p[:, 0] / p[:, 2] + J_CAM.cx,
                         J_CAM.fy * p[:, 1] / p[:, 2] + J_CAM.cy], axis=1).astype(np.float32)

    uv1 = proj(clean) + rng.normal(0, 0.5, (P, 2)).astype(np.float32)
    uv2 = proj(p2) + rng.normal(0, 0.5, (P, 2)).astype(np.float32)
    s2 = (1.2 ** (2 * rng.integers(0, 4, (2, P)))).astype(np.float32)
    valid = np.ones(P + n_pad, bool)
    valid[P:] = False

    def pad(a, fill=0.0):
        return np.concatenate([a, np.full((n_pad,) + a.shape[1:], fill, np.float32)])

    return (S12, pad(p1), pad(p2), pad(uv1), pad(uv2), pad(s2[0], 1.0), pad(s2[1], 1.0), valid)


def _well_posed(p, idx):
    """Minimal sets whose triangle spans over 4 m²: a thin or repeated set
    leaves the rotation about its long side undetermined to f32."""
    a, b, c = p[idx[:, 0]], p[idx[:, 1]], p[idx[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1) > 4.0


def _same_sim3(a, b, tol=TOL, t_tol=None):
    a, b = np.asarray(a), np.asarray(b)
    sign = np.sign(np.sum(a[..., :4] * b[..., :4], axis=-1, keepdims=True))
    np.testing.assert_allclose(a[..., :4] * sign, b[..., :4], atol=tol)
    np.testing.assert_allclose(a[..., 4:], b[..., 4:], atol=t_tol or tol)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_horn_sim3_3pt_matches_jax(fix_scale):
    _, p1, p2, *_ = _scene(1, outlier_frac=0.0, fix_scale=fix_scale)
    idx = np.random.default_rng(2).integers(0, 150, (200, 3))
    idx = idx[_well_posed(p2, idx)]
    assert len(idx) > 150
    with jax.enable_x64(False):
        S_j = np.asarray(j_sim3._horn_sim3_3pt(jnp.asarray(p1[idx]), jnp.asarray(p2[idx]),
                                               fix_scale))
    S_t = t_sim3._horn_sim3_3pt(_t(p1[idx]), _t(p2[idx]), fix_scale)
    assert S_t.dtype == torch.float32 and S_t.shape == (len(idx), 8)
    _same_sim3(S_t.numpy(), S_j)
    if fix_scale:
        assert (S_t[:, 7] == 1.0).all()
    else:
        np.testing.assert_allclose(S_t[:, 7].numpy(), np.exp(0.1), atol=2e-3)


def _jax_draws(key, P):
    with jax.enable_x64(False):
        return np.asarray(jax.random.randint(key, (H, 3), 0, P))


@pytest.mark.parametrize("fix_scale,n_pad", [(True, 0), (False, 0), (True, 106)])
def test_sim3_ransac_on_jax_draws(fix_scale, n_pad):
    S_true, p1, p2, uv1, uv2, s1, s2, valid = _scene(4, fix_scale=fix_scale, n_pad=n_pad)
    P = p1.shape[0]
    key = jax.random.PRNGKey(7)
    draws = _jax_draws(key, P)
    with jax.enable_x64(False):
        res_j = j_sim3.sim3_ransac(*(jnp.asarray(a) for a in (p1, p2, uv1, uv2, s1, s2, valid)),
                                   J_CAM, key, n_hypotheses=H, fix_scale=fix_scale)
    args_t = [_t(a) for a in (p1, p2, uv1, uv2, s1, s2, valid)]
    res_t = t_sim3.sim3_ransac(*args_t, T_CAM, n_hypotheses=H, fix_scale=fix_scale,
                               draws=_t(draws))
    # every hypothesis against JAX's closed form on the same minimal set
    idx_t = t_sim3.minimal_sets(_t(valid), H, None, _t(draws))
    S_all, _, counts = t_sim3.sim3_hypotheses(*args_t, T_CAM, idx_t, fix_scale)
    idx = idx_t.numpy()
    assert valid[idx].all() and idx.shape == (H, 3)
    with jax.enable_x64(False):
        order = np.asarray(jnp.argsort(~jnp.asarray(valid)))
        S_j = np.asarray(j_sim3._horn_sim3_3pt(jnp.asarray(p1[idx]), jnp.asarray(p2[idx]),
                                               fix_scale))
    np.testing.assert_array_equal(idx, order[draws % valid.sum()])
    sound = _well_posed(p2, idx)
    assert sound.sum() > H // 2
    _same_sim3(S_all.numpy()[sound], S_j[sound], t_tol=5e-4)
    # the winner
    best = int(np.argmax(counts.numpy()))
    assert int(counts[best]) == int(res_t.n_inliers) == int(res_j.n_inliers) >= 100
    _same_sim3(res_t.S12.numpy(), np.asarray(res_j.S12))
    np.testing.assert_array_equal(res_t.inliers.numpy(), np.asarray(res_j.inliers))
    assert res_t.n_inliers.dtype == torch.int32 and not res_t.inliers[~_t(valid)].any()
    _same_sim3(res_t.S12.numpy(), S_true, tol=0.05)


def test_ransac_ties_take_the_first_and_draws_come_from_the_generator():
    counts = torch.tensor([3, 7, 7, 2, 7])
    assert int(t_sim3.first_argmax(counts)) == 1
    _, p1, p2, uv1, uv2, s1, s2, valid = _scene(5)
    args = [_t(a) for a in (p1, p2, uv1, uv2, s1, s2, valid)]
    with pytest.raises(ValueError, match="Generator"):
        t_sim3.sim3_ransac(*args, T_CAM)
    a = t_sim3.sim3_ransac(*args, T_CAM, generator=torch.Generator().manual_seed(1))
    b = t_sim3.sim3_ransac(*args, T_CAM, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a.S12.numpy(), b.S12.numpy())
    assert int(a.n_inliers) >= 100


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_sim3_matches_jax(fix_scale):
    S_true, p1, p2, uv1, uv2, s1, s2, valid = _scene(6, outlier_frac=0.1, fix_scale=fix_scale,
                                                     n_pad=20)
    with jax.enable_x64(False):
        S0 = np.asarray(j_lie.sim3_mul(j_lie.sim3_exp(jnp.asarray(
            [0.05, -0.05, 0.02, 0.01, -0.01, 0.005, 0.0], jnp.float32)), jnp.asarray(S_true)))
        S_j, inl_j, n_j = j_sim3.optimize_sim3(
            *(jnp.asarray(a) for a in (S0, p1, p2, uv1, uv2, 1 / s1, 1 / s2, valid)), J_CAM,
            fix_scale=fix_scale)
    S_t, inl_t, n_t = t_sim3.optimize_sim3(
        *(_t(a) for a in (S0, p1, p2, uv1, uv2, 1 / s1, 1 / s2, valid)), T_CAM,
        fix_scale=fix_scale)
    assert S_t.dtype == torch.float32 and n_t.dtype == torch.int32
    _same_sim3(S_t.numpy(), np.asarray(S_j))
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j) >= 0.8 * 135
    _same_sim3(S_t.numpy(), S_true, tol=0.02)
    if fix_scale:
        assert float(S_t[7]) == 1.0


@pytest.mark.parametrize("n_pad", [0, 106])
def test_rigid_pnp_ransac_on_jax_draws(n_pad):
    """Query points in the camera frame against world landmarks: p_cam ≈ Tcw · X_w."""
    S_true, p_cam, X_w, uv, _, s2, _, valid = _scene(8, n_pad=n_pad)
    P = p_cam.shape[0]
    key = jax.random.PRNGKey(13)
    with jax.enable_x64(False):
        draws = np.asarray(jax.random.randint(key, (256, 3), 0, P))
        res_j = j_pnp.rigid_pnp_ransac(*(jnp.asarray(a) for a in (p_cam, X_w, uv, s2, valid)),
                                       J_CAM, key)
    args_t = [_t(a) for a in (p_cam, X_w, uv, s2, valid)]
    res_t = t_pnp.rigid_pnp_ransac(*args_t, T_CAM, draws=_t(draws))
    T_all, _, counts = t_pnp.rigid_pnp_hypotheses(
        *args_t, T_CAM, t_sim3.minimal_sets(_t(valid), 256, None, _t(draws)))
    assert T_all.shape == (256, 7) and int(res_t.n_inliers) == int(res_j.n_inliers) >= 100
    np.testing.assert_array_equal(res_t.inliers.numpy(), np.asarray(res_j.inliers))
    _same_sim3(res_t.Tcw.numpy(), np.asarray(res_j.Tcw))
    _same_sim3(res_t.Tcw.numpy(), S_true[:7], tol=0.05)
    assert int(t_sim3.first_argmax(counts)) == int(np.argmax(counts.numpy()))
    with pytest.raises(ValueError, match="Generator"):
        t_pnp.rigid_pnp_ransac(*(_t(a) for a in (p_cam, X_w, uv, s2, valid)), T_CAM)
