"""Port vs JAX: ``geometry/align.py`` on the same f32 inputs made from a
seed. Tolerance 1e-5 (absolute) on rotations compared as matrices (a
quaternion and its negative are one rotation), translations, scales and
RMSEs of points a few metres apart (observed ≤ 2e-6).

JAX runs with x64 off, as outside the test suite."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu.geometry import align as j_align, lie as j_lie
from orb_slam3_rgbl_tpu_torch.geometry import align as t_align, lie as t_lie

TOL = 1e-5


def _scene(seed, n=60, scale=1.0):
    """model points, and data = scale·R·model + t with noise and a few
    gross outliers; a pose trajectory (Twc) of the same length."""
    rng = np.random.default_rng(seed)
    model = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    with jax.enable_x64(False):
        T = np.asarray(j_lie.se3_exp(jnp.asarray(rng.normal(0, 0.5, 6).astype(np.float32))))
        data = scale * np.asarray(j_lie.se3_apply(jnp.asarray(T), jnp.asarray(model)))
    data = (data + rng.normal(0, 0.05, data.shape)).astype(np.float32)
    data[:4] += 3.0
    weights = rng.uniform(0.0, 1.0, n).astype(np.float32)
    weights[:4] = 0.0                  # masked outliers
    tau = np.cumsum(rng.normal(0, 0.1, (n, 6)), axis=0).astype(np.float32)
    with jax.enable_x64(False):
        traj = np.array(j_lie.se3_exp(jnp.asarray(tau)))
    return model, data, weights, traj


def _rot(q_j, q_t):
    with jax.enable_x64(False):
        return np.asarray(j_lie.quat_to_matrix(jnp.asarray(q_j))), \
            t_lie.quat_to_matrix(q_t).numpy()


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_horn_align_matches_jax(with_scale, weighted):
    model, data, weights, _ = _scene(1, scale=1.3 if with_scale else 1.0)
    w = weights if weighted else None
    with jax.enable_x64(False):
        a_j = j_align.horn_align(jnp.asarray(model), jnp.asarray(data),
                                 None if w is None else jnp.asarray(w), with_scale=with_scale)
    a_t = t_align.horn_align(torch.from_numpy(model), torch.from_numpy(data),
                             None if w is None else torch.from_numpy(w), with_scale=with_scale)
    assert a_t.q.dtype == torch.float32 and a_t.q.shape == (4,)
    R_j, R_t = _rot(a_j.q, a_t.q)
    np.testing.assert_allclose(R_t, R_j, atol=TOL)
    np.testing.assert_allclose(a_t.t.numpy(), np.asarray(a_j.t), atol=TOL)
    np.testing.assert_allclose(float(a_t.s), float(a_j.s), atol=TOL)
    np.testing.assert_allclose(float(a_t.rmse), float(a_j.rmse), atol=TOL)
    if weighted:                       # the masked outliers do not pull the fit
        assert float(a_t.rmse) < 0.1
    if with_scale:
        assert abs(float(a_t.s) - 1.3) < 0.01
    else:
        assert float(a_t.s) == 1.0


@pytest.mark.parametrize("with_scale", [False, True])
def test_ate_rmse_matches_jax(with_scale):
    model, data, _, _ = _scene(2, scale=0.8)
    with jax.enable_x64(False):
        e_j = float(j_align.ate_rmse(jnp.asarray(data), jnp.asarray(model), with_scale))
    e_t = t_align.ate_rmse(data, model, with_scale)          # numpy in: a CPU tensor out
    assert e_t.device.type == "cpu"
    np.testing.assert_allclose(float(e_t), e_j, atol=TOL)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_from_correspondences_matches_jax(fix_scale):
    model, data, weights, _ = _scene(3, scale=1.0 if fix_scale else 0.7)
    with jax.enable_x64(False):
        S_j = np.asarray(j_align.sim3_from_correspondences(
            jnp.asarray(model), jnp.asarray(data), jnp.asarray(weights), fix_scale))
    S_t = t_align.sim3_from_correspondences(torch.from_numpy(model), torch.from_numpy(data),
                                            torch.from_numpy(weights), fix_scale).numpy()
    assert S_t.shape == (8,)
    R_j, R_t = _rot(S_j[:4], torch.from_numpy(S_t[:4]))
    np.testing.assert_allclose(R_t, R_j, atol=TOL)
    np.testing.assert_allclose(S_t[4:], S_j[4:], atol=TOL)


@pytest.mark.parametrize("delta", [1, 5])
def test_rpe_translation_matches_jax(delta):
    _, _, _, traj = _scene(4)
    rng = np.random.default_rng(5)
    est = traj.copy()
    est[:, 4:7] += rng.normal(0, 0.03, (len(est), 3)).astype(np.float32)
    with jax.enable_x64(False):
        e_j = float(j_align.rpe_translation(jnp.asarray(traj), jnp.asarray(est), delta))
    e_t = float(t_align.rpe_translation(traj, est, delta))
    np.testing.assert_allclose(e_t, e_j, atol=TOL)
    assert 0.01 < e_t < 0.1
