"""Port vs JAX: the Sim3 group functions of ``geometry/lie.py`` and their
numpy twins, on the same f32 inputs made from a seed. Tolerance 1e-6
(absolute, on unit quaternions, metres up to ~3 and scales near 1;
observed ≤ 5e-7), 2e-6 on ``sim3_log`` of composed elements."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu.geometry import lie as j_lie
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie

TOL = 1e-6


@pytest.fixture(scope="module")
def elems():
    rng = np.random.default_rng(0)
    tau = rng.normal(0, 0.4, (40, 7)).astype(np.float32)
    tau[:, 6] *= 0.3
    tau[0] = 0.0                       # the identity
    tau[1, 3:6] = 0.0                  # θ → 0 with a scale
    tau[2, 6] = 0.0                    # σ → 0 with a rotation
    tau[3, 3:] = 0.0                   # both limits
    tau[4, 3:6] = [1e-5, -2e-5, 1e-5]  # just past the Taylor guard
    pts = rng.uniform(-5, 5, (40, 3)).astype(np.float32)
    return tau, pts


def _t(a):
    return torch.from_numpy(np.array(a))


def test_sim3_exp_log_match_jax(elems):
    tau, _ = elems
    with jax.enable_x64(False):
        S_j = np.asarray(j_lie.sim3_exp(jnp.asarray(tau)))
        back_j = np.asarray(j_lie.sim3_log(jnp.asarray(S_j)))
    S_t = t_lie.sim3_exp(_t(tau))
    assert S_t.dtype == torch.float32 and S_t.shape == (40, 8)
    np.testing.assert_allclose(S_t.numpy(), S_j, atol=TOL)
    np.testing.assert_allclose(t_lie.sim3_log(_t(S_j)).numpy(), back_j, atol=2e-6)
    np.testing.assert_allclose(t_lie.sim3_log(S_t).numpy(), tau, atol=5e-6)
    np.testing.assert_allclose(t_lie.so3_log(_t(S_j[:, :4])).numpy(),
                               np.asarray(j_lie.so3_log(jnp.asarray(S_j[:, :4]))), atol=TOL)


@pytest.mark.parametrize("name", ["sim3_mul", "sim3_inv", "sim3_apply", "sim3_from_se3",
                                  "sim3_to_se3"])
def test_sim3_group_functions_match_jax_and_numpy_twins(elems, name):
    tau, pts = elems
    with jax.enable_x64(False):
        S = np.asarray(j_lie.sim3_exp(jnp.asarray(tau)))
    A, B = S[:20], S[20:]
    args = {"sim3_mul": (A, B), "sim3_inv": (S,), "sim3_apply": (S, pts),
            "sim3_from_se3": (S[:, :7],), "sim3_to_se3": (S,)}[name]
    with jax.enable_x64(False):
        out_j = np.asarray(getattr(j_lie, name)(*(jnp.asarray(a) for a in args)))
    out_t = getattr(t_lie, name)(*(_t(a) for a in args)).numpy()
    out_np = getattr(t_lie, "np_" + name)(*args)
    np.testing.assert_allclose(out_t, out_j, atol=TOL)
    np.testing.assert_allclose(out_np, getattr(j_lie, "np_" + name)(*args), atol=0)
    np.testing.assert_allclose(out_np, out_j, atol=2e-6)
    assert out_np.dtype == np.float32


def test_sim3_parts_identity_and_constructor(elems):
    tau, _ = elems
    S = t_lie.sim3_exp(_t(tau))
    q, t, s = t_lie.sim3_parts(S)
    np.testing.assert_array_equal(t_lie.sim3(q, t, s).numpy(), S.numpy())
    np.testing.assert_array_equal(t_lie.sim3(q, t, 2.0)[:, 7].numpy(), np.full(40, 2.0, np.float32))
    ident = t_lie.sim3_identity(device="cpu")
    np.testing.assert_array_equal(ident.numpy(), np.asarray(j_lie.sim3_identity()))
    np.testing.assert_allclose(t_lie.sim3_mul(S, t_lie.sim3_inv(S)).numpy(),
                               np.tile(ident.numpy(), (40, 1)), atol=5e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_lie.sim3_identity()


def test_sim3_log_differentiates_under_vmap(elems):
    """The pose graph takes forward-mode Jacobians of ``sim3_log`` under
    ``vmap``: finite, f32, and equal to JAX's."""
    tau, _ = elems
    S = t_lie.sim3_exp(_t(tau))
    J_t = torch.func.vmap(torch.func.jacfwd(t_lie.sim3_log))(S)
    with jax.enable_x64(False):
        J_j = np.asarray(jax.vmap(jax.jacfwd(j_lie.sim3_log))(jnp.asarray(S.numpy())))
    assert J_t.dtype == torch.float32 and torch.isfinite(J_t).all()
    np.testing.assert_allclose(J_t.numpy(), J_j, atol=2e-5)
