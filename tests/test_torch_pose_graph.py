"""Port vs JAX: ``optim/pose_graph.py`` on the same f32 problems.

The drift ring of ``tests/test_loop_components.py`` (12 nodes on a line,
biased odometry edges, one loop edge of weight 5 back to the fixed start):

* the edge linearization (residuals and both 7×7 Jacobians): 2e-5;
* one damped step: 1e-5 (observed ≤ 2e-6);
* 20 iterations: 1e-4 on every node (observed ≤ 1e-5), the fixed node
  untouched to the bit, the drift at the far end cut to under 30%;
* the same with ``fix_scale``, and with padded nodes and edges
  (``node_valid`` / ``edge_valid`` False), which the JAX closer produces.

JAX runs with x64 off, as outside the test suite."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu.geometry import lie as j_lie
from orb_slam3_rgbl_tpu.optim import pose_graph as j_pg
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from orb_slam3_rgbl_tpu_torch.optim import pose_graph as t_pg

K = 12


def _ring(pad_nodes=0, pad_edges=0):
    """(problem arrays by field name, ground-truth nodes)."""
    with jax.enable_x64(False):
        step = jnp.asarray([0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0], jnp.float32)
        drift = jnp.asarray([0.02, 0.0, 0.0, 0.0, 0.004, 0.0, 0.0], jnp.float32)
        gt = [np.asarray(j_lie.sim3_identity())]
        for _ in range(K - 1):
            gt.append(np.asarray(j_lie.sim3_mul(j_lie.sim3_exp(step), jnp.asarray(gt[-1]))))
        gt = np.stack(gt).astype(np.float32)
        meas = j_lie.sim3_mul(j_lie.sim3_exp(step), j_lie.sim3_exp(drift))
        nodes, ei, ej, Sij = [gt[0]], [], [], []
        for k in range(1, K):
            nodes.append(np.asarray(j_lie.sim3_mul(meas, jnp.asarray(nodes[-1]))))
            ei.append(k)
            ej.append(k - 1)
            Sij.append(np.asarray(meas))
        ei.append(K - 1)
        ej.append(0)
        Sij.append(np.asarray(j_pg.relative_sim3(jnp.asarray(gt), K - 1, 0)))
    E = len(ei)
    ident = np.array([1, 0, 0, 0, 0, 0, 0, 1], np.float32)
    arrays = dict(
        nodes=np.concatenate([np.stack(nodes), np.tile(ident, (pad_nodes, 1))]).astype(np.float32),
        node_fixed=np.arange(K + pad_nodes) == 0,
        node_valid=np.arange(K + pad_nodes) < K,
        edge_i=np.array(ei + [0] * pad_edges, np.int32),
        edge_j=np.array(ej + [0] * pad_edges, np.int32),
        edge_Sij=np.concatenate([np.stack(Sij), np.tile(ident, (pad_edges, 1))]).astype(np.float32),
        edge_weight=np.array([1.0] * (E - 1) + [5.0] + [0.0] * pad_edges, np.float32),
        edge_valid=np.arange(E + pad_edges) < E)
    return arrays, gt


def _both(arrays):
    return (j_pg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            convert.pose_graph_problem_from_numpy(arrays, device="cpu"))


def test_problem_conversion_and_relative_sim3():
    arrays, gt = _ring(pad_nodes=4, pad_edges=3)
    _, pt = _both(arrays)
    assert pt.nodes.dtype == torch.float32 and pt.edge_i.dtype == torch.int64
    assert pt.node_fixed.dtype == pt.edge_valid.dtype == torch.bool
    assert pt.nodes.shape == (K + 4, 8) and pt.edge_Sij.shape == (K + 3, 8)
    with pytest.raises(ValueError, match="edge_valid"):
        convert.pose_graph_problem_from_numpy({k: v for k, v in arrays.items()
                                               if k != "edge_valid"}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            convert.pose_graph_problem_from_numpy(arrays)
    with jax.enable_x64(False):
        rel_j = np.asarray(j_pg.relative_sim3(jnp.asarray(gt), K - 1, 0))
    np.testing.assert_allclose(t_pg.relative_sim3(torch.from_numpy(gt), K - 1, 0).numpy(), rel_j,
                               atol=1e-6)


def test_edge_linearization_matches_jax():
    arrays, _ = _ring()
    pj, pt = _both(arrays)
    zero7 = np.zeros(7, np.float32)

    @jax.jit
    def lin_j(Si, Sj, Sij):
        r = jax.vmap(j_pg._edge_residual, in_axes=(0, 0, 0, None, None))(Si, Sj, Sij, zero7, zero7)
        Ji = jax.vmap(lambda a, b, c: jax.jacfwd(
            lambda t: j_pg._edge_residual(a, b, c, t, zero7))(zero7))(Si, Sj, Sij)
        Jj = jax.vmap(lambda a, b, c: jax.jacfwd(
            lambda t: j_pg._edge_residual(a, b, c, zero7, t))(zero7))(Si, Sj, Sij)
        return r, Ji, Jj

    with jax.enable_x64(False):
        r_j, Ji_j, Jj_j = lin_j(pj.nodes[pj.edge_i], pj.nodes[pj.edge_j], pj.edge_Sij)
    r_t, Ji_t, Jj_t = t_pg.linearize_edges(pt, pt.nodes)
    assert r_t.shape == (K, 7) and Ji_t.shape == Jj_t.shape == (K, 7, 7)
    assert r_t.dtype == Ji_t.dtype == torch.float32
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=2e-5)
    np.testing.assert_allclose(Ji_t.numpy(), np.asarray(Ji_j), atol=2e-5)
    np.testing.assert_allclose(Jj_t.numpy(), np.asarray(Jj_j), atol=2e-5)
    cost = float(t_pg.pose_graph_cost(pt, pt.nodes))
    w = arrays["edge_weight"]
    np.testing.assert_allclose(cost, float(np.sum(w * np.sum(np.asarray(r_j) ** 2, -1))), rtol=1e-4)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_one_step_matches_jax(fix_scale):
    arrays, _ = _ring()
    pj, pt = _both(arrays)
    with jax.enable_x64(False):
        out_j = np.asarray(j_pg.optimize_pose_graph(pj, iterations=1, fix_scale=fix_scale))
    out_t = t_pg.optimize_pose_graph(pt, iterations=1, fix_scale=fix_scale).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    assert np.abs(out_t - arrays["nodes"]).max() > 1e-3       # the step was taken


def _err(a, b):
    return float(torch.linalg.norm(t_lie.sim3_log(t_lie.sim3_mul(
        torch.from_numpy(a), t_lie.sim3_inv(torch.from_numpy(b))))))


@pytest.mark.parametrize("fix_scale,pad", [(False, 0), (True, 0), (True, 5)])
def test_twenty_iterations_match_jax(fix_scale, pad):
    arrays, gt = _ring(pad_nodes=pad, pad_edges=pad)
    pj, pt = _both(arrays)
    with jax.enable_x64(False):
        out_j = np.asarray(j_pg.optimize_pose_graph(pj, iterations=20, fix_scale=fix_scale))
    out_t = t_pg.optimize_pose_graph(pt, iterations=20, fix_scale=fix_scale).numpy()
    assert out_t.dtype == np.float32 and np.isfinite(out_t).all()
    np.testing.assert_allclose(out_t, out_j, atol=1e-4)
    np.testing.assert_array_equal(out_t[0], arrays["nodes"][0])      # the fixed node
    np.testing.assert_array_equal(out_t[K:], arrays["nodes"][K:])    # padded nodes
    if fix_scale:
        np.testing.assert_array_equal(out_t[:, 7], arrays["nodes"][:, 7])
    before, after = _err(arrays["nodes"][K - 1], gt[K - 1]), _err(out_t[K - 1], gt[K - 1])
    assert after < 0.3 * before, (before, after)
    assert float(t_pg.pose_graph_cost(pt, torch.from_numpy(out_t))) < \
        0.1 * float(t_pg.pose_graph_cost(pt, pt.nodes))


def test_fixed_node_untouched_and_chain_collapses():
    rng = np.random.default_rng(0)
    n = 5
    ident = np.array([1, 0, 0, 0, 0, 0, 0, 1], np.float32)
    nodes = np.tile(ident, (n, 1))
    nodes[1:, 4] += rng.normal(0, 0.1, n - 1).astype(np.float32)
    arrays = dict(nodes=nodes, node_fixed=np.arange(n) == 0, node_valid=np.ones(n, bool),
                  edge_i=np.arange(1, n, dtype=np.int32), edge_j=np.arange(0, n - 1, dtype=np.int32),
                  edge_Sij=np.tile(ident, (n - 1, 1)), edge_weight=np.ones(n - 1, np.float32),
                  edge_valid=np.ones(n - 1, bool))
    pj, pt = _both(arrays)
    with jax.enable_x64(False):
        out_j = np.asarray(j_pg.optimize_pose_graph(pj, iterations=15))
    out_t = t_pg.optimize_pose_graph(pt, iterations=15).numpy()
    np.testing.assert_array_equal(out_t[0], nodes[0])
    np.testing.assert_allclose(out_t[:, 4], 0.0, atol=1e-3)
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
