"""Port vs JAX: the two probes of ``orb_slam3_rgbl_tpu_torch/tools``.

- ``tools/pg_probe``: with K = 16 the two ``build``s agree to 1e-6 of the
  values' magnitude (f32 quaternion conversions and Sim3 products: a few
  ulp at 22 m; 7.6e-6 seen on translations of ~40 m), and 10 iterations of
  ``optimize_pose_graph`` leave the port's nodes within 1e-4 of JAX's
  (tests/test_torch_pose_graph.py's bar for 20 iterations).
- ``tools/triage_ate``: one short port-only run on the CPU (``sync``, 16
  frames of its small box world) prints a last line that parses as JSON
  with exactly the JAX harness's keys, every frame OK and no binding issue.
  The System it drives is held against JAX's by the drive tests
  (tests/test_torch_system*.py); this test holds the harness.
"""

import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from test_torch_system import one_torch_thread  # noqa: E402,F401  (autouse)

CPU = torch.device("cpu")
BUILD_TOL = 1e-6
# the keys of tools/triage_ate.py's JSON line (the JAX harness)
TRIAGE_KEYS = ["mode", "ate_m", "p50", "p90", "max", "argmax", "ok_frac", "n_kf", "deferred",
               "loops", "issues"]


# ---- tools/pg_probe ------------------------------------------------------------------
def test_pg_probe_matches_jax():
    from orb_slam3_rgbl_tpu.optim import pose_graph as j_pg
    from tools import pg_probe as j_probe
    from orb_slam3_rgbl_tpu_torch.tools import pg_probe as t_probe

    with jax.enable_x64(False):
        gt_j, est_j, nodes_j, (ei, ej, Sij_j, w), fixed = j_probe.build(K=16)
        E = len(ei)
        prob = j_pg.PoseGraphProblem(
            nodes=jnp.asarray(nodes_j), node_fixed=jnp.asarray(fixed),
            node_valid=jnp.ones(16, bool), edge_i=jnp.asarray(np.asarray(ei, np.int32)),
            edge_j=jnp.asarray(np.asarray(ej, np.int32)), edge_Sij=jnp.asarray(np.stack(Sij_j)),
            edge_weight=jnp.asarray(np.asarray(w, np.float32)), edge_valid=jnp.ones(E, bool))
        out_j = np.asarray(j_pg.optimize_pose_graph(prob, iterations=10, fix_scale=True))
    gt_t, est_t, nodes_t, edges_t, fixed_t = t_probe.build(K=16)
    assert edges_t[:2] == (ei, ej) and np.array_equal(fixed_t, fixed) and edges_t[3] == w
    for a, b in ((gt_t, gt_j), (est_t, est_j), (nodes_t, nodes_j),
                 (np.stack(edges_t[2]), np.stack(Sij_j))):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() < BUILD_TOL * max(1.0, np.abs(b).max())
    out_t = t_probe.solve(nodes_t, edges_t, fixed_t, 10, CPU)
    assert np.abs(out_t - out_j).max() < 1e-4
    e0 = t_probe.err_vs_gt(est_t, gt_t)
    e1 = t_probe.err_vs_gt(t_probe.lie.np_sim3_to_se3(out_t), gt_t)
    assert e1.mean() < e0.mean()                          # the loop edge relaxes the graph


def test_triage_ate_sync_run_prints_the_jax_keys(capsys):
    from orb_slam3_rgbl_tpu_torch.tools import triage_ate
    from orb_slam3_rgbl_tpu_torch.utils import logging as t_log

    try:
        triage_ate.main(["sync", "16", "--device", "cpu"])   # raises the log level to NORMAL
    finally:
        t_log.set_level(t_log.QUIET)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(last)
    assert list(out) == TRIAGE_KEYS
    assert out["mode"] == "sync" and out["ok_frac"] == 1.0 and out["issues"] == []
    assert out["n_kf"] >= 2 and out["loops"] == 0 and out["deferred"] == 0
