"""Port vs JAX: the map probes and the scaling tool of
``orb_slam3_rgbl_tpu_torch/tools``.

A port ``System`` (KITTI RGB-L configuration, which both probes assume)
takes 30 frames of the circular feature drive
(``test_torch_loop_closing.loop_drive_features``); its map goes to disk
through ``utils/serialization.save_map`` (the JAX package's format) with
the ground truth beside it as ``<map>.gt.npz``.

* ``tools/gba_probe``: both packages' probes on that file. The summary
  (keyframes, landmarks, binding issues, observations) is equal, the
  keyframe ATE before the solve within 1e-5 m (observed 0: the same f32
  centres through each package's Horn alignment; JAX's is unrounded here,
  from ``kf_ate``), and after each pair of LM iterations the ATE and cost
  within 1e-3 (against the JAX tool's printed values, which carry 3 and 1
  decimals; the JAX problem is padded to its 256 / 8,192 tiers, the port's
  to the loop closer's). The ATE rises by less than 5 mm over the 3 × 2
  iterations (observed 0.015 → 0.016 → 0.015 m).
* ``tools/map_stage_probe``: runs on that file and prints its three idle
  stages, one row each with ``n_reps`` samples.
* ``tools/bench_scaling``: its sizing function at ranks 1 and 2 over gloo on
  the CPU at K = 32, M = 4,096, 2 × 10: every row has exactly the JAX
  tool's keys, the costs agree (the tool's 2%), and ``comm_per_lm_iter_bytes``
  is the JAX tool's formula.
"""

import io
import os
import re
import sys
from contextlib import redirect_stdout

import numpy as np
import jax
import pytest
import torch

from orb_slam3_rgbl_tpu_torch.config import kitti_rgbl_config
from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.slam.system import System
from orb_slam3_rgbl_tpu_torch.utils import serialization

from test_torch_loop_closing import feats_to_port, loop_drive_features

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_FRAMES = 30
ATE_BEFORE_TOL = 1e-5
AFTER_TOL = 1e-3
MAX_ATE_RISE_M = 5e-3
JAX_ROW_KEYS = ["n_dev", "steady_s", "first_s", "lm_per_shard", "final_cost", "speedup_vs_1dev",
                "cost_agrees", "physical_cores", "comm_per_lm_iter_bytes", "note"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def saved_map(tmp_path_factory):
    cfg, feats, gt_tcw = loop_drive_features(N_FRAMES)
    sysm = System(kitti_rgbl_config(), device="cpu")
    for i, f in enumerate(feats):
        sysm.track_features(feats_to_port(f), timestamp=i * 0.1)
    assert sysm.map.n_kf >= 5
    path = str(tmp_path_factory.mktemp("probe") / "map.npz")
    serialization.save_map(path, sysm.map)
    np.savez(path + ".gt.npz", traj=lie.np_se3_inv(np.asarray(gt_tcw, np.float32)))
    return path


def test_gba_probe_matches_jax(saved_map, capsys):
    from tools import gba_probe as j_probe
    from orb_slam3_rgbl_tpu.utils import serialization as j_ser
    from orb_slam3_rgbl_tpu_torch.tools import gba_probe as t_probe

    out = t_probe.main([saved_map, "--device", "cpu"])
    port_text = capsys.readouterr().out
    buf = io.StringIO()
    argv = sys.argv
    try:
        sys.argv = ["gba_probe.py", saved_map]
        with jax.enable_x64(False), redirect_stdout(buf):
            j_probe.main()
        jm = j_ser.load_map(saved_map)
        j_ate = j_probe.kf_ate(jm, jm.valid_kf_ids(), np.load(saved_map + ".gt.npz")["traj"])
    finally:
        sys.argv = argv
    text = buf.getvalue()
    lines = text.strip().splitlines()
    # the summary lines, as printed
    for prefix in ("map:", "binding issues:", "KF ATE before GBA:", "problem:"):
        (j_line,) = [ln for ln in lines if ln.startswith(prefix)]
        (t_line,) = [ln for ln in port_text.splitlines() if ln.startswith(prefix)]
        assert t_line == j_line, (t_line, j_line)
    assert out["binding_issues"] == [] and out["n_kf"] >= 5
    assert abs(out["ate_before"] - float(j_ate)) <= ATE_BEFORE_TOL
    after = [tuple(map(float, m)) for m in
             re.findall(r"after \d+ LM iters: KF ATE ([\d.]+) m, cost ([\d.]+)", text)]
    assert len(after) == len(out["rounds"]) == 3
    for r, (ate_j, cost_j) in zip(out["rounds"], after):
        assert abs(r["ate"] - ate_j) <= AFTER_TOL, (r, ate_j)
        assert abs(r["cost"] - cost_j) <= AFTER_TOL * cost_j, (r, cost_j)
    assert max(r["ate"] for r in out["rounds"]) - out["ate_before"] < MAX_ATE_RISE_M
    assert out["reproj_after"]["n"] == out["reproj_before"]["n"] > 0


def test_map_stage_probe_prints_its_stages(saved_map, capsys):
    from orb_slam3_rgbl_tpu_torch.tools import map_stage_probe

    timer = map_stage_probe.main([saved_map, "3", "--device", "cpu"])
    err = capsys.readouterr().err
    assert err.startswith("map: ")
    for stage in ("idle_tri", "idle_fuse", "idle_lba"):
        (row,) = [ln for ln in err.splitlines() if ln.split()[:1] == [stage]]
        assert int(row.split()[1]) == 3
        assert timer.stats()[stage]["n"] == 3


def test_bench_scaling_rows_at_a_small_size():
    from tools import bench_scaling as j_tool
    from orb_slam3_rgbl_tpu_torch.parallel import sharded_ba as t_sba
    from orb_slam3_rgbl_tpu_torch.tools import bench_scaling as t_tool

    rows = t_tool.scaling_rows((1, 2), 32, 4096, 4, 2, 10, "cpu", threads=1)
    assert [r["n_dev"] for r in rows] == [1, 2]
    for r in rows:
        # the JAX tool's keys, and beside its budget the bytes a rank all-reduced
        assert [k for k in r if k != "all_reduced_per_lm_iter_bytes"] == JAX_ROW_KEYS
        assert list(r)[-3:-1] == ["comm_per_lm_iter_bytes", "all_reduced_per_lm_iter_bytes"]
        assert r["cost_agrees"] and np.isfinite(r["final_cost"]) and r["steady_s"] > 0
        assert r["comm_per_lm_iter_bytes"] == 32 * 6 * 4 * (10 + 1) + 32 * 144 + 16
        # 2 LM iterations of comm_bytes, and the first cost's 4 bytes
        assert r["all_reduced_per_lm_iter_bytes"] == (2 * t_sba.comm_bytes(32, 10) + 4) / 2
        assert "gloo" in r["note"] and "not speedup" in r["note"]
    assert [r["lm_per_shard"] for r in rows] == [4096, 2048]
    # the tool's constants and budget are the JAX tool's
    assert (t_tool.K, t_tool.D, t_tool.M, t_tool.ITERS, t_tool.CG) == (
        j_tool.K, j_tool.D, j_tool.M, j_tool.ITERS, j_tool.CG)
    assert t_sba.comm_per_lm_iter_bytes(j_tool.K, j_tool.CG) == (
        j_tool.K * 6 * 4 * (j_tool.CG + 1) + j_tool.K * 144 + 16)
