"""The stereo-inertial configuration and its cell
(``euroc_mh_stereo_inertial_map.viba_one_call``, problem ``vi_gba``):

* the contract sees the configuration, the cell, its readers and its
  problem's ``REFERENCE`` (``slambench/vi_reference.py``), which loads
  neither JAX nor anything of the program;
* ``vi_mapgen`` gives one map a seed, bit for bit, with keyframes where
  ``mapgen`` puts them, a gravity-down world and preintegrations that the
  truth satisfies to the IMU's noise;
* a whole run on the CPU at a small size comes out correct; the control,
  each planted fault and the map as handed over fail the cell's limits;
* a landmark behind its first observer in both answers reads its 3D gap
  seen from that camera; behind in one answer only, infinite;
* on a card (``gpu``): a small run with ``--trace 1`` reports the cell's
  per-layer metrics, its roofline shares at or below 100%."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from slambench import mapgen, run, vi_mapgen
from small import ROOT, small_cell, small_root

CELL = "euroc_mh_stereo_inertial_map.viba_one_call"
SEED = 2147483659
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# the EuRoC cell's readers that work unchanged here, then the cell's own
PER_LAYER = ["assemble_ms.launch_paced", "device_idle_pct.launch_paced",
             "lm_outer_ms.launch_paced", "gather_ms.launch_paced", "solve_wall_s.launch_paced",
             "imu_linearize_ms", "cg_step_ms.inertial", "kernels_per_cg_step.inertial",
             "vi_solve_roofline", "pair_hv_roofline"]


def test_the_contract_sees_the_configuration_and_its_cell():
    config = next(c for c in BENCH["configs"] if c["name"] == "euroc_mh_stereo_inertial_map")
    assert config["reduced"] == []
    cell, conf = run.load_cell(ROOT, CELL)
    assert conf["problem"] == "vi_gba" and cell["chips"] == 1
    problem = run.load_problem(ROOT, conf)
    assert problem.REFERENCE == str(ROOT / "slambench" / "vi_reference.py")
    assert run.limits_mismatch(problem, cell["limits"]) == ""
    assert [m["name"] for m in run.metrics_for(BENCH, CELL, "end_to_end")] == [
        "gba_card_busy_s", "setup_s"]
    assert [m["name"] for m in run.metrics_for(BENCH, CELL, "per_layer")] == PER_LAYER
    for name in PER_LAYER:
        assert callable(run.load_reader(ROOT, name))


def test_the_reference_loads_no_jax_and_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import slambench.vi_reference, slambench.vi_mapgen; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         check=True).stdout.split()
    assert not set(out) & {"jax", "jaxlib", "flax", "orb_slam3_rgbl_tpu",
                           "orb_slam3_rgbl_tpu_torch"}


def test_the_map_is_one_map_a_seed():
    cell, config = small_cell(CELL, n_keyframes=10, landmarks_per_kf=40)
    a = vi_mapgen.generate(config, cell, SEED)
    b = vi_mapgen.generate(config, cell, SEED)
    c = vi_mapgen.generate(config, cell, SEED + 1)
    assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["preint"], c["preint"])
    assert a["preint"].shape == (9, vi_mapgen.PREINT_WIDTH) and a["kf_vel"].shape == (10, 3)


def test_keyframes_lie_on_the_continuous_trajectory_and_the_imu_agrees():
    """The motion at the keyframes' times is mapgen's truth rotated
    gravity-down; the truth satisfies each pair's preintegration to the
    IMU's noise (rotation 1e-3 rad, velocity 1e-2 m/s, position 3e-3 m)."""
    cell, config = small_cell(CELL, n_keyframes=12, landmarks_per_kf=30)
    a = vi_mapgen.generate(config, cell, 7)
    plain = mapgen.generate(config, cell, 7)
    motion = vi_mapgen.Motion(config, 7)
    R_wc, c = motion.camera(a["kf_time"])
    R_cw = np.swapaxes(R_wc, -1, -2)
    assert np.abs(mapgen.quat_to_matrix(a["true_pose"][:, :4]) - R_cw).max() < 1e-9
    assert np.abs(a["true_pose"][:, 4:] + np.einsum("kij,kj->ki", R_cw, c)).max() < 1e-9
    # the same map up to the rotation of its world
    Rg = motion.Rg
    np.testing.assert_allclose(a["true_lm"], plain["true_lm"] @ Rg.T, atol=1e-9)
    np.testing.assert_allclose(Rg @ motion.R0.T @ [0.0, 1.0, 0.0], [0.0, 0.0, -1.0], atol=1e-12)
    pre = vi_mapgen.unflatten(a["preint"])
    Rb, pb = motion.body(a["kf_time"])
    v, g = a["true_vel"], motion.g
    for k in range(len(pre["dt"])):
        dt = pre["dt"][k]
        dbg, dba = a["true_bg"][k] - pre["bg"][k], a["true_ba"][k] - pre["ba"][k]
        dR = mapgen.quat_to_matrix(pre["dR"][k:k + 1])[0] @ vi_mapgen.exp_so3(pre["JRg"][k] @ dbg)
        er = vi_mapgen.log_so3(dR.T @ Rb[k].T @ Rb[k + 1])
        ev = Rb[k].T @ (v[k + 1] - v[k] - g * dt) - (pre["dV"][k] + pre["JVg"][k] @ dbg
                                                     + pre["JVa"][k] @ dba)
        ep = Rb[k].T @ (pb[k + 1] - pb[k] - v[k] * dt - 0.5 * g * dt * dt) - (
            pre["dP"][k] + pre["JPg"][k] @ dbg + pre["JPa"][k] @ dba)
        assert np.abs(er).max() < 1e-3 and np.abs(ev).max() < 1e-2 and np.abs(ep).max() < 3e-3


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    from slambench import calibrate
    tmp = tmp_path_factory.mktemp("vi")
    name = small_root(tmp, CELL, n_keyframes=12, landmarks_per_kf=25)
    old = calibrate.ROOT
    calibrate.ROOT = tmp
    torch.set_num_threads(2)
    try:
        r = calibrate.readings(name, SEED, True, True, torch.device("cpu"))
    finally:
        calibrate.ROOT = old
    return r, run.load_cell(tmp, name)[0]


def test_the_program_passes_and_control_faults_and_map_fail(readings):
    r, cell = readings
    names = list(cell["limits"])
    assert r["bit_equal_solves"] and r["shapes"]["n_pairs"] == 11
    assert run.passes(r["program"], cell["limits"], names), r["program"]
    for k in ("control", "unchanged", "fault_answer_altered", "fault_no_pairs"):
        assert not run.passes(r[k], cell["limits"], names), k
    # with no pair the velocities stay as handed over
    assert r["fault_no_pairs"]["vel_gap_mps"] == r["unchanged"]["vel_gap_mps"]
    assert r["fault_no_pairs"]["vel_gap_mps"] > cell["limits"]["vel_gap_mps"]


def test_a_landmark_behind_its_first_observer_in_both_answers_reads_its_3d_gap():
    """Two cameras at the origin looking down +z; landmark 1 lies behind
    them in the reference's answer."""
    from slambench import compare
    from slambench.problems import vi_gba
    cam = {"fx": 400.0, "fy": 400.0, "cx": 300.0, "cy": 200.0, "bf": 40.0}
    X_ref = np.array([[0.5, 0.2, 8.0], [1.0, -0.5, -4.0]])
    ref = compare.Reference(np.tile(np.eye(3), (2, 1, 1)), np.zeros((2, 3)), X_ref, 1.0,
                            np.array([0, 1]), cam)
    moved = X_ref + [[0.0, 0.0, 0.0], [0.003, 0.0, 0.004]]
    assert vi_gba._landmark_gap_px(moved, ref) == pytest.approx(400.0 * 0.005 / 4.0)
    assert vi_gba._landmark_gap_px(X_ref, ref) == 0.0
    in_front = X_ref * [[1, 1, 1], [1, 1, -1]]
    assert vi_gba._landmark_gap_px(in_front, ref) == np.inf
    near = X_ref * [[1, 1, 1], [1, 1, 1e-4]]
    assert vi_gba._landmark_gap_px(near, ref) == np.inf


def test_a_small_run_is_correct(tmp_path, capsys, monkeypatch):
    """A whole run with the card's busy time from a stand-in profiler."""
    from test_slambench_card import _Profile
    name = small_root(tmp_path, CELL, n_keyframes=8, landmarks_per_kf=25)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"]:
        if m["name"] == run.CARD_BUSY:
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    torch.set_num_threads(2)
    rc = run.main(["--workload", name, "--seed", str(SEED), "--seconds", "0.1"], root=tmp_path,
                  device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err
    r = json.loads(out.strip().splitlines()[-1])
    assert r["correct"] and set(r["metrics"]) == {run.CARD_BUSY, "setup_s"}
    assert list(r["compared"])[:7] == list(json.loads(
        (ROOT / "slambench" / "workloads" / f"{CELL}.json").read_text())["limits"])


@pytest.mark.gpu
def test_a_traced_run_on_the_card_reports_the_cells_metrics(tmp_path, capsys, card):
    name = small_root(tmp_path, CELL, n_keyframes=40, landmarks_per_kf=80)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    rc = run.main(["--workload", name, "--seed", str(SEED), "--seconds", "1", "--trace", "1"],
                  root=tmp_path, device=str(card))
    out, err = capsys.readouterr()
    assert rc == 0, err
    r = json.loads(out.strip().splitlines()[-1])
    assert r["correct"] and set(PER_LAYER) <= set(r["metrics"])
    assert all(r["metrics"][k]["value"] > 0 for k in PER_LAYER)
    assert r["metrics"]["vi_solve_roofline"]["value"] <= 100.0
    assert r["metrics"]["pair_hv_roofline"]["value"] <= 100.0
