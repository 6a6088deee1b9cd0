"""A cell's problem module, found by the configuration's ``"problem"`` key:
a problem added as new files only (its module, configuration, workload and
``BENCHMARK.json`` entries) runs to a result of its own, a broken one reads
not correct, a cell whose limits are not its problem's compared numbers is
refused, and the visual bundle adjustment's adapter gives the line that its
modules give when called directly."""

import hashlib
import json
import shutil
import textwrap

import pytest
import torch

from slambench import compare, mapgen, program, reference, run
from small import ROOT, small_root

SEED = 2147483659

TOY = '''
"""Least squares A x = b: the program side solves in float32 with torch,
the reference in float64 with numpy."""

import time

import numpy as np
import torch

SPAN_SOLVE = "toy.solve"
SPAN_PREFIX = "toy."
REFERENCE = __file__
NAMES = ("x_gap", "residual_gap")


def make_map(config, cell, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(cell["rows"], config["cols"]))
    x = rng.normal(size=config["cols"])
    return {"A": A, "b": A @ x + 1e-3 * rng.normal(size=cell["rows"]),
            "x0": np.zeros(config["cols"])}


class Solver:
    def __init__(self, config, cell, maparr, device):
        self.A = torch.as_tensor(maparr["A"], dtype=torch.float32, device=device)
        self.b = torch.as_tensor(maparr["b"], dtype=torch.float32, device=device)
        self.x0 = maparr["x0"]
        self.unchanged = config.get("fault") == "unchanged"
        self.shapes = None

    def warm(self):
        self.solve([])
        self.shapes = {"rows": int(self.A.shape[0]), "cols": int(self.A.shape[1])}

    def solve(self, spans):
        t0 = time.perf_counter()
        if self.unchanged:
            x = self.x0.copy()
        else:
            x = torch.linalg.solve(self.A.T @ self.A, self.A.T @ self.b).cpu().numpy()
        spans.append((SPAN_SOLVE, t0, time.perf_counter()))
        return x


def reference(config, cell, maparr, device, stats=None, control=False):
    A, b = maparr["A"], maparr["b"]
    if control:
        A, b = A.astype(np.float16).astype(np.float64), b.astype(np.float16).astype(np.float64)
    x = np.linalg.lstsq(A, b, rcond=None)[0]
    if stats is not None:
        stats["residual"] = float(np.linalg.norm(maparr["A"] @ x - maparr["b"]))
    return x


def gaps(out, ref):
    return {"x_gap": float(np.max(np.abs(out - ref))),
            "residual_gap": float(abs(np.linalg.norm(out) - np.linalg.norm(ref)))}


def unchanged(maparr, stats, ref):
    return gaps(maparr["x0"], ref)


def faults(solver, out, ref):
    return {"fault_answer_altered": gaps(out + 1.0, ref)}
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def toy_root(tmp, config_extra=None, limits=None):
    """A checkout under ``tmp``: the repository's ``BENCHMARK.json`` and
    benchmark files, then the toy problem added as new files and entries.
    Returns the cell's name and the digests of the copied files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "slambench", tmp / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    copied = _digests(tmp / "slambench")
    name = "toy_lsq.solve"
    config = {"name": "toy_lsq", "problem": "toy_lsq",
              "reference": "slambench/problems/toy_lsq.py", "cols": 6, "reduced": [],
              **(config_extra or {})}
    cell = {"name": name, "config": "toy_lsq", "chips": 1, "rows": 48,
            "why": "least squares of 48 rows and 6 unknowns",
            "limits": limits or {"x_gap": 1e-4, "residual_gap": 1e-4}}
    sb = tmp / "slambench"
    (sb / "problems" / "toy_lsq.py").write_text(textwrap.dedent(TOY))
    (sb / "configs" / "toy_lsq.json").write_text(json.dumps(config))
    (sb / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy_lsq", "source": "none", "reduced": [], "why": "a toy",
                             "file": "slambench/configs/toy_lsq.json"})
    bench["workloads"].append({k: cell[k] for k in ("name", "config", "chips", "why")}
                              | {"traffic": "solve"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return name, copied


def _main(root, name, capsys, seconds="0.1"):
    torch.set_num_threads(2)
    rc = run.main(["--workload", name, "--seed", str(SEED), "--seconds", seconds],
                  root=root, device="cpu")
    out, err = capsys.readouterr()
    return rc, out, err


def test_a_problem_added_as_new_files_runs(tmp_path, capsys):
    name, copied = toy_root(tmp_path)
    rc, out, err = _main(tmp_path, name, capsys)
    assert rc == 0, err
    r = json.loads(out.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r["compared"]) == ["x_gap", "residual_gap", "unchanged_x_gap",
                                   "unchanged_residual_gap"]
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert set(r["metrics"]) == {"setup_s"}
    assert err.strip().splitlines()[-1].startswith("compared unchanged_residual_gap")
    after = _digests(tmp_path / "slambench")
    assert {k: after[k] for k in copied} == copied


def test_a_problem_whose_solve_returns_the_map_is_not_correct(tmp_path, capsys):
    name, _ = toy_root(tmp_path, config_extra={"fault": "unchanged"})
    rc, out, _ = _main(tmp_path, name, capsys)
    assert rc == 0
    r = json.loads(out.strip().splitlines()[-1])
    assert not r["correct"] and r["failed"] == r["attempted"] >= 1


@pytest.mark.parametrize("limits,named", [
    ({"x_gap": 1e-4}, "residual_gap"),
    ({"x_gap": 1e-4, "residual_gap": 1e-4, "y_gap": 1.0}, "y_gap"),
])
def test_limits_that_are_not_the_compared_numbers_are_refused(tmp_path, capsys, limits, named):
    name, _ = toy_root(tmp_path, limits=limits)
    rc, out, err = _main(tmp_path, name, capsys)
    assert rc != 0 and out == ""
    assert named in err and "limits" in err


@pytest.mark.parametrize("cell_name", ["kitti00_rgbl_map.gba_one_call",
                                       "euroc_mh_stereo_map.gba_one_call"])
def test_visual_gba_adapter_gives_the_direct_line(tmp_path, capsys, cell_name):
    name = small_root(tmp_path, cell_name, n_keyframes=8, landmarks_per_kf=60)
    rc, out, _ = _main(tmp_path, name, capsys)
    assert rc == 0
    r = json.loads(out.strip().splitlines()[-1])

    # the same run by calling the modules themselves
    cell, config = run.load_cell(tmp_path, name)
    maparr = mapgen.generate(config, cell, SEED)
    inv = mapgen.inv_sigma2(config["orb"])
    solver = program.Solver(config, cell, maparr, inv, torch.device("cpu"))
    solver.warm()
    outs = [solver.solve([]) for _ in range(r["attempted"])]
    stats = {}
    ref = compare.against(reference.run(maparr, inv, config["camera"], config["max_obs"],
                                        cell["schedule"], reference.Arith(torch.float64), "cpu",
                                        stats), maparr, config["camera"])
    all_gaps = [compare.gaps(*o, ref) for o in outs]
    worst = run.worst(all_gaps, compare.NAMES)
    still = compare.unchanged(maparr, stats["start_cost"], ref)
    limits = cell["limits"]
    expected = {**{k: {"value": worst[k], "limit": limits[k]} for k in compare.NAMES},
                **{f"unchanged_{k}": {"value": still[k], "limit": limits[k]}
                   for k in compare.NAMES}}
    assert r["compared"] == expected
    failed = sum(not run.passes(g, limits, compare.NAMES) for g in all_gaps)
    assert (r["failed"], r["correct"]) == (failed, failed == 0
                                          and not run.passes(still, limits, compare.NAMES))


@pytest.mark.parametrize("which", ["toy_lsq", "euroc_mh_stereo_map.gba_one_call"])
def test_calibrate_reads_through_the_problem(tmp_path, monkeypatch, which):
    """``calibrate.py``'s readings, control and faults for a problem added
    as new files and for the visual adapter at a small size: the program
    within the cell's limits, the control and each fault outside them."""
    from slambench import calibrate
    if which == "toy_lsq":
        name, _ = toy_root(tmp_path)
    else:
        name = small_root(tmp_path, which, n_keyframes=8, landmarks_per_kf=60)
    monkeypatch.setattr(calibrate, "ROOT", tmp_path)
    torch.set_num_threads(2)
    r = calibrate.readings(name, SEED, True, True, torch.device("cpu"))
    cell, config = run.load_cell(tmp_path, name)
    names = run.load_problem(tmp_path, config).NAMES
    assert r["bit_equal_solves"] and r["shapes"]
    assert run.passes(r["program"], cell["limits"], names)
    assert not run.passes(r["unchanged"], cell["limits"], names)
    faults = [k for k in r if k.startswith("fault_")]
    assert faults
    for k in ["control"] + faults:
        assert set(r[k]) == set(names) and not run.passes(r[k], cell["limits"], names), k
    s = calibrate.survey(name, SEED, torch.device("cpu"))
    assert s["told_apart"] and s["unchanged"] == r["unchanged"]
