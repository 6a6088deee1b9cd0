"""BENCHMARK.json and the files it names: the contract's names, units and
limits; a cell found from its files alone; every configuration's problem
module and plain reference; no JAX anywhere in what a run imports, and
nothing of the program in what a reference imports."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from slambench import run
from small import ROOT, small_root

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
HARNESS_FORBIDDEN = {"jax", "jaxlib", "flax", "orb_slam3_rgbl_tpu"}
REFERENCE_FORBIDDEN = HARNESS_FORBIDDEN | {"orb_slam3_rgbl_tpu_torch"}
PROBLEMS = sorted((ROOT / "slambench" / "problems").glob("*.py"))
CONFIGS = [json.loads((ROOT / c["file"]).read_text()) for c in BENCH["configs"]]
ROLES = ("SPAN_SOLVE", "SPAN_PREFIX", "REFERENCE", "make_map", "Solver", "reference", "NAMES", "gaps",
         "unchanged", "faults")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_run_seconds():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert all(_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")


def test_names_units_and_lines():
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind, e["name"]))
            for k in ("why", "layer", "source"):
                if k in e:
                    assert _line(e[k]), (e["name"], k)
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert len(set(names)) == len(names)


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_name_has_its_files():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        f = ROOT / c["file"]
        assert f.parent == ROOT / "slambench" / "configs" and f.stem == c["name"]
        assert json.loads(f.read_text())["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        cell, config = run.load_cell(ROOT, w["name"])
        assert cell["config"] == w["config"] == config["name"] and cell["why"] == w["why"]
        assert cell["chips"] == w["chips"]
        # every cell reports set-up, another end-to-end metric and a per-layer one
        assert len(run.metrics_for(BENCH, w["name"], "end_to_end")) >= 2
        assert run.metrics_for(BENCH, w["name"], "per_layer")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert callable(run.load_reader(ROOT, m["name"]))
    size = (ROOT / "BENCHMARK.json").stat().st_size
    assert size <= 64 * 1024


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: c["name"])
def test_every_configuration_names_its_problem_and_reference(config):
    """The problem's file exists and gives every role; its ``REFERENCE`` is
    a file of the benchmark that the problem imports, and the one that the
    configuration's ``"reference"`` key names; every cell of the
    configuration has a limit for each compared number and no other."""
    path = ROOT / "slambench" / "problems" / f"{config['problem']}.py"
    assert path.exists(), path
    problem = run.load_problem(ROOT, config)
    assert all(hasattr(problem, r) for r in ROLES), [r for r in ROLES if not hasattr(problem, r)]
    ref = Path(problem.REFERENCE).resolve()
    assert ref.exists() and ref.parent.is_relative_to(ROOT / "slambench")
    assert ref in _walk([path])[1], (ref, "is not imported by", path)
    assert ROOT / config["reference"] == ref
    for w in BENCH["workloads"]:
        if w["config"] == config["name"]:
            cell, _ = run.load_cell(ROOT, w["name"])
            assert run.limits_mismatch(problem, cell["limits"]) == ""


def test_a_dropped_workload_is_found(tmp_path):
    name = small_root(tmp_path, "euroc_mh_stereo_map.gba_one_call")
    cell, config = run.load_cell(tmp_path, name)
    assert cell["name"] == name and config["name"] == cell["config"]
    assert config["camera"] == run.load_cell(ROOT, "euroc_mh_stereo_map.gba_one_call")[1]["camera"]


# --- no JAX ------------------------------------------------------------------

def _module_files(name: str):
    """The repository's files that importing ``name`` runs (package
    __init__ files on the way, the module itself)."""
    parts, out = name.split("."), []
    for i in range(1, len(parts) + 1):
        base = ROOT.joinpath(*parts[:i])
        for f in (base / "__init__.py", base.with_suffix(".py")):
            if f.exists():
                out.append(f)
    return out


def _imports(path):
    """Top-level names and repository modules that ``path`` imports."""
    tops, mods = set(), set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        for n in names:
            tops.add(n.split(".")[0])
            mods.add(n)
    return tops, mods


def _walk(roots):
    seen, tops, todo = set(), set(), list(roots)
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        t, mods = _imports(f)
        tops |= t
        for m in mods:
            todo += [g for g in _module_files(m) if g not in seen]
    return tops, seen


def test_harness_imports_no_jax():
    roots = [ROOT / "slambench" / "run.py"] + sorted((ROOT / "slambench" / "metrics").glob("*.py"))
    roots += _module_files("slambench.program") + _module_files("slambench.devtrace")
    roots += [ROOT / "slambench" / "calibrate.py"] + PROBLEMS
    tops, files = _walk(roots)
    assert not tops & HARNESS_FORBIDDEN, tops & HARNESS_FORBIDDEN
    # the walk went into the port: the program is what it imports
    assert any("orb_slam3_rgbl_tpu_torch" in str(f) for f in files)
    # whole top-level names: the port's name begins with the JAX package's
    assert "orb_slam3_rgbl_tpu_torch" in tops and "orb_slam3_rgbl_tpu" not in tops


def test_reference_imports_nothing_of_the_program():
    refs = sorted({Path(run.load_problem(ROOT, c).REFERENCE).resolve() for c in CONFIGS})
    roots = refs + _module_files("slambench.compare") + _module_files("slambench.mapgen")
    tops, _ = _walk(roots)
    assert not tops & REFERENCE_FORBIDDEN, tops & REFERENCE_FORBIDDEN


@pytest.mark.parametrize("modules,forbidden", [
    ("slambench.run slambench.program slambench.devtrace slambench.calibrate "
     "slambench.problems.visual_gba", HARNESS_FORBIDDEN),
    ("slambench.reference slambench.compare slambench.mapgen", REFERENCE_FORBIDDEN),
])
def test_loaded_modules(modules, forbidden):
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            + "; ".join(f"import {m}" for m in modules.split())
            + "; print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, check=True).stdout.split()
    assert not set(out) & forbidden, set(out) & forbidden


def test_no_result_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    rc = run.main(["--workload", "euroc_mh_stereo_map.gba_one_call", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_split_metrics_read_with_their_base():
    """``<base>.<suffix>`` names: the end-to-end value is the base's, the
    reader is the base's where no file of its own exists."""
    split = [m for m in BENCH["per_layer"] if "." in m["name"]]
    assert split
    for m in split:
        base = m["name"].split(".")[0]
        assert not (ROOT / "slambench" / "metrics" / f"{m['name']}.py").exists()
        assert (run.load_reader(ROOT, m["name"]).__code__.co_filename
                == run.load_reader(ROOT, base).__code__.co_filename)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        # a per-layer metric's cells all report the end-to-end metric it moves
        mv = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(mv.get("workloads", m["workloads"]))
    assert {"gba_solve_s", "setup_s"} <= e2e
