"""Small cells for the CPU tests: a real cell's configuration and schedule
on a few keyframes and fewer landmarks a keyframe."""

import copy
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def small_cell(cell_name: str, n_keyframes: int = 10, landmarks_per_kf: int = 120):
    """(cell, config) of ``cell_name`` cut to a size a test holds."""
    from slambench import run
    cell, config = run.load_cell(ROOT, cell_name)
    cell, config = copy.deepcopy(cell), copy.deepcopy(config)
    cell["n_keyframes"] = n_keyframes
    config["map"]["new_landmarks_per_kf"] = landmarks_per_kf
    return cell, config


def small_root(tmp: Path, cell_name: str, **kw) -> str:
    """A checkout under ``tmp`` holding BENCHMARK.json, the benchmark's files
    and one more cell, ``<cell_name>.small``, with its own configuration;
    returns the new cell's name."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "slambench", tmp / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cell, config = small_cell(cell_name, **kw)
    name = f"{cell_name}.small"
    config["name"] = cell["config"] = f"{config['name']}_small"
    cell["name"] = name
    (tmp / "slambench" / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
    (tmp / "slambench" / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    return name
