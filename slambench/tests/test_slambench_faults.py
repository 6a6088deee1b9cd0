"""A whole run on the CPU at a small size, with the look for a card skipped:
sound, it comes out correct; with the timed path broken underneath, it comes
out not correct, for each fault a solve can have (a solve that returns its
state unchanged; half of the observations left out; an answer altered where
it is produced). One card: no exchange between cards to leave out."""

import json

import numpy as np
import pytest
import torch

from orb_slam3_rgbl_tpu_torch.optim import global_ba
from slambench import reference, run
from slambench.problems.visual_gba import half_observations
from small import small_root

CELLS = ["kitti00_rgbl_map.gba_one_call", "euroc_mh_stereo_map.gba_one_call"]


def unchanged(solve):
    def broken(problem, cam, segments, *a, **k):
        return global_ba.GBAResult(problem.poses, problem.landmarks, problem.obs_mask,
                                   global_ba.ba_cost(problem, cam))
    return broken


def pose_altered(solve):
    def broken(*a, **k):
        res = solve(*a, **k)
        poses = res.poses.clone()
        poses[1, 4] += 0.1              # one keyframe 10 cm off
        return res._replace(poses=poses)
    return broken


def landmark_altered(solve):
    def broken(*a, **k):
        res = solve(*a, **k)
        lms = res.landmarks.clone()
        lms[0, 2] += 50.0               # one landmark 50 m off
        return res._replace(landmarks=lms)
    return broken


def _run(tmp_path, cell_name, capsys):
    torch.set_num_threads(2)
    name = small_root(tmp_path, cell_name, n_keyframes=8, landmarks_per_kf=60)
    rc = run.main(["--workload", name, "--seed", "2147483659", "--seconds", "0.1"],
                  root=tmp_path, device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0
    result = json.loads(out.strip().splitlines()[-1])
    # the numbers compared come last, on standard error and in the line
    assert list(result)[-1] == "compared"
    assert err.strip().splitlines()[-5].startswith("compared cost_gap")
    assert err.strip().splitlines()[-1].startswith("compared unchanged_cost_gap")
    return result


@pytest.mark.parametrize("cell_name", CELLS)
def test_sound_run_is_correct(tmp_path, cell_name, capsys):
    r = _run(tmp_path, cell_name, capsys)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"setup_s"}
    assert all(np.isfinite(v["value"]) for v in r["compared"].values())


@pytest.mark.parametrize("fault", [unchanged, half_observations, pose_altered, landmark_altered])
@pytest.mark.parametrize("cell_name", CELLS)
def test_broken_run_is_not_correct(tmp_path, cell_name, fault, capsys, monkeypatch):
    monkeypatch.setattr(global_ba, "global_bundle_adjust", fault(global_ba.global_bundle_adjust))
    r = _run(tmp_path, cell_name, capsys)
    assert not r["correct"] and r["failed"] == r["attempted"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_unchanged_run_on_a_map_the_reference_keeps_is_not_correct(tmp_path, cell_name, capsys,
                                                                   monkeypatch):
    solve = reference.solve

    def keeps_no_step(P, cam, schedule, arith, stats=None):
        return solve(P, cam, dict(schedule, lm_iterations=0), arith, stats)

    monkeypatch.setattr(reference, "solve", keeps_no_step)
    monkeypatch.setattr(global_ba, "global_bundle_adjust", unchanged(global_ba.global_bundle_adjust))
    r = _run(tmp_path, cell_name, capsys)
    # every solve agrees with the reference; the unchanged map passing the
    # limits is what makes the run not correct
    assert r["failed"] == 0 and not r["correct"]
    assert all(v["value"] <= v["limit"] for v in r["compared"].values())
