"""At a small map on the CPU: the port's solve and the plain reference both
bring the poses towards the ground truth and agree with each other; the
control (the reference in TF32) fails the cell's limits; the reference's
observation table keeps what the port's keeps."""

import numpy as np
import pytest
import torch

from slambench import compare, mapgen, program, reference, run
from slambench.problems.visual_gba import as_pose7
from small import ROOT, small_cell

CELLS = ["kitti00_rgbl_map.gba_one_call", "euroc_mh_stereo_map.gba_one_call"]
# landmarks a keyframe at which 10 keyframes constrain the poses
PER_KF = {"kitti00_rgbl_map.gba_one_call": 480, "euroc_mh_stereo_map.gba_one_call": 120}


def _truth(a, cam):
    return compare.against((mapgen.quat_to_matrix(a["true_pose"][:, :4]), a["true_pose"][:, 4:],
                            a["true_lm"], 1.0), a, cam)


def _centre_err(poses, a):
    R = mapgen.quat_to_matrix(poses[:, :4])
    c = -np.einsum("kji,kj->ki", R, poses[:, 4:].astype(np.float64))
    Rt = mapgen.quat_to_matrix(a["true_pose"][:, :4])
    ct = -np.einsum("kji,kj->ki", Rt, a["true_pose"][:, 4:])
    return np.sqrt(np.mean(np.sum((c - ct) ** 2, axis=1)))


@pytest.fixture(scope="module", params=CELLS)
def solved(request):
    torch.set_num_threads(2)
    cell, config = small_cell(request.param, 10, PER_KF[request.param])
    a = mapgen.generate(config, cell, 4242)
    inv = mapgen.inv_sigma2(config["orb"])
    s = program.Solver(config, cell, a, inv, torch.device("cpu"))
    s.warm()
    out = s.solve([])
    args = (a, inv, config["camera"], config["max_obs"], cell["schedule"])
    ref = compare.against(reference.run(*args, reference.Arith(torch.float64), "cpu"), a,
                          config["camera"])
    return cell, config, a, out, ref, args


def test_both_bring_poses_to_ground_truth(solved):
    """The cell's schedule brings both sides' rotations to the ground truth
    and lowers the cost; the camera centres come closer under the loop
    closer's 2-iteration calls. (On the drive's maps the one-call schedule
    lowers the cost a little further but moves the centres along a weakly
    held direction, away from the truth.)"""
    cell, config, a, out, ref, args = solved
    truth = _truth(a, config["camera"])
    g0 = compare.gaps(a["kf_pose"], a["lm_pos"], 1.0, truth)
    for poses in (out[0], as_pose7(ref.R, ref.t)):
        g = compare.gaps(poses, a["true_lm"], 1.0, truth)
        assert g["pose_gap_deg"] < 0.8 * g0["pose_gap_deg"]
    stats = {}
    reference.run(*args, reference.Arith(torch.float64), "cpu", stats)
    assert out[2] < 0.5 * stats["start_cost"] and ref.cost < 0.5 * stats["start_cost"]
    before = _centre_err(a["kf_pose"], a)
    calls_of_two = dict(cell, schedule=dict(cell["schedule"], chunk=2, huber_iterations=5))
    s = program.Solver(config, calls_of_two, a, mapgen.inv_sigma2(config["orb"]),
                       torch.device("cpu"))
    s.warm()
    R, t, _, _ = reference.run(*args[:4], calls_of_two["schedule"],
                               reference.Arith(torch.float64), "cpu")
    assert _centre_err(s.solve([])[0], a) < 0.9 * before
    assert _centre_err(as_pose7(R, t), a) < 0.9 * before


def test_program_agrees_with_reference(solved):
    cell, config, a, out, ref, _ = solved
    assert run.passes(compare.gaps(*out, ref), cell["limits"], compare.NAMES)


def test_control_fails_the_limits(solved):
    cell, config, a, out, ref, args = solved
    R, t, X, c = reference.run(*args, reference.Arith(torch.float32, tf32=True), "cpu")
    g = compare.gaps(as_pose7(R, t), X, c, ref)
    assert not run.passes(g, cell["limits"], compare.NAMES)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -10), 3.0e-5])
    y = reference.round_tf32(x)
    assert y.tolist()[:4] == [1.0, 1.0, 1.0 + 2 ** -9, -(1.0 + 2 ** -10)]
    assert abs(y[4] - x[4]) <= x[4] * 2 ** -11


@pytest.mark.parametrize("cell_name", CELLS)
def test_reference_keeps_the_observations_the_port_keeps(cell_name):
    from orb_slam3_rgbl_tpu_torch.slam import ba_assembly
    cell, config = small_cell(cell_name, n_keyframes=24, landmarks_per_kf=60)
    a = mapgen.generate(config, cell, 77)
    m = program.make_map(config, a)
    P, window, lm_ids, obs_kf, obs_feat = ba_assembly.build_full_problem(
        m, mapgen.inv_sigma2(config["orb"]), max_obs=config["max_obs"], min_pose_tier=1,
        min_lm_tier=1, device="cpu")
    mask = P.obs_mask.numpy()[: len(lm_ids)]
    port = {(int(l), int(k), int(f)) for l, k, f in zip(
        *np.nonzero(mask)[:1], obs_kf[mask], obs_feat[mask])}
    kf, lm, feat = reference.observations(a, config["max_obs"])
    assert port == set(zip(lm.tolist(), kf.tolist(), feat.tolist()))


@pytest.mark.gpu
def test_control_fails_at_the_cell_size(card):
    """The control on the card at the cell's own size (the readings of the
    limits come from ``slambench/calibrate.py``)."""
    for cell_name in CELLS:
        cell, config = run.load_cell(ROOT, cell_name)
        a = mapgen.generate(config, cell, 31)
        inv = mapgen.inv_sigma2(config["orb"])
        args = (a, inv, config["camera"], config["max_obs"], cell["schedule"])
        ref = compare.against(reference.run(*args, reference.Arith(torch.float64), card), a,
                              config["camera"])
        R, t, X, c = reference.run(*args, reference.Arith(torch.float32, tf32=True), card)
        g = compare.gaps(as_pose7(R, t), X, c, ref)
        assert not run.passes(g, cell["limits"], compare.NAMES), (cell_name, g)
