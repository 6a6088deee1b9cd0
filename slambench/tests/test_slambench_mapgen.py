"""The map generator: one seed gives one map, another seed another, and the
sizes that set the solver's work do not depend on the seed."""

import numpy as np
import pytest

from slambench import mapgen
from small import small_cell

CELLS = ["kitti00_rgbl_map.gba_one_call", "euroc_mh_stereo_map.gba_one_call"]
KEYS = ["kf_pose", "kf_uv", "kf_ur", "kf_octave", "kf_lm_idx", "lm_pos", "true_pose", "true_lm"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_same_seed_same_map(cell_name):
    cell, config = small_cell(cell_name, n_keyframes=16)
    a = mapgen.generate(config, cell, 2 ** 31 + 11)
    b = mapgen.generate(config, cell, 2 ** 31 + 11)
    for k in KEYS:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("cell_name", CELLS)
def test_other_seed_other_map_same_sizes(cell_name):
    cell, config = small_cell(cell_name, n_keyframes=16)
    a = mapgen.generate(config, cell, 5)
    b = mapgen.generate(config, cell, 6)
    assert not np.array_equal(a["lm_pos"], b["lm_pos"])
    assert not np.array_equal(a["kf_pose"], b["kf_pose"])
    for k in KEYS:
        assert a[k].shape == b[k].shape, k
    assert len(a["lm_pos"]) == 16 * config["map"]["new_landmarks_per_kf"]
    if config["map"]["observers"] == "consecutive":
        assert np.array_equal(a["n_obs"], b["n_obs"])


@pytest.mark.parametrize("cell_name", CELLS)
def test_observations_lie_in_the_image_and_bind_once(cell_name):
    cell, config = small_cell(cell_name, n_keyframes=16)
    a = mapgen.generate(config, cell, 3)
    cam, N = config["camera"], config["orb"]["n_features"]
    bound = a["kf_lm_idx"] >= 0
    assert a["kf_lm_idx"].shape == (16, N)
    # a keyframe binds a landmark to one feature at most
    for k in range(16):
        ids = a["kf_lm_idx"][k][bound[k]]
        assert len(np.unique(ids)) == len(ids)
    # every landmark is seen at least once and has a right coordinate there
    seen = np.bincount(a["kf_lm_idx"][bound], minlength=len(a["lm_pos"]))
    assert seen.min() >= 1
    assert (a["kf_ur"][bound] >= 0).mean() == pytest.approx(config["map"]["stereo_share"], abs=0.05)
    # the true projections of inliers lie inside the image
    q = mapgen.quat_to_matrix(a["true_pose"][:, :4])
    k, f = np.nonzero(bound)
    X = a["true_lm"][a["kf_lm_idx"][k, f]]
    pc = np.einsum("nij,nj->ni", q[k], X) + a["true_pose"][k, 4:]
    assert (pc[:, 2] > 0).all()
    u = cam["fx"] * pc[:, 0] / pc[:, 2] + cam["cx"]
    assert ((u >= 0) & (u < cam["width"])).all()


def test_first_keyframe_is_the_world_and_fixed():
    cell, config = small_cell(CELLS[0], n_keyframes=8)
    a = mapgen.generate(config, cell, 9)
    np.testing.assert_allclose(a["true_pose"][0], [1, 0, 0, 0, 0, 0, 0], atol=1e-12)
    np.testing.assert_allclose(a["kf_pose"][0], a["true_pose"][0], atol=1e-6)
    assert np.abs(a["kf_pose"][1:, 4:] - a["true_pose"][1:, 4:]).max() > 1e-3
