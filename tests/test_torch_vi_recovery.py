"""Port vs JAX on an initialized IMU_RGBD map (``tests/test_vi_slam.py``'s
drive, 18 frames: the IMU initializes on frame 15): the IMU-chain relink of
keyframe culling, the forward timestamp jump (a new map after VIBA2, a reset
before it) and the bad-IMU reset of a motion-starved map.

Tolerances: the relinked preintegration within 2e-5 of the largest
magnitude of each of its fields (relative) and the same chain pointers; the
jump's and the reset's atlas outcome equal on both packages; both
packages flag the same motion-starved map and reset it. JAX runs with x64 off."""

import dataclasses

import jax
import numpy as np
import pytest

from orb_slam3_rgbl_tpu.config import IMU_RGBD
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.slam import local_mapping as t_lm

from test_torch_imu import FIELDS
from test_torch_mono import _to_port
from test_torch_system import one_torch_thread  # noqa: F401  (module fixture)
from test_torch_vi_system import drive_both, vi_frames

N_INIT = 18


@pytest.fixture(scope="module")
def initialized():
    cfg, feats, blocks, gt, _ = vi_frames(IMU_RGBD, N_INIT)
    js, ts, log = drive_both(cfg, feats, blocks)
    assert js.map.imu_initialized and ts.map.imu_initialized
    return cfg, feats, gt, js, ts


def test_relink_imu_chain_matches_jax(initialized):
    """``_relink_imu_chain`` of a middle keyframe on copies of one JAX map:
    its successor absorbs its preintegration; the chain's tail refuses."""
    cfg, _, _, js, _ = initialized
    tm = convert.map_state_from_numpy(js.map)
    mapper = t_lm.LocalMapper(convert.config_from_dict(dataclasses.asdict(cfg)), tm,
                              device="cpu")
    kfs = [int(k) for k in js.map.valid_kf_ids()]
    k, n = kfs[2], kfs[3]
    assert mapper._relink_imu_chain(kfs[-1]) is False       # the tail: tracking uses it
    with jax.enable_x64(False):
        assert js.mapper._relink_imu_chain(kfs[-1]) is False
        assert js.mapper._relink_imu_chain(k) is True
    assert mapper._relink_imu_chain(k) is True
    assert k not in tm.imu_preint and int(tm.kf_prev_imu[k]) == -1
    assert int(tm.kf_prev_imu[n]) == int(js.map.kf_prev_imu[n]) == kfs[1]
    for name, a, b in zip(FIELDS, js.map.imu_preint[n], tm.imu_preint[n]):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.abs(a - b).max() <= 2e-5 * max(np.abs(a).max(), 1e-30), name


def test_bad_imu_reset_matches_jax(initialized):
    """A motion-starved map: the last three keyframes within 2 cm before
    10 s of excited time flag ``bad_imu`` in both packages'
    ``_check_vi_excitation`` (the same map, copied); the flag resets the
    active map at the next frame on both Systems."""
    cfg, feats, _, js, ts = initialized
    tm = convert.map_state_from_numpy(js.map)
    kfs = tm.valid_kf_ids()
    for m in (tm, js.map):
        m.kf_pose[kfs[-2]] = m.kf_pose[kfs[-1]]
        m.kf_pose[kfs[-3]] = m.kf_pose[kfs[-1]]
    mapper = t_lm.LocalMapper(convert.config_from_dict(dataclasses.asdict(cfg)), tm,
                              device="cpu")
    mapper._check_vi_excitation(int(kfs[-1]))
    with jax.enable_x64(False):
        js.mapper._check_vi_excitation(int(kfs[-1]))
    assert mapper.bad_imu and js.mapper.bad_imu
    ts.mapper.bad_imu = True
    t = ts.tracker.traj_time[-1] + 0.1
    old_j, old_t = js.map, ts.map
    with jax.enable_x64(False):
        js.track_features(feats[-1], t)
    ts.track_features(_to_port(feats[-1]), t)
    assert js.map is not old_j and ts.map is not old_t
    assert ts.atlas.n_maps() == js.atlas.n_maps() == 1
    assert ts.map.n_kf == 0 and not ts.map.imu_initialized and not ts.mapper.bad_imu


def test_forward_timestamp_jump_matches_jax(initialized):
    """A gap over 1 s: after VIBA2 the map is archived and tracking starts a
    new one; before VIBA2 (here: the new map) the active map is reset."""
    cfg, feats, _, js, ts = initialized
    # bring both to a fresh, initialized state again is not needed: the
    # branch reads the map's and the mapper's flags
    for s in (js, ts):
        s.map.imu_initialized = True
        s.mapper._viba_stage = 2
    last = ts.tracker.traj_time[-1] if ts.tracker.traj_time else 0.0
    n_maps = ts.atlas.n_maps()
    with jax.enable_x64(False):
        js.track_features(feats[0], last, imu=None)
    ts.track_features(_to_port(feats[0]), last, imu=None)
    for s in (js, ts):
        old = s.map
        with jax.enable_x64(False):
            s._check_timestamp_jump(last + 2.0)
        assert s.map is not old
    assert ts.atlas.n_maps() == js.atlas.n_maps()
    for s in (js, ts):
        old, n0 = s.map, s.atlas.n_maps()
        with jax.enable_x64(False):
            s.track_features(feats[0] if s is js else _to_port(feats[0]), last + 2.0)
            s._check_timestamp_jump(last + 4.5)          # before VIBA2: a reset
        assert s.map is not old and s.atlas.n_maps() == n0
    assert n_maps >= 1
