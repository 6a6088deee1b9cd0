"""Port vs JAX: both ``System``s with a KannalaBrandt8 camera on the
feature drive of ``tests/test_fisheye_e2e.py`` (STEREO, a TUM-VI-like
fisheye, 30 frames of 600 features with depth, ``track_features``): the
same states and keyframes every frame, centres within 5 mm, and the JAX
test's own bars on the port — ATE < 0.1 m, more than 20 landmarks over 30°
off the axis bound in the last keyframe, their KB8 reprojection median under
2 px.

The image drive through ``track_stereo`` is in test_torch_fisheye_images.py,
IMU_STEREO with the fisheye in test_torch_fisheye_vi.py. JAX runs with x64
off, as outside the test suite; the drives pin one torch thread
(``one_torch_thread``)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from orb_slam3_rgbl_tpu.geometry import align as j_align, lie as jlie
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import camera as tcam, lie as tlie
from orb_slam3_rgbl_tpu_torch.slam import tracking as t_trk
from orb_slam3_rgbl_tpu_torch.slam.system import System as TSystem

import test_fisheye_e2e as jf
from test_torch_mono import _to_port
from test_torch_system import one_torch_thread  # noqa: F401  (module fixture)

POSE_TOL_M = 5e-3
N_FEATURE = 30


def _port_system(cfg):
    return TSystem(convert.config_from_dict(dataclasses.asdict(cfg)), device="cpu")


def _centers(results):
    return tlie.np_se3_centers(np.stack([r.pose for r in results]))


# ---------------------------------------------------------------------------
# The feature drive of tests/test_fisheye_e2e.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def feature_drive():
    rng = np.random.default_rng(0)
    cfg = jf.fisheye_config()
    with jax.enable_x64(False):
        world = jf.FisheyeWorld(rng)
        gt = []
        for i in range(N_FEATURE):
            yaw = 0.06 * np.sin(i * 0.4)
            q = np.array([np.cos(yaw / 2), 0, np.sin(yaw / 2), 0], np.float32)
            Twc = np.concatenate([q, [0.15 * np.sin(i * 0.3), 0.0, i * 0.28]]).astype(np.float32)
            gt.append(np.asarray(jlie.se3_inv(jnp.asarray(Twc)), np.float32))
        feats = [world.render(Tcw) for Tcw in gt]
        js = JSystem(cfg)
        ts = _port_system(cfg)
        log = []
        for i, f in enumerate(feats):
            log.append((js.track_features(f, i * 0.1), ts.track_features(_to_port(f), i * 0.1),
                        js.map.n_kf, ts.map.n_kf))
    return js, ts, np.stack(gt), log


def test_feature_drive_matches_jax(feature_drive):
    js, ts, gt, log = feature_drive
    assert tcam.is_fisheye(ts.tracker.geo_cam) and tcam.is_fisheye(ts.mapper.geo_cam)
    assert [r[0].state for r in log] == [r[1].state for r in log]
    assert all(r[1].state == t_trk.OK for r in log)
    assert [r[0].created_kf for r in log] == [r[1].created_kf for r in log]
    assert [r[2] for r in log] == [r[3] for r in log] and ts.map.n_kf >= 2
    diff = np.abs(_centers([r[1] for r in log]) - _centers([r[0] for r in log])).max()
    assert diff < POSE_TOL_M, diff
    with jax.enable_x64(False):
        gt_twc = np.asarray(jlie.se3_inv(jnp.asarray(gt)))
        for s in (js, ts):
            err = float(j_align.ate_rmse(jnp.asarray(gt_twc[:, 4:7]),
                                         jnp.asarray(np.asarray(s.trajectory())[:, 4:7])))
            assert err < 0.1, err


def test_off_axis_landmarks_survive_ba_in_the_port(feature_drive):
    """test_fisheye_e2e's bar on the port: landmarks > 30° off the axis of
    the last keyframe stay bound there, and reproject under the KB8 model
    within 2 px (median)."""
    _, ts, _, _ = feature_drive
    m = ts.map
    lms = np.nonzero(m.lm_valid)[0]
    assert lms.size > 200
    kf = int(m.valid_kf_ids()[-1])
    pc = tlie.np_se3_apply(m.kf_pose[kf], m.lm_pos[lms])
    theta = np.degrees(np.arctan2(np.linalg.norm(pc[:, :2], axis=1), pc[:, 2]))
    row = m.kf_lm_idx[kf]
    slot_of = {int(lm): i for i, lm in enumerate(row) if lm >= 0}
    off = np.asarray([lm for lm, t in zip(lms, theta) if t > 30 and int(lm) in slot_of])
    assert len(off) > 20, len(off)
    feat = np.asarray([slot_of[int(lm)] for lm in off])
    proj = tcam.np_geo_project(ts.tracker.geo_cam,
                               tlie.np_se3_apply(m.kf_pose[kf], m.lm_pos[off]))
    errs = np.linalg.norm(proj - m.kf_uv[kf, feat], axis=1)
    assert np.median(errs) < 2.0, np.median(errs)
