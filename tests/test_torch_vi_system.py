"""Port vs JAX: both ``System``s with the IMU_RGBD sensor over
``tests/test_vi_slam.py``'s feature-level visual-inertial drive (a tilted
gravity, sinusoidal accelerations, 100 Hz samples, 10 fps) through
``track_features(..., imu=)``, then the VIBA1 / VIBA2 schedule on the
driven states.

Tolerances (24 frames; observed ≥ 4× below): the same states, keyframes
and IMU initialization frame; frame centres within 1e-3 m of JAX's
(observed 2.5e-4, growing ~1.4e-5 a frame after the initialization);
keyframe velocities within 5e-3 m/s, gyro biases within 2e-4, accel
biases within 3e-3 (observed 6.5e-4: the initialization's weakly held
accel bias); the same temporal
IMU chain, its preintegration times within 1e-6 s; Sim3-aligned ATE < 0.5 m
on both (``test_vi_slam``'s bound). After VIBA1 and VIBA2 the keyframe
centres within 2e-3 m and velocities within 1e-2 m/s of JAX's.
JAX runs with x64 off, as outside the test suite."""

import contextlib
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from orb_slam3_rgbl_tpu.config import IMU_MONOCULAR, IMU_RGBD, ImuConfig, kitti_rgbl_config
from orb_slam3_rgbl_tpu.geometry import align as j_align, lie as j_lie
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from orb_slam3_rgbl_tpu_torch.slam import tracking as t_trk
from orb_slam3_rgbl_tpu_torch.slam.system import System as TSystem

from synthetic_world import SyntheticWorld
from test_torch_mono import _to_port
from test_torch_system import one_torch_thread  # noqa: F401  (module fixture)
from test_vi_slam import simulate_vi_sequence

N_RGBD = 24


def vi_frames(sensor, n, seed=0, tilt_deg=12.0, length=60.0):
    """``test_vi_slam``'s drive: config, JAX features, IMU blocks, ground truth."""
    cfg = dataclasses.replace(kitti_rgbl_config(sensor=sensor), imu=ImuConfig(),
                              loop_closing=False)
    rng = np.random.default_rng(seed)
    with jax.enable_x64(False):
        gt, blocks, vel, g_world = simulate_vi_sequence(rng, n, tilt_deg=tilt_deg)
        world = SyntheticWorld(rng, cam=cfg.camera, length=length)
        feats = [world.render(gt[i]) for i in range(n)]
    return cfg, feats, blocks, gt, vel


@contextlib.contextmanager
def reference_rules():
    """The JAX ``System`` under the reference's inertial rules, which the
    port follows (``Tracking::NeedNewKeyFrame``, ``LocalMapping::
    InitializeIMU``): before the IMU initialization a keyframe comes every
    0.25 s and by no other rule (the JAX package also lets the visual policy
    insert one), and IMU_MONOCULAR initializes once 10 keyframes span 2 s,
    with the accel-bias prior 1e10 (the JAX package: 6 over 1 s, 1e6)."""
    from orb_slam3_rgbl_tpu.optim import inertial as j_inertial
    from orb_slam3_rgbl_tpu.slam.local_mapping import LocalMapper as JMapper
    from orb_slam3_rgbl_tpu.slam.tracking import Tracker as JTracker

    insert, init, solve = (JTracker._maybe_insert_keyframe, JMapper.maybe_initialize_imu,
                           j_inertial.imu_initialization)

    def maybe_insert_keyframe(self, feats, timestamp, n_inl):
        if (self.inertial and self._last_imu_kf >= 0 and self.ref_kf >= 0
                and not self.only_tracking and not self.map.imu_initialized
                and timestamp - float(self.map.kf_timestamp[self._last_imu_kf]) < 0.25):
            return False
        return insert(self, feats, timestamp, n_inl)

    def maybe_initialize_imu(self, *a, **k):
        if self.cfg.sensor != IMU_MONOCULAR:
            return init(self, *a, **k)
        j_inertial.imu_initialization = functools.partial(solve, prior_a=1e10)
        try:
            return init(self, min_kf=10, min_span_s=2.0)
        finally:
            j_inertial.imu_initialization = solve

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTracker, "_maybe_insert_keyframe", maybe_insert_keyframe)
        mp.setattr(JMapper, "maybe_initialize_imu", maybe_initialize_imu)
        yield


def drive_both(cfg, feats, blocks, t0=0.0):
    """Both ``System``s over the same frames, the JAX one under
    ``reference_rules``."""
    with reference_rules():
        return _drive_both(cfg, feats, blocks, t0)


def _drive_both(cfg, feats, blocks, t0):
    js = JSystem(cfg)
    ts = TSystem(convert.config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    log = []
    for i, f in enumerate(feats):
        imu = None if i == 0 else blocks[i - 1]
        with jax.enable_x64(False):
            rj = js.track_features(f, t0 + i * 0.1, imu=imu)
        rt = ts.track_features(_to_port(f), t0 + i * 0.1, imu=imu)
        log.append((rj, rt, js.map.n_kf, ts.map.n_kf, js.map.imu_initialized,
                    ts.map.imu_initialized))
    return js, ts, log


def sim3_ate(sysm, gt) -> float:
    est = sysm.trajectory()
    ok = ~np.array(sysm.tracker.traj_lost)
    with jax.enable_x64(False):
        gt_twc = np.asarray(j_lie.se3_inv(jnp.asarray(gt)))
        return float(j_align.ate_rmse(jnp.asarray(gt_twc[ok, 4:7]),
                                      jnp.asarray(np.asarray(est)[ok, 4:7]), with_scale=True))


@pytest.fixture(scope="module")
def rgbd_drive():
    cfg, feats, blocks, gt, vel = vi_frames(IMU_RGBD, N_RGBD)
    js, ts, log = drive_both(cfg, feats, blocks)
    return js, ts, log, gt


def test_imu_rgbd_drive_matches_jax(rgbd_drive):
    check_drive(*rgbd_drive)


def check_drive(js, ts, log, gt):
    """The tolerances above, on a drive of ``drive_both``."""
    assert [r[0].state for r in log] == [r[1].state for r in log]
    assert all(r[1].state == t_trk.OK for r in log)
    assert [r[0].created_kf for r in log] == [r[1].created_kf for r in log]
    assert [r[2] for r in log] == [r[3] for r in log]
    init_j = [r[4] for r in log].index(True)
    assert [r[5] for r in log].index(True) == init_j and 10 <= init_j < len(log) - 4
    assert js.mapper._imu_init_time == ts.mapper._imu_init_time
    c_j = t_lie.np_se3_centers(np.stack([r[0].pose for r in log]))
    c_t = t_lie.np_se3_centers(np.stack([r[1].pose for r in log]))
    assert np.abs(c_t - c_j).max() < 1e-3, np.abs(c_t - c_j).max()
    mj, mt = js.map, ts.map
    kfs = mj.valid_kf_ids()
    np.testing.assert_array_equal(kfs, mt.valid_kf_ids())
    assert np.abs(mt.kf_vel[kfs] - mj.kf_vel[kfs]).max() < 5e-3
    assert np.abs(mt.kf_bg[kfs] - mj.kf_bg[kfs]).max() < 2e-4
    assert np.abs(mt.kf_ba[kfs] - mj.kf_ba[kfs]).max() < 3e-3
    np.testing.assert_array_equal(mt.kf_prev_imu[kfs], mj.kf_prev_imu[kfs])
    assert sorted(mt.imu_preint) == sorted(mj.imu_preint)
    for k in mj.imu_preint:
        assert abs(float(mt.imu_preint[k][0]) - float(mj.imu_preint[k][0])) < 1e-6
    assert np.abs(ts.tracker.cur_vel - js.tracker.cur_vel).max() < 5e-3
    for s in (js, ts):
        assert sim3_ate(s, gt) < 0.5


def test_viba_schedule_matches_jax(rgbd_drive):
    """VIBA1 5 s after the IMU initialization and VIBA2 15 s after it, on
    the driven states (the drive itself is 0.8 s past the initialization)."""
    js, ts, _, _ = rgbd_drive
    t0 = ts.mapper._imu_init_time
    for stage, dt in ((0, 4.9), (1, 5.0), (2, 15.0)):
        with jax.enable_x64(False):
            js.mapper.maybe_viba(t0 + dt)
        ts.mapper.maybe_viba(t0 + dt)
        assert ts.mapper._viba_stage == getattr(js.mapper, "_viba_stage", 0) == stage
    assert ts.mapper.counts["full_inertial_ba_runs"] == 2
    kfs = js.map.valid_kf_ids()
    c_j = t_lie.np_se3_centers(js.map.kf_pose[kfs])
    c_t = t_lie.np_se3_centers(ts.map.kf_pose[kfs])
    assert np.abs(c_t - c_j).max() < 2e-3, np.abs(c_t - c_j).max()
    assert np.abs(ts.map.kf_vel[kfs] - js.map.kf_vel[kfs]).max() < 1e-2
    assert np.isfinite(ts.map.lm_pos[ts.map.lm_valid]).all()
