"""Port vs JAX: both ``System``s with the IMU_STEREO sensor on a
KannalaBrandt8 camera: ``tests/test_vi_slam.py``'s motion and IMU (100 Hz,
a tilted gravity), ``tests/test_fisheye_e2e.py``'s fisheye world's features
with depth through ``track_features(..., imu=)``, the JAX ``System`` under
``test_torch_vi_system.reference_rules``. Every inertial residual is
KB8's (fisheye rows are mono).

Tolerances (test_torch_vi_system's): the same states and keyframes, the IMU
initialized on the same frame on both sides, centres within 1e-3 m. The
drive stops a few frames after the initialization: a frame after it costs
the port ~2–3 s of CPU. JAX runs with x64 off, as outside the test suite."""

import dataclasses

import numpy as np
import jax

from orb_slam3_rgbl_tpu.config import IMU_STEREO, ImuConfig
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu_torch.geometry import camera as tcam
from orb_slam3_rgbl_tpu_torch.slam import tracking as t_trk

import test_fisheye_e2e as jf
from test_torch_fisheye_e2e import _centers, _port_system
from test_torch_mono import _to_port
from test_torch_system import one_torch_thread  # noqa: F401  (module fixture)
from test_torch_vi_system import reference_rules
from test_vi_slam import simulate_vi_sequence

N_VI = 19


def test_imu_stereo_fisheye_initializes_with_jax():
    rng = np.random.default_rng(1)
    cfg = dataclasses.replace(jf.fisheye_config(), sensor=IMU_STEREO, imu=ImuConfig())
    with jax.enable_x64(False):
        gt, blocks, _, _ = simulate_vi_sequence(rng, N_VI)
        world = jf.FisheyeWorld(rng)
        feats = [world.render(gt[i]) for i in range(N_VI)]
    with reference_rules():
        js, ts = JSystem(cfg), _port_system(cfg)
        log = []
        for i, f in enumerate(feats):
            imu = None if i == 0 else blocks[i - 1]
            with jax.enable_x64(False):
                rj = js.track_features(f, i * 0.1, imu=imu)
            rt = ts.track_features(_to_port(f), i * 0.1, imu=imu)
            log.append((rj, rt, js.map.imu_initialized, ts.map.imu_initialized))
    assert tcam.is_fisheye(ts.tracker.geo_cam)
    assert [r[0].state for r in log] == [r[1].state for r in log]
    assert all(r[1].state == t_trk.OK for r in log)
    assert [r[0].created_kf for r in log] == [r[1].created_kf for r in log]
    init_j = [r[2] for r in log].index(True)
    assert [r[3] for r in log].index(True) == init_j and init_j <= N_VI - 3, init_j
    diff = np.abs(_centers([r[1] for r in log]) - _centers([r[0] for r in log])).max()
    assert diff < 1e-3, diff
