"""Port vs JAX: both ``System``s with the IMU_STEREO sensor over
``tests/test_vi_slam.py``'s feature-level visual-inertial drive (24 frames,
features with their stereo depth and right columns) through
``track_features(..., imu=)``: the path of ``run_euroc --mode
stereo-inertial`` after rectification and extraction. The pair here is
already rectified, so the body ← camera extrinsic is the configuration's
in both packages (the rotation into a rectified camera is
``test_torch_euroc_io.test_imu_extrinsic_follows_the_rectification``).

Tolerances: ``test_torch_vi_system.check_drive``'s (the same states,
keyframes and IMU initialization frame, centres within 1e-3 m, keyframe
velocities and biases, the temporal chain, Sim3 ATE < 0.5 m)."""

from orb_slam3_rgbl_tpu.config import IMU_STEREO

from test_torch_system import one_torch_thread  # noqa: F401  (module fixture)
from test_torch_vi_system import check_drive, drive_both, vi_frames

N_STEREO = 24


def test_imu_stereo_drive_matches_jax():
    cfg, feats, blocks, gt, _ = vi_frames(IMU_STEREO, N_STEREO)
    js, ts, log = drive_both(cfg, feats, blocks)
    assert js.cfg.sensor == ts.cfg.sensor == IMU_STEREO
    check_drive(js, ts, log, gt)
