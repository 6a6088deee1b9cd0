"""Port vs JAX: the reference's settings files, keypoint undistortion and
the distorted camera's setup in ``System``.

Tolerances. ``load_config`` is plain Python on both sides: ``dataclasses.
asdict`` of the two configurations is held equal, and ``parse_opencv_yaml``'s
matrices exactly. ``undistort_points`` runs 8 fixed f32 iterations on both
sides; XLA fuses their multiply-adds differently, so pixels are held to
3e-4 px (1.2e-4 observed: 2 ulp at 750 px) on a strongly distorted EuRoC
camera over its whole image."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu import config as j_cfg
from orb_slam3_rgbl_tpu.geometry import camera as j_cam
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu_torch import config as t_cfg
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import camera as t_cam
from orb_slam3_rgbl_tpu_torch.slam.system import System as TSystem

from test_config import LEGACY_YAML, NEW_YAML

UNDISTORT_TOL_PX = 3e-4

# Examples/RGB-L/KITTI00-02.yaml's key set, as the KITTI drivers read it
KITTI_YAML = """%YAML:1.0
---
Camera.type: "PinHole"
Camera.fx: 718.856
Camera.fy: 718.856
Camera.cx: 607.1928
Camera.cy: 185.2157
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 1241
Camera.height: 376
Camera.fps: 10.0
Camera.bf: 386.1448
Camera.RGB: 1
ThDepth: 40.0
RGBD.DepthMapFactor: 256.0
LiDAR.Method: "InverseDilation"
LiDAR.min_dist: 5.0
LiDAR.max_dist: 200.0
LiDAR.MethodInverseDilation.KernelType: "Diamond"
LiDAR.MethodInverseDilation.KernelSize_u: 5
LiDAR.MethodInverseDilation.KernelSize_v: 7
LiDAR.Tr11: 4.276802385584e-04
LiDAR.Tr12: -9.999672484946e-01
LiDAR.Tr13: -8.084491683471e-03
LiDAR.Tr14: -1.198459927713e-02
LiDAR.Tr21: -7.210626507497e-03
LiDAR.Tr22: 8.081198471645e-03
LiDAR.Tr23: -9.999413164504e-01
LiDAR.Tr24: -5.403984729748e-02
LiDAR.Tr31: 9.999738645903e-01
LiDAR.Tr32: 4.859485810390e-04
LiDAR.Tr33: -7.206933692422e-03
LiDAR.Tr34: -2.921968648686e-01
ORBextractor.nFeatures: 2000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 12
ORBextractor.minThFAST: 7
System.SaveAtlasToFile: "atlas.npz"
"""


@pytest.fixture(params=["kitti", "legacy", "new"])
def settings(request, tmp_path):
    p = tmp_path / f"{request.param}.yaml"
    p.write_text({"kitti": KITTI_YAML, "legacy": LEGACY_YAML, "new": NEW_YAML}[request.param])
    return str(p)


@pytest.mark.parametrize("sensor", [t_cfg.RGBL, t_cfg.RGBD, t_cfg.IMU_STEREO])
def test_load_config_matches_jax(settings, sensor):
    assert t_cfg.SENSOR_NAMES == j_cfg.SENSOR_NAMES
    kv_t, kv_j = t_cfg.parse_opencv_yaml(settings), j_cfg.parse_opencv_yaml(settings)
    assert kv_t.keys() == kv_j.keys()
    for k, v in kv_j.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(kv_t[k], v)
        else:
            assert kv_t[k] == v and type(kv_t[k]) is type(v), k
    c_t = t_cfg.load_config(settings, sensor=sensor)
    c_j = j_cfg.load_config(settings, sensor=sensor)
    assert dataclasses.asdict(c_t) == dataclasses.asdict(c_j)
    # and the port's configuration is what convert makes of the JAX one
    assert convert.config_from_dict(dataclasses.asdict(c_j)) == c_t


def test_kitti_settings_give_the_kitti_configuration(tmp_path):
    p = tmp_path / "kitti.yaml"
    p.write_text(KITTI_YAML)
    cfg = t_cfg.load_config(str(p))
    ref = t_cfg.kitti_rgbl_config()
    assert cfg.camera == dataclasses.replace(ref.camera, bf=386.1448, th_depth=40.0)
    assert cfg.orb == ref.orb and cfg.lidar == ref.lidar
    assert cfg.depth_map_factor == 256.0 and cfg.save_atlas_file == "atlas.npz"


def test_undistort_points_matches_jax():
    kw = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, k1=-0.28340811,
              k2=0.07395907, p1=0.00019359, p2=1.76187114e-05, k3=0.01, width=752, height=480)
    rng = np.random.default_rng(0)
    uv = np.stack([rng.uniform(0, 752, 4000), rng.uniform(0, 480, 4000)], 1).astype(np.float32)
    with jax.enable_x64(False):
        ref = np.asarray(j_cam.undistort_points(j_cam.PinholeCamera(**kw), jnp.asarray(uv)))
    out = t_cam.undistort_points(t_cam.PinholeCamera(**kw), torch.from_numpy(uv))
    assert out.dtype == torch.float32 and out.shape == (4000, 2)
    assert np.abs(out.numpy() - ref).max() < UNDISTORT_TOL_PX
    # it inverts the distortion of project (JAX's own bar: 5e-3 px)
    xy = rng.uniform(-0.5, 0.5, (200, 2)).astype(np.float32)
    pts = torch.from_numpy(np.concatenate([xy, np.ones((200, 1), np.float32)], 1))
    cam = t_cam.PinholeCamera(**kw)
    ideal = t_cam.project(dataclasses.replace(cam, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0), pts)
    assert (t_cam.undistort_points(cam, t_cam.project(cam, pts)) - ideal).abs().max() < 5e-3
    # no distortion: the points as they are
    x = torch.from_numpy(uv)
    assert t_cam.undistort_points(dataclasses.replace(cam, k1=0.0, k2=0.0, p1=0.0, p2=0.0,
                                                      k3=0.0), x) is x


@pytest.mark.parametrize("sensor", [t_cfg.RGBD, t_cfg.RGBL])
def test_distorted_system_zeroes_its_working_camera(tmp_path, sensor):
    """Both packages keep the distorted camera for undistortion and work on
    a copy with the distortion zeroed (the EuRoC file's PinHole camera)."""
    p = tmp_path / "new.yaml"
    p.write_text(NEW_YAML)
    c_j = dataclasses.replace(j_cfg.load_config(str(p), sensor=sensor), stereo=None)
    c_t = dataclasses.replace(t_cfg.load_config(str(p), sensor=sensor), stereo=None)
    js, ts = JSystem(c_j), TSystem(c_t, device="cpu")
    assert ts._undistort_cam == c_t.camera and js._undistort_cam is not None
    assert dataclasses.asdict(ts._undistort_cam) == dataclasses.asdict(js._undistort_cam)
    assert not ts.cam.has_distortion and ts.cfg.camera == ts.cam
    assert dataclasses.asdict(ts.cfg) == dataclasses.asdict(js.cfg)
    # an undistorted camera keeps its configuration
    plain = dataclasses.replace(c_t, camera=ts.cam)
    assert TSystem(plain, device="cpu")._undistort_cam is None
