"""Typed configuration (counterpart of ``orb_slam3_rgbl_tpu.config``).

The sensor constants, ``OrbConfig``, ``LidarConfig``, ``SlamConfig`` and
``kitti_rgbl_config`` are copies of the JAX package's, so that
``dataclasses.asdict`` of one loads into the other (``convert``). The
OpenCV-YAML ``load_config`` is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera

# Sensor modes — superset of the reference enum (RGBL=6 is the fork's).
MONOCULAR = 0
STEREO = 1
RGBD = 2
IMU_MONOCULAR = 3
IMU_STEREO = 4
IMU_RGBD = 5
RGBL = 6


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """ORB extractor settings (``ORBextractor.nFeatures`` etc.)."""

    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 12
    min_th_fast: int = 7


@dataclasses.dataclass(frozen=True)
class LidarConfig:
    """RGB-L depth-module settings (``DepthModule::ParseRGBLParameters``)."""

    # Row-major 3x4 T_velo→cam (LiDAR.Tr11..Tr34)
    T_velo_cam: tuple = (
        1.0, 0.0, 0.0, 0.0,
        0.0, 1.0, 0.0, 0.0,
        0.0, 0.0, 1.0, 0.0,
    )
    method: str = "InverseDilation"  # None|NearestNeighborPixel|AverageFiltering|InverseDilation
    min_dist: float = 5.0
    max_dist: float = 200.0
    # NearestNeighborPixel
    nn_search_distance: float = 7.0
    # AverageFiltering
    avg_dilation_preprocessing: bool = True
    avg_dilation_kernel_type: str = "Diamond"
    avg_dilation_kernel_size: int = 3
    avg_kernel_size: int = 5
    # InverseDilation
    dil_kernel_type: str = "Diamond"
    dil_kernel_size_u: int = 5
    dil_kernel_size_v: int = 7


@dataclasses.dataclass(frozen=True)
class ImuConfig:
    """IMU noise/extrinsics (carried for config round-trips; the inertial
    path is not ported yet)."""

    T_body_cam: tuple = (
        1.0, 0.0, 0.0, 0.0,
        0.0, 1.0, 0.0, 0.0,
        0.0, 0.0, 1.0, 0.0,
        0.0, 0.0, 0.0, 1.0,
    )
    noise_gyro: float = 1.7e-4
    noise_acc: float = 2.0e-3
    gyro_walk: float = 1.9e-5
    acc_walk: float = 3.0e-3
    frequency: float = 200.0
    inserts_kfs_when_lost: bool = True


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    """Second camera + extrinsics (carried for config round-trips; the
    stereo path is not ported yet)."""

    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    T_c1_c2: tuple = (
        1.0, 0.0, 0.0, 0.0,
        0.0, 1.0, 0.0, 0.0,
        0.0, 0.0, 1.0, 0.0,
        0.0, 0.0, 0.0, 1.0,
    )
    needs_rectify: bool = True


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    sensor: int = RGBL
    camera: PinholeCamera = dataclasses.field(default_factory=PinholeCamera)
    orb: OrbConfig = dataclasses.field(default_factory=OrbConfig)
    lidar: LidarConfig = dataclasses.field(default_factory=LidarConfig)
    imu: Optional[ImuConfig] = None
    stereo: Optional[StereoConfig] = None
    camera_type: str = "PinHole"  # Camera.type: PinHole|Rectified|KannalaBrandt8
    fps: float = 10.0
    rgb_order: bool = True
    depth_map_factor: float = 1000.0
    # capacity pool sizes (static shapes)
    max_keyframes: int = 2048
    max_map_points: int = 262144
    max_maps: int = 8
    loop_closing: bool = True
    save_atlas_file: Optional[str] = None
    load_atlas_file: Optional[str] = None
    vocab_path: Optional[str] = None

    @property
    def inertial(self) -> bool:
        return self.sensor in (IMU_MONOCULAR, IMU_STEREO, IMU_RGBD)

    @property
    def geo_camera(self):
        """The geometric camera of the residuals. Only the pinhole is
        ported; KannalaBrandt8 waits for the other-sensors slice."""
        if self.camera_type == "KannalaBrandt8":
            raise NotImplementedError("KannalaBrandt8 camera is not ported yet")
        return self.camera


def kitti_rgbl_config(sensor: int = RGBL) -> SlamConfig:
    """The KITTI 00-02 RGB-L configuration (constants from
    ``Examples/RGB-L/KITTI00-02.yaml``)."""
    tr = (
        4.276802385584e-04, -9.999672484946e-01, -8.084491683471e-03, -1.198459927713e-02,
        -7.210626507497e-03, 8.081198471645e-03, -9.999413164504e-01, -5.403984729748e-02,
        9.999738645903e-01, 4.859485810390e-04, -7.206933692422e-03, -2.921968648686e-01,
    )
    return SlamConfig(
        sensor=sensor,
        camera=PinholeCamera(
            fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
            width=1241, height=376, bf=100.0, th_depth=700.0,
        ),
        orb=OrbConfig(n_features=2000, scale_factor=1.2, n_levels=8, ini_th_fast=12, min_th_fast=7),
        lidar=LidarConfig(T_velo_cam=tr, method="InverseDilation", min_dist=5.0, max_dist=200.0,
                          dil_kernel_type="Diamond", dil_kernel_size_u=5, dil_kernel_size_v=7),
        fps=10.0,
    )
