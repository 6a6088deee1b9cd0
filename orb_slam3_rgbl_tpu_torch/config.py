"""Typed configuration and the reference's settings files (counterpart of
``orb_slam3_rgbl_tpu.config``).

The sensor constants, ``OrbConfig``, ``LidarConfig``, ``SlamConfig`` and
``kitti_rgbl_config`` are copies of the JAX package's, so that
``dataclasses.asdict`` of one loads into the other (``convert``).
``load_config`` reads both generations of the reference's OpenCV-YAML
settings: the legacy flat keys (``Examples/RGB-L/KITTI00-02.yaml``) and
``File.version: "1.0"`` with ``!!opencv-matrix`` blocks. ``StereoConfig``
feeds the stereo rectifier; ``ImuConfig`` the inertial sensors (read from
either generation's IMU keys).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

from orb_slam3_rgbl_tpu_torch.geometry.camera import KannalaBrandt8Camera, PinholeCamera

# Sensor modes — superset of the reference enum (RGBL=6 is the fork's).
MONOCULAR = 0
STEREO = 1
RGBD = 2
IMU_MONOCULAR = 3
IMU_STEREO = 4
IMU_RGBD = 5
RGBL = 6

SENSOR_NAMES = {
    MONOCULAR: "MONOCULAR",
    STEREO: "STEREO",
    RGBD: "RGBD",
    IMU_MONOCULAR: "IMU_MONOCULAR",
    IMU_STEREO: "IMU_STEREO",
    IMU_RGBD: "IMU_RGBD",
    RGBL: "RGBL",
}


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
    """The IMU of the inertial sensors: ``T_body_cam`` the 4×4 row-major
    camera → body calibration (``IMU.T_b_c1``, or the older ``Tbc``), the
    white-noise densities of the gyro and accelerometer (``IMU.NoiseGyro``,
    ``IMU.NoiseAcc``: the preintegration covariance) and their random walks
    (``IMU.GyroWalk``, ``IMU.AccWalk``: the bias-walk information of the
    inertial BA), the sample rate (``IMU.Frequency``)."""

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
        """The geometric camera of matching and of the solvers' residuals
        (the reference's ``GeometricCamera``): a ``KannalaBrandt8Camera``
        when ``Camera.type`` is KannalaBrandt8 (its k0..k3 ride in the
        k1, k2, k3 and p2 slots of ``camera``, the order of the settings'
        Camera.k1..k4), else the pinhole itself."""
        if self.camera_type == "KannalaBrandt8":
            c = self.camera
            return KannalaBrandt8Camera(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, k0=c.k1, k1=c.k2,
                                        k2=c.k3, k3=c.p2, width=c.width, height=c.height,
                                        bf=c.bf, th_depth=c.th_depth)
        return self.camera


_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


def parse_opencv_yaml(path: str) -> dict:
    """The subset of OpenCV YAML that the reference's settings files use:
    flat ``key: value`` lines and ``!!opencv-matrix`` blocks (``rows``,
    ``cols``, ``data``), which parse to float64 numpy arrays. Returns
    {str: float | int | str | np.ndarray}."""
    out: dict = {}
    with open(path, "r") as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        line = lines[i].split("#", 1)[0].rstrip()
        i += 1
        if not line or line.startswith("%") or ":" not in line:
            continue
        key, _, val = line.partition(":")
        key, val = key.strip(), val.strip()
        if not key:
            continue
        if "!!opencv-matrix" in val:
            rows = cols = 0
            data: list = []
            in_data = False
            while i < len(lines):
                sub = lines[i].split("#", 1)[0].rstrip()
                if sub and not sub.startswith((" ", "\t")):
                    break  # the next top-level key
                i += 1
                s = sub.strip()
                if s.startswith("rows:"):
                    rows = int(s.split(":", 1)[1])
                elif s.startswith("cols:"):
                    cols = int(s.split(":", 1)[1])
                elif s.startswith("data:") or in_data:
                    in_data = True
                    payload = s.split(":", 1)[1] if s.startswith("data:") else s
                    payload = payload.replace("[", " ").replace("]", " ").replace(",", " ")
                    data.extend(float(x) for x in payload.split())
                    if len(data) >= rows * cols > 0:
                        in_data = False
            if rows * cols > 0 and len(data) >= rows * cols:
                out[key] = np.asarray(data[: rows * cols], np.float64).reshape(rows, cols)
            continue
        val = val.strip('"')
        if not val:
            continue
        if _NUM_RE.match(val):
            num = float(val)
            out[key] = (int(num) if num == int(num) and "." not in val and "e" not in val.lower()
                        else num)
        else:
            out[key] = val
    return out


def load_config(path: str, sensor: int = RGBL) -> SlamConfig:
    """A ``SlamConfig`` from a reference settings file of either generation:
    legacy flat keys (``Camera.fx`` …, ``Tracking::ParseCamParamFile``) or
    ``File.version: "1.0"`` (``Camera1.*`` / ``Camera2.*``,
    ``Stereo.T_c1_c2``, the reference's ``Settings``). The JAX package's
    rules, key by key and default by default."""
    kv = parse_opencv_yaml(path)
    new_format = str(kv.get("File.version", "")) in ("1.0", "1")

    def g(key, default=None):
        return kv.get(key, default)

    cam = PinholeCamera(
        fx=float(g("Camera.fx", g("Camera1.fx", 718.856))),
        fy=float(g("Camera.fy", g("Camera1.fy", 718.856))),
        cx=float(g("Camera.cx", g("Camera1.cx", 607.1928))),
        cy=float(g("Camera.cy", g("Camera1.cy", 185.2157))),
        k1=float(g("Camera.k1", g("Camera1.k1", 0.0))),
        k2=float(g("Camera.k2", g("Camera1.k2", 0.0))),
        p1=float(g("Camera.p1", g("Camera1.p1", 0.0))),
        # KannalaBrandt8 files carry k1..k4 and no tangential terms: k4
        # rides in the p2 slot
        p2=float(g("Camera.p2", g("Camera1.p2", g("Camera.k4", g("Camera1.k4", 0.0))))),
        k3=float(g("Camera.k3", g("Camera1.k3", 0.0))),
        width=int(g("Camera.width", 1241)),
        height=int(g("Camera.height", 376)),
        bf=float(g("Camera.bf", 0.0)),
        th_depth=float(g("Stereo.ThDepth", g("ThDepth", 35.0))),
    )
    stereo = None
    if new_format and "Camera2.fx" in kv:
        T = np.asarray(g("Stereo.T_c1_c2", np.eye(4)), np.float64)
        stereo = StereoConfig(
            fx=float(g("Camera2.fx")), fy=float(g("Camera2.fy")),
            cx=float(g("Camera2.cx")), cy=float(g("Camera2.cy")),
            k1=float(g("Camera2.k1", 0.0)), k2=float(g("Camera2.k2", 0.0)),
            p1=float(g("Camera2.p1", 0.0)),
            p2=float(g("Camera2.p2", g("Camera2.k4", 0.0))),
            k3=float(g("Camera2.k3", 0.0)),
            T_c1_c2=tuple(T.reshape(-1).tolist()),
            needs_rectify=str(g("Camera.type", "PinHole")) != "Rectified",
        )
        if cam.bf == 0.0:
            # bf from the stereo baseline: ‖t‖·fx
            cam = dataclasses.replace(cam, bf=float(np.linalg.norm(T[:3, 3]) * cam.fx))
    orb = OrbConfig(
        n_features=int(g("ORBextractor.nFeatures", 2000)),
        scale_factor=float(g("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        ini_th_fast=int(g("ORBextractor.iniThFAST", 12)),
        min_th_fast=int(g("ORBextractor.minThFAST", 7)),
    )
    tr = tuple(float(g(f"LiDAR.Tr{i}{j}", 1.0 if j == i else 0.0))
               for i in (1, 2, 3) for j in (1, 2, 3, 4))
    lidar = LidarConfig(
        T_velo_cam=tr,
        method=str(g("LiDAR.Method", "InverseDilation")),
        min_dist=float(g("LiDAR.min_dist", 5.0)),
        max_dist=float(g("LiDAR.max_dist", 200.0)),
        nn_search_distance=float(g("LiDAR.MethodNearestNeighborPixel.SearchDistance", 7.0)),
        avg_dilation_preprocessing=bool(g("LiDAR.MethodAverageFiltering.bDoDilationPreprocessing", 1)),
        avg_dilation_kernel_type=str(g("LiDAR.MethodAverageFiltering.DilationPreprocessing_KernelType",
                                       "Diamond")),
        avg_dilation_kernel_size=int(g("LiDAR.MethodAverageFiltering.DilationPreprocessing_KernelSize",
                                       3)),
        avg_kernel_size=int(g("LiDAR.MethodAverageFiltering.KernelSize", 5)),
        dil_kernel_type=str(g("LiDAR.MethodInverseDilation.KernelType", "Diamond")),
        dil_kernel_size_u=int(g("LiDAR.MethodInverseDilation.KernelSize_u", 5)),
        dil_kernel_size_v=int(g("LiDAR.MethodInverseDilation.KernelSize_v", 7)),
    )
    imu = None
    if sensor in (IMU_MONOCULAR, IMU_STEREO, IMU_RGBD) or "IMU.NoiseGyro" in kv:
        # legacy flat Tbc.data or the new format's IMU.T_b_c1 matrix
        tbc = g("IMU.T_b_c1", g("Tbc", None))
        tbc_tuple = ImuConfig.T_body_cam
        if tbc is not None:
            tbc_tuple = tuple(np.asarray(tbc, np.float64).reshape(-1).tolist())
        imu = ImuConfig(
            T_body_cam=tbc_tuple,
            noise_gyro=float(g("IMU.NoiseGyro", 1.7e-4)),
            noise_acc=float(g("IMU.NoiseAcc", 2.0e-3)),
            gyro_walk=float(g("IMU.GyroWalk", 1.9e-5)),
            acc_walk=float(g("IMU.AccWalk", 3.0e-3)),
            frequency=float(g("IMU.Frequency", 200.0)),
        )
    return SlamConfig(
        sensor=sensor,
        camera=cam,
        orb=orb,
        lidar=lidar,
        imu=imu,
        stereo=stereo,
        camera_type=str(g("Camera.type", "PinHole")),
        fps=float(g("Camera.fps", 10.0)),
        rgb_order=bool(g("Camera.RGB", 1)),
        depth_map_factor=float(g("RGBD.DepthMapFactor", 1000.0)),
        loop_closing=bool(g("loopClosing", 1)),
        save_atlas_file=g("System.SaveAtlasToFile"),
        load_atlas_file=g("System.LoadAtlasFromFile"),
    )


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
