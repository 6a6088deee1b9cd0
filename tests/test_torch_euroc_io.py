"""Port vs JAX: the EuRoC / TUM RGB-D loaders (``io/euroc.py``, which decode
through the port's own PNG reader where the JAX package calls
``cv2.imread``) and the stereo KITTI and monocular EuRoC drivers.

* ``EurocSequence`` (mono, stereo + IMU, an external timestamp list),
  ``load_cam_index``, ``load_imu`` and ``TumRgbdSequence`` on sequences
  written by the test with ``io/png.write_png``: exact against the JAX
  loaders (images, depth, timestamps, IMU windows; the port's IMU windows
  stay float64, EuRoC's ~1.4e9 s stamps being 128 s coarse in float32, and
  equal the JAX float32 windows once cast).
* ``run_kitti_stereo`` (6 stereo pairs of the 320×192 canyon): both
  packages' drivers track every frame and write one finite pose a line;
  the two trajectories agree within 5 mm (tests/test_torch_stereo.py's
  bar).
* ``run_euroc --mode mono`` (12 frames of the weaving drive of
  tests/test_torch_mono_images.py): both drivers initialize, track every
  frame after it and write a finite TUM trajectory of the tracked frames
  and the EuRoC-format copy.
* ``run_euroc --mode stereo-inertial`` and ``mono-inertial`` (the port's):
  12 frames (0.55 s, before any IMU initialization) of ``chip_smoke``'s
  EuRoC-shaped sequence at 376×240: every frame OK from the first (stereo)
  or from the two-view initialization (monocular), every keyframe linked to
  its predecessor on the IMU chain with a preintegration as long as their
  time gap (1e-4 s).

JAX runs with x64 off, as outside the test suite."""

import dataclasses
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu.io import euroc as j_euroc
from orb_slam3_rgbl_tpu_torch.io import euroc as t_euroc
from orb_slam3_rgbl_tpu_torch.io.png import write_png

from chip_smoke import settings_yaml
from test_torch_stereo import render_pairs
from test_torch_system import one_torch_thread  # noqa: F401  (module fixture)

N_STEREO = 6
N_MONO = 12
STEREO_TOL_M = 5e-3


def _write_euroc(root, images_l, images_r, t0_ns=1403636579763555584, dt_ns=50_000_000):
    """An ASL ``mav0`` directory: cam0 (and cam1) 8-bit gray PNGs indexed by
    data.csv, imu0/data.csv at 200 Hz over the same span."""
    mav = os.path.join(root, "mav0")
    ts = [t0_ns + i * dt_ns for i in range(len(images_l))]
    for cam, images in (("cam0", images_l), ("cam1", images_r)):
        if images is None:
            continue
        os.makedirs(os.path.join(mav, cam, "data"))
        with open(os.path.join(mav, cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for i, (t, img) in enumerate(zip(ts, images)):
                write_png(os.path.join(mav, cam, "data", f"{t}.png"),
                          np.clip(np.round(img), 0, 255).astype(np.uint8), (0, 1, 2, 3, 4))
                f.write(f"{t},{t}.png\n")
    os.makedirs(os.path.join(mav, "imu0"))
    rng = np.random.default_rng(5)
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for t in range(ts[0] - dt_ns, ts[-1] + 1, 5_000_000):
            w, a = rng.normal(0, 0.1, 3), rng.normal(0, 0.5, 3) + [0, 0, 9.81]
            f.write(f"{t}," + ",".join(repr(float(v)) for v in (*w, *a)) + "\n")
    return mav, ts


@pytest.fixture(scope="module")
def canyon():
    cfg = dataclasses.replace(j_syn.synthetic_rgbl_config(), sensor=1)
    traj = j_syn.straight_trajectory(N_STEREO, step=0.6, weave=0.4)
    return cfg, traj, render_pairs(cfg, traj)


def test_euroc_sequence_matches_jax(tmp_path, canyon):
    _, _, pairs = canyon
    mav, ts = _write_euroc(str(tmp_path), [p[0] for p in pairs], [p[1] for p in pairs])
    stamps = tmp_path / "stamps.txt"
    np.savetxt(str(stamps), np.array([ts[1], ts[3], ts[4] + 7_000], np.int64), fmt="%d")
    for kw in (dict(), dict(stereo=True, inertial=True), dict(timestamps_file=str(stamps))):
        s_t, s_j = t_euroc.EurocSequence(str(tmp_path), **kw), j_euroc.EurocSequence(mav, **kw)
        assert len(s_t) == len(s_j) > 0 and s_t.left == s_j.left and s_t.right == s_j.right
        np.testing.assert_array_equal(s_t.times, s_j.times)
        for i in range(len(s_j)):
            ft, fj = s_t.frame(i), s_j.frame(i)
            assert len(ft) == len(fj)
            for k, (a, b) in enumerate(zip(ft, fj)):
                if isinstance(b, np.ndarray) and k == len(fj) - 2:     # the IMU window
                    assert a.dtype == np.float64 and b.dtype == np.float32
                    assert np.array_equal(a.astype(np.float32), b)
                elif isinstance(b, np.ndarray):
                    assert a.dtype == b.dtype and np.array_equal(a, b)
                else:
                    assert a == b
    assert len(t_euroc.EurocSequence(str(tmp_path), timestamps_file=str(stamps))) == 2
    np.testing.assert_array_equal(t_euroc.load_imu(mav), j_euroc.load_imu(mav))
    for a, b in zip(t_euroc.load_cam_index(mav, "cam1"), j_euroc.load_cam_index(mav, "cam1")):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    os.remove(t_euroc.EurocSequence(mav).left[0])
    with pytest.raises(FileNotFoundError):
        t_euroc.EurocSequence(mav).frame(0)


def test_tum_rgbd_sequence_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    rgb_lines, depth_lines = [], []
    (tmp_path / "rgb").mkdir()
    (tmp_path / "depth").mkdir()
    for i in range(4):
        t = 1305031102.175304 + 0.0333 * i
        rgb = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
        dep = rng.integers(0, 40000, (30, 40), dtype=np.uint16)
        write_png(str(tmp_path / "rgb" / f"{t:.6f}.png"), rgb, (0, 4, 3))
        write_png(str(tmp_path / "depth" / f"{t + 0.004:.6f}.png"), dep, (1, 2))
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth_lines.append(f"{t + 0.004:.6f} depth/{t + 0.004:.6f}.png")
    rgb_lines.append(f"{t + 5.0:.6f} rgb/none.png")      # no depth within max_dt: dropped
    (tmp_path / "rgb.txt").write_text("# color images\n" + "\n".join(rgb_lines) + "\n")
    (tmp_path / "depth.txt").write_text("# depth maps\n" + "\n".join(depth_lines) + "\n")
    s_t, s_j = t_euroc.TumRgbdSequence(str(tmp_path)), j_euroc.TumRgbdSequence(str(tmp_path))
    assert len(s_t) == len(s_j) == 4 and s_t.frames == s_j.frames
    for i in range(4):
        (it, dt, _, tt), (ij, dj, _, tj) = s_t.frame(i), s_j.frame(i)
        assert it.dtype == ij.dtype == dt.dtype == dj.dtype == np.float32
        assert np.array_equal(it, ij) and np.array_equal(dt, dj) and tt == tj


def _poses_kitti(path, n):
    rows = np.loadtxt(path)
    assert rows.shape == (n, 12) and np.isfinite(rows).all()
    return rows.reshape(-1, 3, 4)[:, :, 3]


def test_stereo_kitti_driver_on_both_packages(tmp_path, canyon, monkeypatch):
    from examples import run_kitti_stereo as j_driver
    from orb_slam3_rgbl_tpu_torch import config as t_cfg
    from orb_slam3_rgbl_tpu_torch.examples import run_kitti_stereo as t_driver

    cfg, traj, pairs = canyon
    seq = tmp_path / "seq"
    for sub, k in (("image_0", 0), ("image_1", 1)):
        (seq / sub).mkdir(parents=True)
        for i, p in enumerate(pairs):
            write_png(str(seq / sub / f"{i:06d}.png"), p[k].astype(np.uint8))
    np.savetxt(str(seq / "times.txt"), 0.1 * np.arange(N_STEREO))
    settings = str(tmp_path / "stereo.yaml")
    settings_yaml(t_cfg.SlamConfig(camera=_port_camera(cfg), orb=_port_orb(cfg)), settings)
    out_j, out_t = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    monkeypatch.setattr(sys, "argv", ["run_kitti_stereo.py", settings, str(seq), "--out", out_j])
    with jax.enable_x64(False):
        j_driver.main()
    slam, results, times = t_driver.run(t_driver.parse_args(
        [settings, str(seq), "--out", out_t, "--device", "cpu"]))
    assert slam.cfg.sensor == t_cfg.STEREO and len(results) == len(times) == N_STEREO
    assert all(r.state == 2 for r in results)
    c_j, c_t = _poses_kitti(out_j, N_STEREO), _poses_kitti(out_t, N_STEREO)
    assert np.abs(c_t - c_j).max() < STEREO_TOL_M, np.abs(c_t - c_j).max()
    assert np.abs(c_t - (traj[:, 4:7] - traj[0, 4:7])).max() < 0.2


def _port_camera(cfg):
    from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera

    return PinholeCamera(**dataclasses.asdict(cfg.camera))


def _port_orb(cfg):
    from orb_slam3_rgbl_tpu_torch.config import OrbConfig

    return OrbConfig(**dataclasses.asdict(cfg.orb))


def test_mono_euroc_driver_on_both_packages(tmp_path, monkeypatch):
    from examples import run_euroc as j_driver
    from orb_slam3_rgbl_tpu_torch import config as t_cfg
    from orb_slam3_rgbl_tpu_torch.examples import run_euroc as t_driver

    cfg = j_syn.synthetic_rgbl_config()
    cam = cfg.camera
    traj = j_syn.straight_trajectory(N_MONO, step=0.5, weave=1.2)
    with jax.enable_x64(False):
        world = j_syn.make_world(0, tex_size=256)
        images = [np.array(j_syn.render_image(world, jnp.asarray(T), cam.fx, cam.fy, cam.cx,
                                              cam.cy, cam.height, cam.width)) for T in traj]
    _write_euroc(str(tmp_path / "data"), images, None)
    settings = str(tmp_path / "mono.yaml")
    settings_yaml(t_cfg.SlamConfig(camera=_port_camera(cfg), orb=_port_orb(cfg)), settings)
    outs = {}
    for who in ("jax", "port"):
        d = tmp_path / who
        d.mkdir()
        outs[who] = (str(d / "f_dataset.txt"), str(d / "kf_dataset.txt"))
    monkeypatch.setattr(sys, "argv", ["run_euroc.py", settings, str(tmp_path / "data"),
                                      "--mode", "mono", "--out-tum", outs["jax"][0],
                                      "--out-kf", outs["jax"][1]])
    with jax.enable_x64(False):
        j_driver.main()
    slam, results, _ = t_driver.run(t_driver.parse_args(
        [settings, str(tmp_path / "data"), "--mode", "mono", "--out-tum", outs["port"][0],
         "--out-kf", outs["port"][1], "--device", "cpu"]))
    assert slam.cfg.sensor == t_cfg.MONOCULAR and slam._fast is not None
    states = [r.state for r in results]
    first = states.index(2)
    assert first <= 6 and all(s == 2 for s in states[first:]), states
    for who, (f_tum, f_kf) in outs.items():
        rows = np.loadtxt(f_tum)
        assert rows.ndim == 2 and rows.shape[1] == 8 and np.isfinite(rows).all(), who
        assert len(rows) >= N_MONO - 6, (who, len(rows))
        assert np.isfinite(np.loadtxt(f_kf)).all() and os.path.exists(
            f_tum.replace(".txt", "_euroc.txt")), who


N_INERTIAL = {"stereo-inertial": 12, "mono-inertial": 24}


@pytest.mark.parametrize("mode", ["stereo-inertial", "mono-inertial"])
def test_inertial_euroc_driver(tmp_path, monkeypatch, mode):
    """The port's ``run_euroc`` in an inertial mode on ``chip_smoke``'s
    EuRoC-shaped sequence (the phase 13 writer at 12 frames, both cameras
    at half EuRoC's size to keep the CPU's rendering short)."""
    import chip_smoke as cs
    import torch
    from orb_slam3_rgbl_tpu_torch import config as t_cfg
    from orb_slam3_rgbl_tpu_torch.examples import run_euroc as t_driver

    monkeypatch.setattr(cs, "EUROC_CAM1", {k: v / 2 if k not in ("width", "height") else v // 2
                                           for k, v in cs.EUROC_CAM1.items()})
    monkeypatch.setattr(cs, "EUROC_CAM2", {k: v / 2 for k, v in cs.EUROC_CAM2.items()})

    n = N_INERTIAL[mode]
    times, twc, _, imu_rows, _ = cs.euroc_motion(n)
    lefts, rights = cs.render_euroc(twc, torch.device("cpu"))
    stereo = mode == "stereo-inertial"
    mav, ts_file = cs.write_euroc(str(tmp_path), times, lefts, rights if stereo else None,
                                  imu_rows)
    settings = str(tmp_path / "euroc.yaml")
    cs.euroc_settings_yaml(settings, 1200 if stereo else 1000, stereo=stereo)
    slam, results, _ = t_driver.run(t_driver.parse_args(
        [settings, mav, "--mode", mode, "--timestamps", ts_file, "--device", "cpu",
         "--out-tum", str(tmp_path / "f.txt"), "--out-kf", str(tmp_path / "kf.txt")]))
    assert slam.cfg.sensor == (t_cfg.IMU_STEREO if stereo else t_cfg.IMU_MONOCULAR)
    assert (slam.rectifier is not None) == stereo
    states = [r.state for r in results]
    first = states.index(2)
    assert (first == 0) == stereo and all(s == 2 for s in states[first:]), states
    assert not slam.map.imu_initialized
    m = slam.map
    kfs = m.valid_kf_ids()
    assert kfs.size >= 2
    for a, b in zip(kfs[:-1], kfs[1:]):
        assert int(m.kf_prev_imu[b]) == int(a)
        assert abs(float(m.imu_preint[int(b)][0]) - (m.kf_timestamp[b] - m.kf_timestamp[a])) < 1e-4
    rows = np.loadtxt(str(tmp_path / "f.txt"))
    assert rows.shape[0] == n and np.isfinite(rows).all()


def test_imu_extrinsic_follows_the_rectification(tmp_path):
    """IMU_STEREO on a pair that needs rectifying: the body ← camera
    extrinsic the system works with is ``IMU.T_b_c1`` · T_r1_u1⁻¹
    (``Settings.cc``), T_r1_u1 the rotation of OpenCV's ``stereoRectify``
    (``CALIB_ZERO_DISPARITY``, ``alpha=-1``), computed here in numpy and
    OpenCV; 1e-9 (float64 throughout)."""
    import cv2

    import torch

    import chip_smoke as cs
    from orb_slam3_rgbl_tpu_torch import config as t_cfg
    from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
    from orb_slam3_rgbl_tpu_torch.slam import imu_frontend
    from orb_slam3_rgbl_tpu_torch.slam.system import System as TSystem

    settings = str(tmp_path / "euroc.yaml")
    cs.euroc_settings_yaml(settings, 1200, stereo=True)
    cfg = t_cfg.load_config(settings, sensor=t_cfg.IMU_STEREO)
    cam, st = cfg.camera, cfg.stereo
    K1 = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float64)
    K2 = np.array([[st.fx, 0, st.cx], [0, st.fy, st.cy], [0, 0, 1]], np.float64)
    D1 = np.array([cam.k1, cam.k2, cam.p1, cam.p2, cam.k3], np.float64)
    D2 = np.array([st.k1, st.k2, st.p1, st.p2, st.k3], np.float64)
    T21 = np.linalg.inv(np.asarray(st.T_c1_c2, np.float64).reshape(4, 4))
    size = (cam.width, cam.height)
    R1 = cv2.stereoRectify(K1, D1, K2, D2, size, T21[:3, :3], T21[:3, 3].reshape(3, 1),
                           flags=cv2.CALIB_ZERO_DISPARITY, alpha=-1, newImageSize=size)[0]
    T_r1_u1 = np.eye(4)
    T_r1_u1[:3, :3] = R1
    T_bc = np.asarray(cfg.imu.T_body_cam, np.float64).reshape(4, 4)
    expected = T_bc @ np.linalg.inv(T_r1_u1)

    sysm = TSystem(cfg, device="cpu")
    assert sysm.rectifier is not None
    got = np.asarray(sysm.cfg.imu.T_body_cam, np.float64).reshape(4, 4)
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-9)
    assert np.abs(got - T_bc).max() > 1e-4            # the rectification does rotate it
    # the tracker and the mapper take it from the config (a float32 SE3: 1e-6)
    T = imu_frontend.body_cam_extrinsics(sysm.cfg)[0]
    np.testing.assert_allclose(t_lie.quat_to_matrix(torch.as_tensor(T[:4])).numpy(),
                               expected[:3, :3], rtol=0, atol=1e-6)
    np.testing.assert_allclose(T[4:7], expected[:3, 3], rtol=0, atol=1e-6)
