"""Port vs JAX: the KITTI loader and the RGB-L driver chain.

The port decodes PNG itself (``io/png.py``): the machine with the card has
no OpenCV. Its images are held to ``cv2.imread`` exactly — 8- and 16-bit
gray, gray-alpha, RGB and RGBA, every row filter (the files written by
``io/png.write_png``, one filter a file and all five mixed), and files
that OpenCV itself wrote. ``KittiSequence.frame`` is held to the JAX
loader's exactly on a sequence the test writes: RGB images, clouds padded
and truncated, their masks, times and calibration.

The driver chain of tests/test_kitti_driver_e2e.py (22 frames at 320×192, a
legacy flat-key settings file, ``load_config`` → ``KittiSequence`` →
``System`` → ``CameraTrajectory.txt``) runs through both packages' drivers,
each System with 16384-point clouds as that test sets them: the two
trajectories agree within 5 mm (test_torch_step.py's bar for a drive) and
each stays under that test's ATE bound of 0.25 m."""

import os
import sys
import zlib

import numpy as np
import jax
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from orb_slam3_rgbl_tpu.geometry.align import ate_rmse  # noqa: E402
from orb_slam3_rgbl_tpu.io import kitti as j_kitti  # noqa: E402
from orb_slam3_rgbl_tpu.slam.system import System as JSystem  # noqa: E402
from orb_slam3_rgbl_tpu_torch.io import kitti as t_kitti, png  # noqa: E402
from orb_slam3_rgbl_tpu_torch.io.png import write_png  # noqa: E402
from orb_slam3_rgbl_tpu_torch.slam.system import System as TSystem  # noqa: E402

from test_kitti_driver_e2e import N_FRAMES, kitti_fixture  # noqa: E402,F401
from test_torch_system import one_torch_thread  # noqa: E402,F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ_TOL_M = 5e-3
MAX_ATE_M = 0.25          # tests/test_kitti_driver_e2e.py's bound
CLOUD_CAP = 16384         # that test's cloud capacity

KINDS = {"gray8": ((23, 41), np.uint8), "gray16": ((23, 41), np.uint16),
         "gray_alpha8": ((23, 41, 2), np.uint8), "gray_alpha16": ((23, 41, 2), np.uint16),
         "rgb8": ((23, 41, 3), np.uint8), "rgb16": ((23, 41, 3), np.uint16),
         "rgba8": ((23, 41, 4), np.uint8), "rgba16": ((23, 41, 4), np.uint16)}
FILTERS = {"none": (0,), "sub": (1,), "up": (2,), "average": (3,), "paeth": (4,),
           "mixed": (0, 1, 2, 3, 4, 4, 3, 2, 1)}


@pytest.mark.parametrize("filters", list(FILTERS))
@pytest.mark.parametrize("kind", list(KINDS))
def test_decoder_matches_opencv(tmp_path, kind, filters):
    shape, dtype = KINDS[kind]
    rng = np.random.default_rng(len(kind) * 7 + len(filters))
    a = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    if kind.startswith("rgb"):
        a[:4, :, :3] = a[:4, :, :1]       # R = G = B rows pass through unchanged
    path = str(tmp_path / "x.png")
    write_png(path, a, FILTERS[filters])
    stored = png.read_png(path)
    assert stored.dtype == dtype and np.array_equal(stored, a)
    gray = png.load_gray(path)
    assert gray.dtype == np.uint8 and np.array_equal(gray, cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    if a.ndim == 2:                       # depth maps: read as stored
        assert np.array_equal(stored, cv2.imread(path, cv2.IMREAD_UNCHANGED))


def test_decoder_reads_opencv_files_and_refuses_what_it_cannot(tmp_path):
    rng = np.random.default_rng(3)
    smooth = cv2.GaussianBlur(rng.integers(0, 256, (60, 90, 3), dtype=np.uint8), (7, 7), 2)
    for name, img in (("bgr.png", smooth), ("gray.png", smooth[..., 0]),
                      ("depth.png", (smooth[..., 0].astype(np.uint16) * 251))):
        path = str(tmp_path / name)
        cv2.imwrite(path, img)                # libpng's adaptive row filters
        assert np.array_equal(png.load_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))
        if img.ndim == 2:
            assert np.array_equal(png.read_png(path), img)
    # RGB → gray by libpng's weights, bit for bit
    a = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
    write_png(str(tmp_path / "rgb.png"), a)
    r, g, b = (a[..., i].astype(np.int64) for i in range(3))
    assert np.array_equal(png.load_gray(str(tmp_path / "rgb.png")),
                          (9797 * r + 19234 * g + 3737 * b) >> 15)
    # interlaced and palette files are refused, naming the file (the IHDR
    # chunk's bytes 12..29, its CRC after them)
    good = open(str(tmp_path / "rgb.png"), "rb").read()
    for what, offset, value in (("interlaced", 28, 1), ("palette", 25, 3)):
        bad = bytearray(good)
        bad[offset] = value
        bad[29:33] = zlib.crc32(bytes(bad[12:29])).to_bytes(4, "big")
        path = str(tmp_path / f"{what}.png")
        open(path, "wb").write(bytes(bad))
        with pytest.raises(ValueError, match=f"{what}.png"):
            png.load_gray(path)
    with pytest.raises(FileNotFoundError):
        t_kitti.load_image_gray(str(tmp_path / "missing.png"))


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """A KITTI-layout sequence: 3 RGB frames, clouds of 100, 300 and 700
    points, times and calibration."""
    seq = tmp_path_factory.mktemp("seq")
    (seq / "image_2").mkdir()
    (seq / "velodyne").mkdir()
    rng = np.random.default_rng(11)
    for i, n in enumerate((100, 300, 700)):
        img = cv2.GaussianBlur(rng.integers(0, 256, (48, 80, 3), dtype=np.uint8), (5, 5), 1)
        cv2.imwrite(str(seq / "image_2" / f"{i:06d}.png"), img)
        rng.normal(0, 20, (n, 4)).astype(np.float32).tofile(str(seq / "velodyne" / f"{i:06d}.bin"))
    np.savetxt(str(seq / "times.txt"), np.array([0.0, 0.103562, 0.207124]))
    with open(seq / "calib.txt", "w") as f:
        for k in range(4):
            f.write(f"P{k}: " + " ".join(str(v) for v in rng.normal(size=12)) + "\n")
        f.write("Tr: " + " ".join(str(v) for v in rng.normal(size=12)) + "\n")
    return str(seq)


@pytest.mark.parametrize("max_points", [None, 256, 1024])
def test_kitti_sequence_matches_jax(sequence, max_points):
    kw = {} if max_points is None else {"max_points": max_points}
    s_t, s_j = t_kitti.KittiSequence(sequence, **kw), j_kitti.KittiSequence(sequence, **kw)
    assert len(s_t) == len(s_j) == 3 and s_t.images == s_j.images and s_t.clouds == s_j.clouds
    np.testing.assert_array_equal(s_t.times, s_j.times)
    assert s_t.calib.keys() == s_j.calib.keys() == {"P0", "P1", "P2", "P3", "Tr"}
    for k in s_j.calib:
        np.testing.assert_array_equal(s_t.calib[k], s_j.calib[k])
    for i in range(3):
        (img_t, pcd_t, m_t, t_t), (img_j, pcd_j, m_j, t_j) = s_t.frame(i), s_j.frame(i)
        assert pcd_t.shape == (max_points or 131072, 4)      # padded, or the nearest kept
        assert img_t.dtype == img_j.dtype == np.float32 and np.array_equal(img_t, img_j)
        assert np.array_equal(pcd_t, pcd_j) and np.array_equal(m_t, m_j) and t_t == t_j
    raw, mask = t_kitti.load_pointcloud(s_t.clouds[2])
    assert raw.shape == (700, 4) and mask.all()


def _driver_poses(path):
    rows = np.loadtxt(path)
    assert rows.shape == (N_FRAMES, 12) and np.isfinite(rows).all()
    return rows.reshape(-1, 3, 4)[:, :, 3]


def test_rgbl_driver_chain_matches_jax(kitti_fixture, tmp_path, monkeypatch):  # noqa: F811
    from examples import run_kitti_rgbl as j_driver
    from orb_slam3_rgbl_tpu_torch.examples import run_kitti_rgbl as t_driver

    seq_dir, yaml_path, traj = kitti_fixture
    monkeypatch.setattr(JSystem, "CLOUD_CAP", CLOUD_CAP)
    monkeypatch.setattr(TSystem, "CLOUD_CAP", CLOUD_CAP)
    out_j, out_t = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    stats_t = str(tmp_path / "stats.txt")
    monkeypatch.setattr(sys, "argv", ["run_kitti_rgbl.py", yaml_path, seq_dir, "--out", out_j])
    with jax.enable_x64(False):           # as outside the test suite (see test_torch_frame)
        j_driver.main()
    slam, results, times = t_driver.run(t_driver.parse_args(
        [yaml_path, seq_dir, "--out", out_t, "--stats", stats_t, "--device", "cpu"]))
    assert slam.device == torch.device("cpu") and len(results) == len(times) == N_FRAMES
    assert all(r.state == 2 for r in results)
    assert slam._fast is not None and slam._fast.prev_lm_ids is not None   # the fused path ran
    c_j, c_t = _driver_poses(out_j), _driver_poses(out_t)
    assert np.abs(c_t - c_j).max() < TRAJ_TOL_M, np.abs(c_t - c_j).max()
    gt = traj[:, 4:7] - traj[0, 4:7]
    for c in (c_j, c_t):
        assert float(ate_rmse(c, gt)) < MAX_ATE_M, float(ate_rmse(c, gt))
    # the stage timer: the fused frames' stages and the mapping job's
    stages = open(stats_t).read()
    for name in ("pose_pred", "lm_track", "new_kf", "kf_insert", "lba", "pr", "track_total"):
        assert name in stages, name
