"""Port vs JAX: the users' tools (``orb_slam3_rgbl_tpu_torch/tools``), the PNG
encoder and the leveled logger.

- ``io/png.write_png``: ``cv2.imread(..., IMREAD_UNCHANGED)`` of every file
  it writes equals the array (OpenCV's channel order: BGR, BGRA, gray-alpha
  as BGRA), for each of the five row filters and every kind; the port's
  ``read_png`` equals it too (tolerance 0: lossless).
- ``utils/logging``: tests/test_env.py::test_logger_levels_filter on the
  port; a port ``System`` prints its backward-timestamp message under
  ``NORMAL`` and nothing under the default ``QUIET``.
- ``tools/kitti_publisher``: tests/test_native_loader.py::TestKittiPublisher
  on the port, and its ``main`` end to end on a written 4-frame sequence on
  the CPU (published = tracked + dropped, one pose a frame in the file).
- ``tools/project_velodyne``: the JAX tool (OpenCV and JAX on the CPU) and
  the port's on one written 320×192 sequence, once per ``--method``: the
  PNGs are equal (tolerance 0; see the test for what would explain a
  one-unit difference).
- ``tools/train_vocabulary``: the tool's vocabulary equals
  ``train_vocabulary`` on the port's own descriptors of the same images
  (checksum exact); tests/test_torch_tools_vocab.py holds it against the JAX
  tool.
- ``tools/evaluate_ate``: both ``main``s on the same written trajectories,
  with and without ``--scale`` and ``--rpe-delta``: the same frame count, the
  numbers within 1e-5 (f32 SVDs of 3×3 matrices in two libraries).
tests/test_torch_tools_probes.py holds ``tools/pg_probe`` and
``tools/triage_ate``, tests/test_torch_tools_vocab.py the vocabulary tool
against the JAX one (each in a file of its own: the suite's workers take
whole files, and JAX's first compiles cost seconds)."""

import os
import sys

import numpy as np
import jax
import pytest
import torch

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from orb_slam3_rgbl_tpu_torch import synthetic as t_syn  # noqa: E402
from orb_slam3_rgbl_tpu_torch.io import png  # noqa: E402
from orb_slam3_rgbl_tpu_torch.slam.system import System  # noqa: E402
from orb_slam3_rgbl_tpu_torch.utils import logging as t_log  # noqa: E402

from test_torch_system import one_torch_thread  # noqa: E402,F401  (autouse)

N_SEQ = 6                  # frames of the written sequence (the vocabulary's images)
CPU = torch.device("cpu")
KINDS = {"gray8": ((19, 33), np.uint8), "gray16": ((19, 33), np.uint16),
         "gray_alpha8": ((19, 33, 2), np.uint8), "gray_alpha16": ((19, 33, 2), np.uint16),
         "rgb8": ((19, 33, 3), np.uint8), "rgb16": ((19, 33, 3), np.uint16),
         "rgba8": ((19, 33, 4), np.uint8), "rgba16": ((19, 33, 4), np.uint16)}


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """A KITTI sequence written by chip_smoke's helpers at 320×192: RGB PNGs
    through all five filters, 12,288-point clouds, times, calib, settings."""
    root = tmp_path_factory.mktemp("tools_seq")
    cfg = t_syn.synthetic_rgbl_config()
    traj, frames = chip_smoke.render_drive(cfg, N_SEQ, CPU, n_az=256, n_el=48)
    seq = str(root / "seq")
    chip_smoke.write_sequence(seq, cfg, frames, chip_smoke.dense_depths(cfg, frames, CPU),
                              [i * 0.1 for i in range(N_SEQ)])
    settings = str(root / "settings.yaml")
    chip_smoke.settings_yaml(cfg, settings)
    return seq, settings, traj, cfg


# ---- io/png.write_png ---------------------------------------------------------
def _as_opencv(a: np.ndarray) -> np.ndarray:
    """The samples as ``cv2.IMREAD_UNCHANGED`` gives them."""
    if a.ndim == 2:
        return a
    if a.shape[2] == 2:
        return np.stack([a[..., 0]] * 3 + [a[..., 1]], axis=-1)
    return np.concatenate([a[..., 2::-1], a[..., 3:]], axis=-1)


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_write_png_read_back_by_opencv(tmp_path, filt):
    rng = np.random.default_rng(filt)
    for kind, (shape, dtype) in KINDS.items():
        a = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
        path = str(tmp_path / f"{kind}.png")
        png.write_png(path, a, (filt,))
        assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), _as_opencv(a)), kind
        stored = png.read_png(path)
        assert stored.dtype == dtype and np.array_equal(stored, a), kind
        assert png.image_size(path) == shape[:2]
    assert chip_smoke.write_png is png.write_png
    with pytest.raises(ValueError, match="cannot write"):
        png.write_png(str(tmp_path / "f.png"), np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="row filters"):
        png.write_png(str(tmp_path / "g.png"), np.zeros((4, 4), np.uint8), (5,))


# ---- utils/logging --------------------------------------------------------------
def test_logger_levels_filter():
    import io

    buf = io.StringIO()
    assert t_log._level == t_log.QUIET                   # the reference's startup level
    try:
        t_log.set_level(t_log.NORMAL)
        t_log.log("visible", t_log.NORMAL, file=buf)
        t_log.log("hidden", t_log.DEBUG, file=buf)
        t_log.set_level(t_log.QUIET)
        t_log.log("also hidden", t_log.NORMAL, file=buf)
    finally:
        t_log.set_level(t_log.QUIET)
    out = buf.getvalue()
    assert "visible" in out and "hidden" not in out
    assert (t_log.QUIET, t_log.NORMAL, t_log.VERBOSE, t_log.VERY_VERBOSE, t_log.DEBUG) \
        == (0, 1, 2, 3, 4)


def test_system_timestamp_message_follows_the_level(capsys):
    cfg = t_syn.synthetic_rgbl_config()
    cam = cfg.camera
    world = t_syn.make_world(0, tex_size=256, device="cpu")
    Twc = t_syn.straight_trajectory(1)[0]
    img = t_syn.render_image(world, Twc, cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width)
    pts = t_syn.lidar_scan(world, Twc, n_az=256, n_el=48)
    printed = {}
    try:
        for level in (t_log.QUIET, t_log.NORMAL):
            t_log.set_level(level)
            sysm = System(cfg, enable_mapping=False, device="cpu")
            sysm.track_rgbl(img, pts, 1.0)
            capsys.readouterr()
            sysm.track_rgbl(img, pts, 0.5)                   # backward: a new map
            printed[level] = capsys.readouterr().err
    finally:
        t_log.set_level(t_log.QUIET)
    assert printed[t_log.QUIET] == ""
    assert "timestamp older than previous frame" in printed[t_log.NORMAL]


# ---- tools/kitti_publisher ---------------------------------------------------------
class SpyNode:
    def __init__(self):
        self.rgb, self.cloud = [], []

    def feed_rgb(self, t, gray):
        self.rgb.append((t, gray.shape))

    def feed_cloud(self, t, cloud):
        self.cloud.append((t, cloud.shape))


def test_publisher_replays_sequence_into_node(tmp_path):
    from test_native_loader import make_fake_sequence
    from orb_slam3_rgbl_tpu_torch.tools.kitti_publisher import publish

    seq_dir, imgs, clouds = make_fake_sequence(tmp_path, n_frames=4)
    node = SpyNode()
    n = publish(str(seq_dir), node, rate=0.0, log=lambda *a: None)
    assert n == 4
    assert len(node.rgb) == 4 and len(node.cloud) == 4
    assert node.rgb[0][1] == (48, 64)
    assert [t for t, _ in node.rgb] == [t for t, _ in node.cloud] == [0.0, 0.1, 0.2, 0.3]


def test_publisher_main_end_to_end(sequence, tmp_path, monkeypatch):
    from orb_slam3_rgbl_tpu_torch.tools import kitti_publisher

    seq, settings, *_ = sequence
    monkeypatch.setattr(System, "CLOUD_CAP", 16384)
    out = str(tmp_path / "traj.txt")
    counts = kitti_publisher.run(kitti_publisher.parse_args(
        [settings, seq, "--rate", "0", "--frames", "4", "--out", out, "--device", "cpu"]))
    assert counts["published"] == 4
    assert counts["published"] == counts["tracked"] + counts["dropped"]
    rows = np.loadtxt(out, ndmin=2)
    assert rows.shape == (counts["tracked"], 12) and np.isfinite(rows).all()


# ---- tools/project_velodyne ------------------------------------------------------
@pytest.mark.parametrize("method", ["None", "InverseDilation", "AverageFiltering"])
def test_project_velodyne_matches_jax(sequence, monkeypatch, method):
    from tools import project_velodyne as j_tool
    from orb_slam3_rgbl_tpu_torch.tools import project_velodyne as t_tool

    seq = sequence[0]
    monkeypatch.setattr(sys, "argv", ["project_velodyne.py", seq, "--out-dir", f"j_{method}",
                                      "--method", method, "--frames", "3"])
    with jax.enable_x64(False):
        j_tool.main()
    paths = t_tool.run(t_tool.parse_args([seq, "--out-dir", f"t_{method}", "--method", method,
                                          "--frames", "3", "--device", "cpu"]))
    assert len(paths) == 3
    for p in paths:
        got = png.read_png(p)
        want = cv2.imread(os.path.join(seq, f"j_{method}", os.path.basename(p)),
                          cv2.IMREAD_UNCHANGED)
        assert got.dtype == want.dtype == np.uint16 and got.shape == (192, 320)
        assert (got > 0).mean() > 0.05
        # equal to the unit: the projection is an f32 product in each library,
        # and a product rounded the other way could flip one 1/256 m unit
        # where depth × 256 lands within an ulp of an integer (none does here)
        assert np.array_equal(got, want), (np.mean(got != want),
                                           np.abs(got.astype(int) - want).max())


# ---- tools/train_vocabulary -------------------------------------------------------
def test_train_vocabulary_tool_equals_trainer_on_port_descriptors(sequence, tmp_path):
    from orb_slam3_rgbl_tpu_torch.retrieval import tree_vocab
    from orb_slam3_rgbl_tpu_torch.slam import frame as frame_mod
    from orb_slam3_rgbl_tpu_torch.tools import train_vocabulary as tool

    images = os.path.join(sequence[0], "image_2")
    out = str(tmp_path / "vocab.npz")
    voc = tool.run(tool.parse_args([images, "--out", out, "--k", "4", "--depth", "2",
                                    "--n-features", "600", "--device", "cpu"]))
    docs = []
    for name in sorted(os.listdir(images)):
        img = torch.as_tensor(png.load_gray(os.path.join(images, name)), dtype=torch.float32)
        f = frame_mod.extract_features(img, 192, 320, n_features=600, device="cpu")
        docs.append(f.desc.numpy()[f.valid.numpy()].view(np.uint32))
    ref = tree_vocab.train_vocabulary(np.concatenate(docs), k=4, depth=2, idf_docs=docs,
                                      device="cpu")
    assert len(docs) == N_SEQ
    assert voc.checksum() == ref.checksum()
    assert torch.equal(voc.idf, ref.idf)
    loaded = tree_vocab.TreeVocabulary.load(out, device="cpu")
    assert loaded.checksum() == voc.checksum()
    with pytest.raises(SystemExit, match="no PNG images"):
        tool.run(tool.parse_args([str(tmp_path), "--device", "cpu"]))


# ---- tools/evaluate_ate ------------------------------------------------------------
def _numbers(text: str) -> dict:
    return {k.strip(): float(v) for k, v in (line.split(":", 1) for line in
                                             text.strip().splitlines())}


@pytest.mark.parametrize("flags", [[], ["--scale"], ["--rpe-delta", "3"],
                                   ["--scale", "--rpe-delta", "5"]])
def test_evaluate_ate_matches_jax(tmp_path, monkeypatch, capsys, flags):
    sys.path.insert(0, os.path.join(REPO, "evaluation"))
    import evaluate_ate as j_tool
    from orb_slam3_rgbl_tpu_torch.io import trajectory
    from orb_slam3_rgbl_tpu_torch.tools import evaluate_ate as t_tool

    rng = np.random.default_rng(7)
    gt = t_syn.straight_trajectory(30, step=0.6, weave=0.4)
    est = gt.copy()
    est[:, 4:7] = 1.03 * est[:, 4:7] + rng.normal(0, 0.05, (30, 3)) + [0.2, -0.1, 0.3]
    g, e = str(tmp_path / "gt.txt"), str(tmp_path / "est.txt")
    trajectory.save_kitti(g, gt)
    trajectory.save_kitti(e, est[:28])                  # the shorter one sets the count
    monkeypatch.setattr(sys, "argv", ["evaluate_ate.py", g, e] + flags)
    with jax.enable_x64(False):
        j_tool.main()
    want = _numbers(capsys.readouterr().out)
    t_tool.main([g, e, "--device", "cpu"] + flags)
    got = _numbers(capsys.readouterr().out)
    assert list(got) == list(want) and got["frames"] == want["frames"] == 28
    for k in got:
        assert abs(got[k] - want[k]) < 1e-5, (k, got[k], want[k])
