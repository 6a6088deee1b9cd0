"""The port's prefetching KITTI loader (``io/native_loader.NativeKittiSequence``)
against the JAX package's native loader tests and the port's own
``KittiSequence``.

The three ``TestNativeLoader`` cases of tests/test_native_loader.py run on
the port (same fake sequence, same checks): in-order prefetch, truncation
that keeps the near points, and — in place of the JAX "python fallback"
case, since the port has no fallback — every frame equal bit for bit to
``KittiSequence.frame(i)`` of both packages (tolerance 0: the same decoder,
and the JAX loader's ``cv2.imread`` equals it, tests/test_torch_kitti_io.py).
Then what the port adds: a corrupt PNG and a dead worker raise naming the
file, with no hang; ``close()`` halfway ends every worker process; the
port's RGB-L driver, which always loads through ``NativeKittiSequence``,
writes the same trajectory to the byte as its ``System`` fed
``KittiSequence.frame(i)`` in process (one decoder, so the same inputs)."""

import os
from signal import SIGKILL
import sys
import threading

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from orb_slam3_rgbl_tpu.io.kitti import KittiSequence as JKittiSequence  # noqa: E402
from orb_slam3_rgbl_tpu_torch.io.kitti import KittiSequence  # noqa: E402
from orb_slam3_rgbl_tpu_torch.io.native_loader import NativeKittiSequence  # noqa: E402
from orb_slam3_rgbl_tpu_torch.slam.system import System  # noqa: E402

from test_native_loader import make_fake_sequence  # noqa: E402
from test_torch_system import one_torch_thread  # noqa: E402,F401  (autouse)

NO_HANG_S = 60           # a read that takes longer than this has hung
N_DRIVE = 8              # frames of the driver comparison (320×192)


def _bounded(fn, *args):
    """``fn(*args)`` on a daemon thread, failing the test if it hangs (the
    hung thread is left behind and does not hold up the process's exit)."""
    box = {}

    def call():
        try:
            box["value"] = fn(*args)
        except BaseException as exc:
            box["error"] = exc

    thread = threading.Thread(target=call, daemon=True)
    thread.start()
    thread.join(NO_HANG_S)
    if thread.is_alive():
        raise TimeoutError(f"{fn.__name__} hung for {NO_HANG_S} s")
    if "error" in box:
        raise box["error"]
    return box["value"]


class TestNativeLoader:
    def test_in_order_prefetch(self, tmp_path):
        seq_dir, imgs, clouds = make_fake_sequence(tmp_path)
        with NativeKittiSequence(seq_dir, max_points=1024, n_threads=2) as loader:
            assert len(loader) == 6
            assert loader.height == 48 and loader.width == 64
            for i in range(6):
                out = loader.next_frame()
                assert out is not None, i
                img, cloud, mask, t = out
                np.testing.assert_array_equal(img, imgs[i].astype(np.float32))
                assert abs(t - i * 0.1) < 1e-9
                assert mask.sum() == 500
                np.testing.assert_array_equal(cloud[:500], clouds[i])
                assert (cloud[500:] == 0).all()
                # never more than queue_depth frames asked ahead of the consumer
                assert loader._asked - loader._next <= loader.queue_depth
            assert loader.next_frame() is None

    def test_truncation_keeps_near_points(self, tmp_path):
        seq_dir, imgs, clouds = make_fake_sequence(tmp_path, n_frames=1, n_pts=800)
        with NativeKittiSequence(seq_dir, max_points=100) as loader:
            img, cloud, mask, t = loader.next_frame()
        assert mask.sum() == 100
        d2_kept = np.einsum("ij,ij->i", cloud[:100, :3], cloud[:100, :3])
        d2_all = np.sort(np.einsum("ij,ij->i", clouds[0][:, :3], clouds[0][:, :3]))
        assert d2_kept.max() <= d2_all[100] + 1e-4

    @pytest.mark.parametrize("max_points", [1024, 300])   # padded, truncated
    def test_frames_equal_kitti_sequence(self, tmp_path, max_points):
        seq_dir, *_ = make_fake_sequence(tmp_path, n_frames=5)
        port = KittiSequence(seq_dir, max_points=max_points)
        jax_seq = JKittiSequence(seq_dir, max_points=max_points)
        with NativeKittiSequence(seq_dir, max_points=max_points, queue_depth=2,
                                 n_threads=3) as loader:
            for i in range(5):
                got = loader.next_frame()
                for want in (port.frame(i), jax_seq.frame(i)):
                    for a, b in zip(got[:3], want[:3]):
                        assert a.dtype == b.dtype and np.array_equal(a, b), i
                    assert got[3] == want[3]
            assert loader.next_frame() is None


def test_corrupt_png_raises_naming_the_file(tmp_path):
    seq_dir, *_ = make_fake_sequence(tmp_path, n_frames=4)
    bad = os.path.join(seq_dir, "image_2", "000002.png")
    data = bytearray(open(bad, "rb").read())
    data[40] ^= 0xFF                                      # a chunk after IHDR: its CRC fails
    open(bad, "wb").write(bytes(data))
    loader = NativeKittiSequence(seq_dir, max_points=1024)
    workers = list(loader._workers)
    for _ in range(2):
        assert _bounded(loader.next_frame) is not None
    with pytest.raises(ValueError, match="000002.png"):
        _bounded(loader.next_frame)
    assert all(w.returncode is not None for w in workers)   # the error closed the loader


def test_dead_worker_raises_naming_the_file(tmp_path):
    seq_dir, *_ = make_fake_sequence(tmp_path, n_frames=8)
    loader = NativeKittiSequence(seq_dir, max_points=1024, n_threads=2, queue_depth=2)
    victim = loader._workers[1]                               # frames 1, 3, 5, 7
    os.kill(victim.pid, SIGKILL)
    victim.wait(timeout=NO_HANG_S)
    # frame 1 may have reached the pipe before the kill; frame 3 is asked
    # for only after frame 1 is taken, so the dead worker never sends it
    taken = 0
    with pytest.raises(RuntimeError, match=r"00000[13]\.png") as info:
        for _ in range(8):
            assert _bounded(loader.next_frame) is not None
            taken += 1
    assert taken in (1, 3) and f"frame {taken} " in str(info.value)
    loader.close()


def test_worker_writing_much_to_stderr_does_not_hang(tmp_path, monkeypatch):
    # PYTHONVERBOSE=2 makes each worker write ~300 KB to stderr as it
    # imports, several times a pipe's buffer: a worker whose stderr nobody
    # reads would block there and the frame would never come
    monkeypatch.setenv("PYTHONVERBOSE", "2")
    seq_dir, *_ = make_fake_sequence(tmp_path, n_frames=4)
    plain = KittiSequence(seq_dir, max_points=1024)
    with NativeKittiSequence(seq_dir, max_points=1024) as loader:
        for i in range(4):
            got = _bounded(loader.next_frame)
            assert np.array_equal(got[0], plain.frame(i)[0])


def test_close_halfway_ends_every_worker(tmp_path):
    seq_dir, *_ = make_fake_sequence(tmp_path, n_frames=6)
    loader = NativeKittiSequence(seq_dir, max_points=1024, n_threads=3)
    workers = list(loader._workers)
    assert len(workers) == 3
    _bounded(loader.next_frame)
    _bounded(loader.next_frame)
    loader.close()
    assert all(w.returncode is not None for w in workers)
    for w in workers:                                         # reaped: no such process left
        with pytest.raises(ProcessLookupError):
            os.kill(w.pid, 0)
    with pytest.raises(RuntimeError, match="after close"):
        loader.next_frame()
    loader.close()                                            # idempotent


def test_rgbl_driver_same_trajectory_with_native_loader(tmp_path, monkeypatch):
    import chip_smoke
    from orb_slam3_rgbl_tpu_torch import synthetic
    from orb_slam3_rgbl_tpu_torch.config import RGBL, load_config
    from orb_slam3_rgbl_tpu_torch.examples import run_kitti_rgbl

    cpu = torch.device("cpu")
    cfg = synthetic.synthetic_rgbl_config()
    traj, frames = chip_smoke.render_drive(cfg, N_DRIVE, cpu, n_az=256, n_el=48)
    seq = str(tmp_path / "seq")
    chip_smoke.write_sequence(seq, cfg, frames, chip_smoke.dense_depths(cfg, frames, cpu),
                              [i * 0.1 for i in range(N_DRIVE)])
    settings = str(tmp_path / "settings.yaml")
    chip_smoke.settings_yaml(cfg, settings)
    monkeypatch.setattr(System, "CLOUD_CAP", 16384)
    # the driver (``--native-loader`` is accepted and changes nothing) ...
    out = str(tmp_path / "driver.txt")
    slam, results, _ = run_kitti_rgbl.run(run_kitti_rgbl.parse_args(
        [settings, seq, "--out", out, "--device", "cpu", "--native-loader"]))
    assert all(r.state == 2 for r in results) and len(results) == N_DRIVE
    assert len(slam.timer.samples["load"]) == N_DRIVE
    # ... against the same System fed KittiSequence's frames in process
    ref = System(load_config(settings, sensor=RGBL), device="cpu")
    plain = KittiSequence(seq)
    for i in range(N_DRIVE):
        img, pcd, mask, t = plain.frame(i)
        ref.track_rgbl(img, pcd, t, cloud_mask=mask)
    ref.shutdown()
    ref_out = str(tmp_path / "in_process.txt")
    ref.save_trajectory_kitti(ref_out)
    assert open(out).read() == open(ref_out).read()
