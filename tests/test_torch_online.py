"""Port vs JAX: the online node (``io/online.py``).

``ApproximateTimeSync`` is plain Python on both sides: on the same seeded,
jittered pair of streams the two give the same pairs and the same drops
(tolerance 0). ``OnlineSlamNode`` around a spy ``System`` makes the same
calls in every mode — kind, stamp, image shapes and IMU windows, the port's
cast to float32 for the comparison (the JAX node casts them; the port keeps
float64, a departure: EuRoC's ~1.4e9 s stamps are 128 s coarse in float32).
What the port adds: a worker exception is raised by ``stop()`` (and by
later feeds) where the JAX worker dies silently; ``stop()`` returns only
once every queued frame is tracked. A real port ``System`` (CPU, 320×192,
RGB-D) driven through the node gives the same poses to the bit as direct
``track_rgbd`` calls: the node only moves the calls to its thread."""

import dataclasses
import threading
import time

import numpy as np
import pytest

from orb_slam3_rgbl_tpu.io import online as j_online
from orb_slam3_rgbl_tpu_torch import synthetic as t_syn
from orb_slam3_rgbl_tpu_torch.config import RGBD
from orb_slam3_rgbl_tpu_torch.io import online as t_online
from orb_slam3_rgbl_tpu_torch.slam.system import System

from test_torch_system import one_torch_thread  # noqa: F401  (autouse)

EUROC_T0 = 1403636579.763555   # a EuRoC MH01 stamp (s): float32 rounds it by 128 s
N_REAL = 8                     # frames of the real System's drive


def _streams(seed: int, n: int = 60):
    """Two jittered 10 Hz streams, b late by up to 15 ms, some of its
    messages missing, a few spurious ones; pushed in time order."""
    rng = np.random.default_rng(seed)
    a = [(EUROC_T0 + 0.1 * i + rng.uniform(-0.005, 0.005), f"a{i}") for i in range(n)]
    b = [(t + rng.uniform(0.0, 0.015), f"b{i}") for i, (t, _) in enumerate(a)
         if rng.random() > 0.15]
    b += [(EUROC_T0 + rng.uniform(0, 0.1 * n), f"x{k}") for k in range(5)]
    return sorted([("a",) + m for m in a] + [("b",) + m for m in b], key=lambda m: m[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_approximate_time_sync_matches_jax(seed):
    outs = []
    for mod in (j_online, t_online):
        sync = mod.ApproximateTimeSync(slop=0.02, queue_size=10)
        outs.append([(sync.push_a if side == "a" else sync.push_b)(t, p)
                     for side, t, p in _streams(seed)])
    assert outs[0] == outs[1]
    assert sum(o is not None for o in outs[1]) > 30          # most frames pair


class SpySystem:
    """Records each track call; ``fail_on`` raises on that call; ``delay``
    sleeps in each."""

    def __init__(self, fail_on=None, delay=0.0):
        self.calls, self.fail_on, self.delay = [], fail_on, delay

    def _call(self, kind, t, images, imu=None):
        time.sleep(self.delay)
        self.calls.append((kind, t, [np.shape(x) for x in images], imu))
        if len(self.calls) == self.fail_on:
            raise RuntimeError("track failed on purpose")
        return len(self.calls)

    def track_monocular(self, gray, t, imu=None):
        return self._call("mono", t, [gray], imu)

    def track_rgbd(self, gray, depth, t, imu=None):
        return self._call("rgbd", t, [gray, depth], imu)

    def track_rgbl(self, gray, cloud, t):
        return self._call("rgbl", t, [gray, cloud])

    def track_stereo(self, gray_l, gray_r, t, imu=None):
        return self._call("stereo", t, [gray_l, gray_r], imu)


def _feed(node, mode: str, n: int = 12):
    """``n`` frames with 200 Hz IMU samples fed before each frame, the
    second stream (if any) 3 ms late."""
    rng = np.random.default_rng(5)
    second = {"rgbd": node.feed_depth, "rgbl": node.feed_cloud, "stereo": node.feed_right}
    for i in range(n):
        t = EUROC_T0 + 0.05 * i
        for k in range(10):
            node.feed_imu(t - 0.05 + 0.005 * (k + 1), rng.normal(size=3), rng.normal(size=3))
        node.feed_rgb(t, np.zeros((6, 8), np.float32))
        if mode in second:
            shape = (100, 4) if mode == "rgbl" else (6, 8)
            second[mode](t + 0.003, np.zeros(shape, np.float32))


@pytest.mark.parametrize("mode", ["rgbd", "rgbl", "stereo", "mono"])
def test_node_call_sequence_matches_jax(mode):
    calls = {}
    for mod in (j_online, t_online):
        spy = SpySystem()
        poses = []
        node = mod.OnlineSlamNode(spy, mode=mode, on_pose=lambda t, r: poses.append((t, r)),
                                  max_queue=64)
        _feed(node, mode)
        node.stop()
        assert [r for _, r in poses] == list(range(1, 13)) and node.dropped_frames == 0
        calls[mod] = spy.calls
    for (kj, tj, sj, ij), (kt, tt, st, it) in zip(calls[j_online], calls[t_online]):
        assert (kj, tj, sj) == (kt, tt, st)
        if ij is None:
            assert it is None
        else:
            assert it.dtype == np.float64 and ij.dtype == np.float32
            assert np.array_equal(it.astype(np.float32), ij)
    assert len(calls[j_online]) == len(calls[t_online]) == 12
    if mode != "rgbl":
        # the port's window keeps the stamps as fed: float64, EuRoC-sized
        window = calls[t_online][3][3]
        t3 = EUROC_T0 + 0.15
        expect = [t3 - 0.05 + 0.005 * (k + 1) for k in range(10)]
        assert window.shape == (10, 7) and np.array_equal(window[:, 0], expect)
        assert np.abs(window[:, 0].astype(np.float32) - window[:, 0]).max() > 1.0


def test_worker_exception_is_raised_by_stop():
    spy = SpySystem(fail_on=2)
    node = t_online.OnlineSlamNode(spy, mode="mono", max_queue=8)
    for i in range(2):
        node.feed_rgb(0.1 * i, np.zeros((4, 4), np.float32))
    deadline = time.monotonic() + 30
    while node.error is None and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="worker failed") as info:
        node.feed_rgb(0.3, np.zeros((4, 4), np.float32))
    assert isinstance(info.value.__cause__, RuntimeError)
    with pytest.raises(RuntimeError, match="worker failed") as info:
        node.stop()
    assert str(info.value.__cause__) == "track failed on purpose"
    assert not node._thread.is_alive()


def test_stop_waits_for_every_queued_frame():
    spy = SpySystem(delay=0.2)
    node = t_online.OnlineSlamNode(spy, mode="mono", max_queue=8)
    for i in range(3):
        node.feed_rgb(0.1 * i, np.zeros((4, 4), np.float32))
    with pytest.raises(TimeoutError):
        node.stop(timeout=0.05)        # still tracking: said, not returned early
    node.stop()
    assert len(spy.calls) == 3 and not node._thread.is_alive()
    with pytest.raises(RuntimeError, match="after stop"):
        node.feed_rgb(1.0, np.zeros((4, 4), np.float32))


def test_real_system_through_node_matches_direct_calls():
    cfg = dataclasses.replace(t_syn.synthetic_rgbl_config(), sensor=RGBD, loop_closing=False)
    cam = cfg.camera
    world = t_syn.make_world(0, tex_size=256, device="cpu")
    traj = t_syn.straight_trajectory(N_REAL, step=0.6, weave=0.4)
    frames = []
    for Twc in traj:
        args = (world, Twc, cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width)
        frames.append((t_syn.render_image(*args).numpy(), t_syn.render_depth(*args).numpy()))

    direct = System(cfg, device="cpu")
    want = [direct.track_rgbd(img, dep, 0.1 * i) for i, (img, dep) in enumerate(frames)]
    sysm = System(cfg, device="cpu")
    got, threads = [], set()

    def on_pose(t, res):
        got.append(res)
        threads.add(threading.get_ident())

    node = t_online.OnlineSlamNode(sysm, mode="rgbd", on_pose=on_pose, max_queue=N_REAL)
    for i, (img, dep) in enumerate(frames):
        node.feed_rgb(0.1 * i, img)
        node.feed_depth(0.1 * i, dep)
    node.stop()
    assert threads == {node._thread.ident} != {threading.get_ident()}
    assert len(got) == N_REAL and all(r.state == 2 for r in got)
    for a, b in zip(got, want):
        assert np.array_equal(a.pose, b.pose) and a.created_kf == b.created_kf
    assert np.array_equal(sysm.trajectory(), direct.trajectory())
