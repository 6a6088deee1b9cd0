"""Online SLAM node (counterpart of ``orb_slam3_rgbl_tpu.io.online``): the
framework-agnostic analogue of the reference's ROS2 nodes
(``ros2/ros2_orb_slam3/src/rgbd/rgbd-slam-node.cpp``). Sensor streams come
in through plain ``feed_*`` methods (a ROS2 wrapper would subscribe and
forward into them, as ``rgbd-slam-node.cpp:52`` does), an approximate-time
synchronizer pairs them (``message_filters::sync_policies::ApproximateTime``,
``rgbd-slam-node.cpp:14``), and a worker thread drives the port's
``System`` off the caller's thread, calling ``on_pose(t, TrackResult)`` for
every tracked frame.

On the card the worker thread issues the System's CUDA work: the
extraction kernels launch on that thread's current stream, and an
asynchronous System takes its tracking stream from the thread that tracks.

Three departures from the JAX node, each a fault of it:
- the IMU windows stay float64 (EuRoC's ~1.4e9 s stamps are 128 s coarse
  in float32);
- an exception of the worker is kept in ``error`` and raised by ``stop()``
  and by every later ``feed_*`` call, where the JAX worker ends silently
  and the node then drops every frame;
- ``stop()`` returns only once the worker has tracked every queued frame
  and ended (or raises ``TimeoutError`` if a ``timeout`` passes first),
  where the JAX node returns after 10 s with the worker possibly still
  tracking, racing ``System.shutdown()``.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Optional

import numpy as np

MODES = ("rgbd", "rgbl", "stereo", "mono")


class ApproximateTimeSync:
    """Pair two timestamped streams by nearest timestamp within ``slop``
    seconds (the reference's ApproximateTime policy with queue_size)."""

    def __init__(self, slop: float = 0.02, queue_size: int = 10):
        self.slop = slop
        self.a = collections.deque(maxlen=queue_size)
        self.b = collections.deque(maxlen=queue_size)
        self._lock = threading.Lock()

    def push_a(self, t: float, payload):
        with self._lock:
            self.a.append((t, payload))
            return self._match()

    def push_b(self, t: float, payload):
        with self._lock:
            self.b.append((t, payload))
            return self._match()

    def _match(self):
        if not self.a or not self.b:
            return None
        ta, pa = self.a[0]
        # the b closest to the oldest a
        j = min(range(len(self.b)), key=lambda k: abs(self.b[k][0] - ta))
        tb, pb = self.b[j]
        if abs(tb - ta) <= self.slop:
            self.a.popleft()
            for _ in range(j + 1):
                self.b.popleft()
            return ta, pa, pb
        # the oldest a is unmatched and b has moved past it: drop that a
        if self.b[0][0] - ta > self.slop:
            self.a.popleft()
        return None


class OnlineSlamNode:
    """Threaded online front door around the port's ``System``.

    ``mode``: 'rgbd' | 'rgbl' | 'stereo' | 'mono'. Feed frames with the
    matching ``feed_*`` methods; IMU samples fed by ``feed_imu`` are
    windowed per frame as the reference's inertial nodes accumulate
    ``vImuMeas``. A full queue of ``max_queue`` frames drops its oldest
    (``dropped_frames`` counts them): a live sensor never blocks.
    """

    def __init__(self, system, mode: str = "rgbd", on_pose: Optional[Callable] = None,
                 sync_slop: float = 0.02, max_queue: int = 4):
        if mode not in MODES:
            raise ValueError(f"unknown mode: {mode}")
        self.system = system
        self.mode = mode
        self.on_pose = on_pose
        self.sync = ApproximateTimeSync(slop=sync_slop)
        self.error: Optional[BaseException] = None
        self._work: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._feed_lock = threading.Lock()
        self._imu: list = []
        self._imu_lock = threading.Lock()
        self._last_t = -np.inf
        self._dropped = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="online-node", daemon=True)
        self._thread.start()

    # -- feeds ----------------------------------------------------------
    def feed_imu(self, t: float, acc, gyro):
        with self._imu_lock:
            self._imu.append([t, *np.asarray(acc, float), *np.asarray(gyro, float)])

    def _imu_window(self, t: float) -> Optional[np.ndarray]:
        """(S, 7) float64 samples ``[t, ax, ay, az, gx, gy, gz]`` after the
        last tracked frame and up to ``t``; the older ones are discarded."""
        with self._imu_lock:
            if not self._imu:
                return None
            take = [s for s in self._imu if self._last_t < s[0] <= t]
            self._imu = [s for s in self._imu if s[0] > t]
        return np.asarray(take, np.float64) if take else None

    def _enqueue(self, item):
        """Latest-wins backpressure: drop the oldest queued frame rather
        than block (the reference's ROS QoS keeps a shallow queue for the
        same reason)."""
        with self._feed_lock:
            if self.error is not None:
                raise RuntimeError("online node: the worker failed; see .error") from self.error
            if self._stop.is_set():
                raise RuntimeError("online node: fed after stop()")
            while True:
                try:
                    self._work.put_nowait(item)
                    return
                except queue.Full:
                    try:
                        self._work.get_nowait()
                        self._dropped += 1
                    except queue.Empty:
                        pass

    def _check_mode(self, mode: str, feed: str):
        if self.mode != mode:
            raise ValueError(f"online node: {feed} in mode {self.mode!r}")

    def feed_rgb(self, t: float, gray: np.ndarray):
        if self.mode == "mono":
            self._enqueue(("mono", t, gray))
        else:
            m = self.sync.push_a(t, gray)
            if m is not None:
                self._enqueue((self.mode, m[0], m[1], m[2]))

    def feed_depth(self, t: float, depth: np.ndarray):
        self._check_mode("rgbd", "feed_depth")
        m = self.sync.push_b(t, depth)
        if m is not None:
            self._enqueue(("rgbd", m[0], m[1], m[2]))

    def feed_cloud(self, t: float, cloud: np.ndarray):
        self._check_mode("rgbl", "feed_cloud")
        m = self.sync.push_b(t, cloud)
        if m is not None:
            self._enqueue(("rgbl", m[0], m[1], m[2]))

    def feed_right(self, t: float, gray_r: np.ndarray):
        self._check_mode("stereo", "feed_right")
        m = self.sync.push_b(t, gray_r)
        if m is not None:
            self._enqueue(("stereo", m[0], m[1], m[2]))

    # -- worker ---------------------------------------------------------
    def _track(self, item):
        kind, t = item[0], item[1]
        imu = self._imu_window(t)
        if kind == "mono":
            res = self.system.track_monocular(item[2], t, imu=imu)
        elif kind == "rgbd":
            res = self.system.track_rgbd(item[2], item[3], t, imu=imu)
        elif kind == "rgbl":
            res = self.system.track_rgbl(item[2], item[3], t)
        else:
            res = self.system.track_stereo(item[2], item[3], t, imu=imu)
        self._last_t = t
        if self.on_pose is not None:
            self.on_pose(t, res)

    def _run(self):
        while True:
            try:
                item = self._work.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            try:
                self._track(item)
            except Exception as exc:  # kept for stop() and the feeds to raise
                self.error = exc
                return

    def stop(self, timeout: Optional[float] = None):
        """Track every queued frame, end the worker (``System::Shutdown``'s
        first half; call ``system.shutdown()`` after it) and raise the
        worker's exception if it had one. With ``timeout`` (seconds), raise
        ``TimeoutError`` if the worker is still tracking then."""
        with self._feed_lock:
            self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"online node: the worker is still tracking after {timeout} s")
        if self.error is not None:
            raise RuntimeError("online node: the worker failed") from self.error

    @property
    def dropped_frames(self) -> int:
        return self._dropped
