"""Prefetching KITTI loader (counterpart of ``orb_slam3_rgbl_tpu.io.native_loader``,
whose C++ prefetcher ``native/kitti_loader.cc`` decodes with OpenCV).

``NativeKittiSequence`` decodes frames ahead of the frame loop in worker
processes, so that the tracking thread, which is bound by the host's launch
rate, never shares the interpreter lock with a decoder. Each worker is
started with ``subprocess`` as

    python -m orb_slam3_rgbl_tpu_torch.io.native_loader --worker SEQ CAMERA MAX_POINTS

and imports only numpy and the port's numpy-only ``io/png.py`` and
``io/kitti.py`` (the package's ``__init__`` imports nothing): neither the
caller's ``__main__`` nor torch is loaded again, and no process is forked
after CUDA has started. Frame ``i`` goes to worker ``i % n_threads``; the
consumer asks for a frame by writing its index to the worker's stdin, at
most ``queue_depth`` frames ahead of the last one it took, and the worker
sends it back over its stdout as raw bytes: a header, the 8-bit gray image
and the padded cloud with its mask.

Each frame equals ``io.kitti.KittiSequence.frame(i)`` bit for bit (the same
decoder and the same near-point truncation). There is no fallback: a file
that fails to decode raises its ``ValueError`` (naming the file) from
``next_frame()``, and so does a worker that dies. ``close()`` (and the
garbage collector) ends every worker.
"""

from __future__ import annotations

import os
import struct
import subprocess
import sys
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

from orb_slam3_rgbl_tpu_torch.io import kitti, png

# index, status (0 frame, 1 error), height, width, cloud points (0: none),
# payload bytes
_HEADER = struct.Struct("<iiiiiq")
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _encode_frame(i: int, images: List[str], clouds: List[str], max_points: int) -> bytes:
    """Frame ``i`` as one record: the header, then the uint8 gray image and,
    with clouds, the (max_points, 4) float32 cloud and its uint8 mask."""
    try:
        gray = png.load_gray(images[i])
        parts = [gray.tobytes()]
        n_pts = 0
        if clouds:
            pcd, mask = kitti.load_pointcloud(clouds[i], max_points)
            parts += [np.ascontiguousarray(pcd, np.float32).tobytes(),
                      mask.astype(np.uint8).tobytes()]
            n_pts = max_points
    except Exception as exc:  # every failure goes back to the consumer, named
        msg = f"{type(exc).__name__}: {exc}".encode()
        return _HEADER.pack(i, 1, 0, 0, 0, len(msg)) + msg
    payload = b"".join(parts)
    return _HEADER.pack(i, 0, gray.shape[0], gray.shape[1], n_pts, len(payload)) + payload


def _worker_main(seq_dir: str, camera: str, max_points: int):
    """A worker: read frame indices from stdin, one a line, and write each
    frame's record to stdout. A second thread writes, so that the next
    frame decodes while the consumer has not read the last one yet; the
    consumer's bound on requests bounds what the worker holds."""
    import queue

    images = kitti.list_images(seq_dir, camera)
    clouds = (kitti.list_velodyne(seq_dir)
              if os.path.isdir(os.path.join(seq_dir, "velodyne")) else [])
    out = sys.stdout.buffer
    done: "queue.Queue" = queue.Queue()

    def writer():
        while True:
            rec = done.get()
            if rec is None:
                return
            try:
                out.write(rec)
                out.flush()
            except (BrokenPipeError, ValueError):   # the consumer has gone
                os._exit(0)

    thread = threading.Thread(target=writer, daemon=True)
    thread.start()
    for line in sys.stdin.buffer:
        done.put(_encode_frame(int(line), images, clouds, max_points))
    done.put(None)
    thread.join()


def _read_exact(stream, n: int) -> Optional[bytearray]:
    """``n`` bytes from a pipe, or None at its end."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = stream.readinto(view[got:])
        if not k:
            return None
        got += k
    return buf


class NativeKittiSequence:
    """Prefetching replacement for ``io.kitti.KittiSequence``: iterate with
    ``next_frame()``, which returns ``(gray f32 (H, W), cloud (max_points,
    4), mask (max_points,), t)`` (cloud and mask None without a
    ``velodyne`` directory) or None after the last frame. ``n_threads``
    worker processes decode at most ``queue_depth`` frames ahead."""

    def __init__(self, seq_dir: str, camera: str = "image_2",
                 max_points: int = 131072, queue_depth: int = 4, n_threads: int = 2):
        if queue_depth < 1 or n_threads < 1:
            raise ValueError(f"queue_depth {queue_depth} and n_threads {n_threads} must be >= 1")
        self.seq_dir = seq_dir
        self.images = kitti.list_images(seq_dir, camera)
        self.times = kitti.load_times(seq_dir)
        self.max_points = max_points
        self.queue_depth = queue_depth
        self.n = len(self.images)
        if self.n == 0:
            raise ValueError(f"{os.path.join(seq_dir, camera)}: no PNG images")
        self.height, self.width = png.image_size(self.images[0])
        self._next = 0          # the frame next_frame() returns
        self._asked = 0         # frames requested so far
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_PACKAGE_PARENT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        env["OMP_NUM_THREADS"] = "1"
        cmd = [sys.executable, "-m", "orb_slam3_rgbl_tpu_torch.io.native_loader", "--worker",
               seq_dir, camera, str(max_points)]
        self._workers: List[subprocess.Popen] = []
        # each worker's stderr goes to a file of its own, read when it dies: a
        # pipe nobody reads while the worker lives would block it once full
        self._errs: List = []
        try:
            for _ in range(min(n_threads, self.n)):
                self._errs.append(tempfile.TemporaryFile())
                self._workers.append(subprocess.Popen(
                    cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self._errs[-1],
                    env=env, bufsize=0))
            while self._asked < min(self.n, queue_depth):
                self._request()
        except BaseException:
            self.close()
            raise

    def __len__(self):
        return self.n

    def _request(self):
        w = self._workers[self._asked % len(self._workers)]
        try:
            w.stdin.write(b"%d\n" % self._asked)
        except BrokenPipeError:
            pass            # the worker died: next_frame() reports it at its frame
        self._asked += 1

    def _dead(self, i: int, w: subprocess.Popen):
        try:
            w.wait(timeout=5)
            f = self._errs[self._workers.index(w)]
            f.seek(0)
            err = f.read().decode(errors="replace").strip()
        except subprocess.TimeoutExpired:
            err = ""
        self.close()
        raise RuntimeError(f"native loader: the worker decoding frame {i} "
                           f"({self.images[i]}) ended with code {w.returncode}"
                           + (f":\n{err}" if err else ""))

    def next_frame(self) -> Optional[Tuple[np.ndarray, Optional[np.ndarray],
                                           Optional[np.ndarray], float]]:
        i = self._next
        if i >= self.n:
            return None
        if not self._workers:
            raise RuntimeError("native loader: next_frame() after close()")
        w = self._workers[i % len(self._workers)]
        head = _read_exact(w.stdout, _HEADER.size)
        if head is None:
            self._dead(i, w)
        idx, status, h, wd, n_pts, size = _HEADER.unpack(head)
        body = _read_exact(w.stdout, size)
        if body is None or idx != i:
            self._dead(i, w)
        if status != 0:
            self.close()
            raise ValueError(f"native loader: frame {i}: {body.decode(errors='replace')}")
        self._next += 1
        if self._asked < self.n:
            self._request()
        img = np.frombuffer(body, np.uint8, h * wd).reshape(h, wd).astype(np.float32)
        cloud = mask = None
        if n_pts:
            cloud = np.frombuffer(body, np.float32, n_pts * 4, h * wd).reshape(n_pts, 4)
            mask = np.frombuffer(body, np.uint8, n_pts, h * wd + n_pts * 16).astype(bool)
        return img, cloud, mask, float(self.times[i])

    def close(self):
        """End every worker: stdin closed (a worker exits at its end), then
        terminated if it has not."""
        workers, self._workers = getattr(self, "_workers", []), []
        errs, self._errs = getattr(self, "_errs", []), []
        for w in workers:
            for pipe in (w.stdin, w.stdout):
                try:
                    pipe.close()
                except OSError:
                    pass
        for w in workers:
            try:
                w.wait(timeout=2)
            except subprocess.TimeoutExpired:
                w.kill()
                w.wait()
        for f in errs:
            f.close()

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker_main(sys.argv[2], sys.argv[3], int(sys.argv[4]))
