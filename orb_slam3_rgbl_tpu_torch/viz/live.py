"""Live viewer (counterpart of ``orb_slam3_rgbl_tpu.viz.live``; the
reference's ``Viewer::Run`` thread and per-frame ``FrameDrawer::Update``,
``src/Viewer.cc`` launched at ``System.cc:236-244``,
``src/FrameDrawer.cc:37/370``) for deployments without a display: a
daemon thread renders the current frame overlay and a map view at ``hz``
into ``out_dir/live_frame.png`` and ``live_map.png`` (each replaced
atomically), and an optional built-in HTTP server serves them to a browser.

Off the tracking path: the viewer reads the tracker's and the map's host
state, and two things that may lie on the device: the frame image (fed
before the frame is tracked) and the frame's keypoints (``uv`` and
``valid`` of the tracker's last features, fed by ``update`` once the frame
is tracked, ``FrameDrawer::Update``). Each feed records an event on the
feeding thread's current stream, without waiting; at most ``hz`` times a
second the viewer thread copies them to the host on a CUDA stream of its
own after those events (the keypoints in one transfer), so it never reads
what the tracking stream has not finished writing, and the tracking thread
never waits for it. A render that fails is logged (``utils/logging``) and
the engine carries on.

Usage::

    sysm = System(cfg)
    viewer = sysm.start_viewer(out_dir="viewer_out", http_port=8765)
    ... track frames ...
    sysm.shutdown()            # stops the viewer too
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Optional

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch.utils.logging import log


class LiveViewer:
    def __init__(self, system, out_dir: str = "viewer_out", hz: float = 2.0,
                 http_port: Optional[int] = None, map_3d: bool = False):
        self.system = system
        self.out_dir = out_dir
        self.period = 1.0 / max(hz, 0.1)
        self.map_3d = map_3d
        self.http_port = http_port
        self._img = (None, None)     # (gray image, its CUDA event or None)
        self._feats = None           # (uv, valid, their CUDA event or None)
        self.frames_rendered = 0
        self._stream = None          # the viewer's own CUDA stream, made on first use
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._httpd = None
        self._http_thread = None
        os.makedirs(out_dir, exist_ok=True)

    # -- the feed (FrameDrawer::Update) --------------------------------
    @property
    def latest_img(self):
        return self._img[0]

    @latest_img.setter
    def latest_img(self, img):
        """A numpy image, or a device tensor: then an event on the feeding
        thread's current stream marks where its writes end (no wait)."""
        self._img = (img, _written(img))

    def update(self, tracker):
        """The tracked frame's keypoints (``FrameDrawer::Update``), fed by
        the tracking thread after each frame: the tracker's last features'
        ``uv`` and ``valid`` as they lie, with an event where their writes
        end. No copy and no wait."""
        feats = tracker.last_feats
        if feats is None:
            self._feats = None
            return
        uv, valid = torch.as_tensor(feats.uv), torch.as_tensor(feats.valid)
        self._feats = (uv, valid, _written(uv))

    def _to_host(self, ev, fn, *tensors) -> np.ndarray:
        """``fn(*tensors)`` on the host; for CUDA tensors computed and copied
        on the viewer's own stream after ``ev`` (where the feed's writes end)."""
        if not tensors[0].is_cuda:
            return fn(*(t.detach() for t in tensors)).numpy()
        if self._stream is None:
            self._stream = torch.cuda.Stream(tensors[0].device)
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(ev)
            for t in tensors:
                t.record_stream(self._stream)   # the allocator keeps it until the copy is done
            host = fn(*tensors).to("cpu", non_blocking=True)
        self._stream.synchronize()              # this thread waits; the tracker does not
        return host.numpy()

    def _host_frame(self):
        """(gray, uv, valid) on the host, or None before the first feeds;
        the keypoints in one transfer."""
        (img, img_ev), feats = self._img, self._feats
        if img is None or feats is None:
            return None
        gray = (self._to_host(img_ev, torch.Tensor.detach, img) if isinstance(img, torch.Tensor)
                else np.asarray(img))
        uv, valid, ev = feats
        both = self._to_host(ev, _uv_valid, uv, valid)
        return gray, both[:, :2], both[:, 2] > 0

    # -- lifecycle -----------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, daemon=True, name="viewer")
        self._thread.start()
        if self.http_port is not None:
            self._start_http()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    # -- render loop (Viewer::Run) --------------------------------------
    def _run(self):
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                self._render_once()
            except Exception:                      # the viewer never stops the engine
                log("viewer render failed:\n" + traceback.format_exc())
            dt = time.perf_counter() - t0
            self._stop.wait(max(self.period - dt, 0.05))

    def _atomic(self, name: str):
        return (os.path.join(self.out_dir, name + ".tmp.png"),
                os.path.join(self.out_dir, name))

    def _render_once(self):
        from orb_slam3_rgbl_tpu_torch.viz import viewer as vz

        sysm = self.system
        if sysm.map is None or sysm.tracker is None:
            return
        # frame overlay (FrameDrawer::DrawFrame)
        frame = self._host_frame()
        if frame is not None:
            gray, uv, valid = frame
            tmp, dst = self._atomic("live_frame.png")
            vz.draw_frame_from_system(sysm, gray, path=tmp, keypoints=(uv, valid))
            os.replace(tmp, dst)
        # map view (MapDrawer::DrawMapPoints / DrawKeyFrames); keyframe
        # centres stand in for the resolved trajectory, whose resolution
        # joins the mapping plane: too heavy for a side thread at 2 Hz
        tmp, dst = self._atomic("live_map.png")
        if self.map_3d:
            vz.plot_map_3d(sysm.map, trajectory=None, path=tmp)
        else:
            vz.plot_map(sysm.map, trajectory=None, path=tmp)
        os.replace(tmp, dst)
        self.frames_rendered += 1

    # -- HTTP serving (headless Pangolin analog) ------------------------
    def _start_http(self):
        import http.server

        out_dir = self.out_dir

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):           # quiet
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    body = (b"<html><head><meta http-equiv='refresh' "
                            b"content='1'><title>orb_slam3_rgbl_tpu_torch</title>"
                            b"</head><body style='background:#111'>"
                            b"<img src='/live_frame.png' style='width:100%'>"
                            b"<img src='/live_map.png' style='width:49%'>"
                            b"</body></html>")
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                p = os.path.join(out_dir, os.path.basename(self.path))
                if os.path.exists(p) and p.endswith(".png"):
                    with open(p, "rb") as f:
                        body = f.read()
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

        self._httpd = http.server.ThreadingHTTPServer(("0.0.0.0", self.http_port), Handler)
        self.http_port = self._httpd.server_address[1]  # resolve port 0
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="viewer-http")
        self._http_thread.start()


def _uv_valid(uv, valid):
    """(n, 3) f32: the keypoints' u, v and validity, one array to copy."""
    return torch.cat([uv.reshape(-1, 2).float(), valid.reshape(-1, 1).float()], 1)


def _written(t):
    """An event on the current stream where a CUDA tensor's queued writes
    end; None for anything else."""
    if not (isinstance(t, torch.Tensor) and t.is_cuda):
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev
