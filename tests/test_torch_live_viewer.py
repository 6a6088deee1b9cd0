"""The port's live viewer (``viz/live.py``; the reference's Viewer and
FrameDrawer threads, ``System.cc:236-244``): ``tests/test_live_viewer.py`` on
the port — the render thread draws frame and map snapshots while the System
tracks, the built-in HTTP server serves them, ``shutdown()`` stops it — and
the feeds of the image entry points, the stereo one included (the left
image, as the reference's ``FrameDrawer::Update`` for every sensor; the JAX
``track_stereo`` feeds nothing)."""

import dataclasses
import os
import time
import urllib.request

import numpy as np
import jax
import pytest
import torch

from orb_slam3_rgbl_tpu_torch import synthetic
from orb_slam3_rgbl_tpu_torch.config import STEREO, kitti_rgbl_config
from orb_slam3_rgbl_tpu_torch.io.png import read_png
from orb_slam3_rgbl_tpu_torch.slam.system import System
from orb_slam3_rgbl_tpu_torch.viz import raster
from orb_slam3_rgbl_tpu_torch.viz import viewer as t_viewer

from synthetic_world import SyntheticWorld
from test_torch_loop_closing import feats_to_port


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wait_for_render(viewer, n=1, timeout=30.0):
    t0 = time.time()
    while viewer.frames_rendered < n and time.time() - t0 < timeout:
        time.sleep(0.05)
    return viewer.frames_rendered


def test_live_viewer_renders_and_serves(rng, tmp_path):
    cfg = kitti_rgbl_config()
    world = SyntheticWorld(rng, cam=cfg.camera, length=30.0)
    gt = world.trajectory(25, step=0.8)
    sysm = System(cfg, device="cpu")
    out = str(tmp_path / "viewer")
    viewer = sysm.start_viewer(out_dir=out, hz=20.0, http_port=0)
    assert sysm.start_viewer() is viewer            # one viewer a System
    gray = np.full((cfg.camera.height, cfg.camera.width), 20.0, np.float32)
    try:
        for i in range(25):
            with jax.enable_x64(False):
                feats = world.render(gt[i])
            sysm.track_features(feats_to_port(feats), timestamp=i * 0.1)
            viewer.latest_img = gray     # track_features has no image;
            # the image entry points feed this themselves
        assert _wait_for_render(viewer, viewer.frames_rendered + 1) >= 1
        frame = read_png(os.path.join(out, "live_frame.png"))
        assert frame.shape == (cfg.camera.height + t_viewer.BAR_H, cfg.camera.width, 3)
        assert read_png(os.path.join(out, "live_map.png")).shape == (
            t_viewer.MAP_SIZE[1], t_viewer.MAP_SIZE[0], 3)
        # HTTP: index + image round trip (port 0 → a free port)
        port = viewer.http_port
        assert port > 0
        html = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10).read()
        assert b"live_frame.png" in html
        png = urllib.request.urlopen(f"http://127.0.0.1:{port}/live_map.png", timeout=10).read()
        assert png[:4] == b"\x89PNG"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nothing.png", timeout=10)
    finally:
        thread = viewer._thread
        sysm.shutdown()
    assert sysm._viewer is None                 # shutdown stops the viewer
    assert thread is not None and not thread.is_alive()
    assert viewer._httpd is None


def test_image_entry_points_feed_the_viewer(tmp_path):
    """``track_rgbl`` and ``track_stereo`` hand their image to the viewer
    (for stereo the left one), and a render draws it."""
    cfg = synthetic.synthetic_rgbl_config()
    h, w = cfg.camera.height, cfg.camera.width
    world = synthetic.make_world(0, tex_size=64, device="cpu")
    twc = synthetic.straight_trajectory(2, 0.6)
    left = synthetic.render_image(world, twc[0], cfg.camera.fx, cfg.camera.fy, cfg.camera.cx,
                                  cfg.camera.cy, h, w).numpy()
    right = np.ascontiguousarray(left[:, ::-1])
    for sensor in ("rgbl", "stereo"):
        c = cfg if sensor == "rgbl" else dataclasses.replace(cfg, sensor=STEREO)
        sysm = System(c, device="cpu")
        out = str(tmp_path / sensor)
        viewer = sysm.start_viewer(out_dir=out, hz=20.0)
        try:
            if sensor == "rgbl":
                cloud = synthetic.lidar_scan(world, twc[0], n_az=64, n_el=8)
                sysm.track_rgbl(left, cloud, 0.0)
            else:
                sysm.track_stereo(left, right, 0.0)
            assert viewer.latest_img is left
            n = viewer.frames_rendered
            assert _wait_for_render(viewer, n + 2) >= n + 2
            frame = read_png(os.path.join(out, "live_frame.png"))
            assert frame.shape == (h + t_viewer.BAR_H, w, 3)
            # the image under the overlay: every pixel that is not a marker's
            gray = np.clip(left, 0, 255).astype(np.uint8)
            body = frame[t_viewer.BAR_H:]
            marker = (body == raster.GREEN).all(2) | (body == raster.RED).all(2)
            assert 0 < marker.mean() < 0.5
            np.testing.assert_array_equal(body[~marker], np.repeat(gray[~marker][:, None], 3, 1))
        finally:
            sysm.shutdown()
        assert sysm._viewer is None


def test_each_tracked_frame_feeds_its_keypoints(rng, tmp_path):
    """After every tracked frame the System hands the viewer the tracker's
    last features (``FrameDrawer::Update``), and the viewer's host copy is
    those keypoints."""
    cfg = kitti_rgbl_config()
    world = SyntheticWorld(rng, cam=cfg.camera, length=30.0)
    gt = world.trajectory(3, step=0.8)
    sysm = System(cfg, device="cpu")
    viewer = sysm.start_viewer(out_dir=str(tmp_path), hz=0.1)
    try:
        for i in range(3):
            with jax.enable_x64(False):
                feats = world.render(gt[i])
            sysm.track_features(feats_to_port(feats), timestamp=i * 0.1)
            last = sysm.tracker.last_feats
            assert viewer._feats[0] is last.uv and viewer._feats[1] is last.valid
        viewer.latest_img = np.zeros((cfg.camera.height, cfg.camera.width), np.float32)
        _, uv, valid = viewer._host_frame()
        np.testing.assert_array_equal(uv, last.uv.numpy())
        np.testing.assert_array_equal(valid, last.valid.numpy())
    finally:
        sysm.shutdown()


def test_a_render_error_is_logged_and_the_viewer_carries_on(tmp_path, monkeypatch):
    from orb_slam3_rgbl_tpu_torch.utils import logging as t_log
    from orb_slam3_rgbl_tpu_torch.viz import live

    cfg = synthetic.synthetic_rgbl_config()
    sysm = System(cfg, device="cpu")
    logged = []
    monkeypatch.setattr(live, "log", lambda msg, *a, **k: logged.append(msg))
    viewer = live.LiveViewer(sysm, out_dir=str(tmp_path), hz=50.0)
    sysm.map, sysm.tracker = object(), object()      # no map to draw: every render raises
    viewer.start()
    try:
        t0 = time.time()
        while len(logged) < 2 and time.time() - t0 < 10:
            time.sleep(0.02)
        assert len(logged) >= 2 and "viewer render failed" in logged[0]
        assert viewer._thread.is_alive() and viewer.frames_rendered == 0
    finally:
        viewer.stop()
    assert viewer._thread is None
    assert t_log.QUIET == 0
