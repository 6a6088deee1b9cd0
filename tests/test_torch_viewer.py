"""Port vs JAX: ``viz/viewer.py`` (and ``viz/raster.py``).

The JAX package draws with matplotlib, the port into numpy images; what is
held equal is what each draws. JAX's calls are recorded by a stand-in for
``matplotlib.pyplot`` (``_Recorder``), the port's content comes from its
``*_content`` functions. Both Systems take the same 20 frames of the
circular feature drive (``test_torch_loop_closing.loop_drive_features``;
the packages stay equal there, one torch thread); the map views compare on
the JAX map and its copy through ``convert``.

* ``_frustum_segments`` within 1e-6 (observed ≤ 4.8e-7: one f32 rotation);
* ``plot_map``: landmarks and trajectory exactly, keyframe centres and
  covisibility segments (weight ≥ 100, both directions, in JAX's order)
  within 1e-5 m (the port inverts the poses in numpy, JAX with ``jnp``;
  observed ≤ 1.9e-6);
* ``plot_map_3d``: landmarks exactly, frusta, the spanning chain,
  covisibility pairs (upper triangle) and loop edges within 1e-5;
* ``draw_frame_from_system``: the keypoints, their validity, the tracked
  mask, state and counts that the JAX function passes to ``draw_frame``,
  equal;
* raster basics: a marker lands on its pixel, the caption's glyphs are in
  the status bar, the PNG reads back through ``io/png.read_png``;
* ``ViewerSession``: the same file names on the same updates as JAX's.
"""

import os

import numpy as np
import jax
import pytest
import torch

from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu.viz import viewer as j_viewer
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.config import kitti_rgbl_config as t_kitti_rgbl_config
from orb_slam3_rgbl_tpu_torch.io.png import read_png
from orb_slam3_rgbl_tpu_torch.slam.system import System as TSystem
from orb_slam3_rgbl_tpu_torch.viz import raster
from orb_slam3_rgbl_tpu_torch.viz import viewer as t_viewer

from test_torch_loop_closing import feats_to_port, loop_drive_features

N_FRAMES = 20
CENTRE_TOL = 1e-5
FRUSTUM_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def systems():
    """(JAX System, port System) after the same frames."""
    cfg, feats, _ = loop_drive_features(N_FRAMES)
    js, ts = JSystem(cfg), TSystem(t_kitti_rgbl_config(), device="cpu")
    with jax.enable_x64(False):
        for i, f in enumerate(feats):
            js.track_features(f, timestamp=i * 0.1)
            ts.track_features(feats_to_port(f), timestamp=i * 0.1)
    assert js.map.n_kf == ts.map.n_kf >= 4
    return js, ts


class _Recorder:
    """Stands in for ``matplotlib.pyplot``, its figures and axes: records
    every ``scatter`` and ``plot`` call as (name, args, kwargs)."""

    def __init__(self):
        self.calls = []

    def subplots(self, *a, **k):
        return self, self

    def figure(self, *a, **k):
        return self

    def add_subplot(self, *a, **k):
        return self

    def scatter(self, *a, **k):
        self.calls.append(("scatter", [np.asarray(x, np.float64) for x in a], k))

    def plot(self, *a, **k):
        self.calls.append(("plot", [np.asarray(x, np.float64) for x in a], k))

    def __getattr__(self, name):
        return lambda *a, **k: None


@pytest.fixture
def recorder(monkeypatch):
    import matplotlib
    import matplotlib.pyplot as plt

    rec = _Recorder()
    for name in ("subplots", "figure", "close"):
        monkeypatch.setattr(plt, name, getattr(rec, name))
    monkeypatch.setattr(matplotlib, "use", lambda *a, **k: None)
    return rec


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size:
        assert np.abs(a - b).max() <= tol, np.abs(a - b).max()


def test_frustum_segments_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(8):
        q = rng.normal(size=4).astype(np.float32)
        T = np.concatenate([q / np.linalg.norm(q), rng.normal(0, 5, 3).astype(np.float32)])
        with jax.enable_x64(False):
            want = j_viewer._frustum_segments(T, 0.7)
        got = t_viewer._frustum_segments(T, 0.7)
        assert len(got) == len(want) == 8
        _close(np.asarray(got), np.asarray(want), FRUSTUM_TOL)


def test_plot_map_content_matches_jax(systems, recorder, tmp_path):
    js, _ = systems
    tm = convert.map_state_from_numpy(js.map)
    traj = js.trajectory()
    gt = traj + 0.1
    with jax.enable_x64(False):
        j_viewer.plot_map(js.map, trajectory=traj, gt=gt, path=str(tmp_path / "j.png"),
                          draw_covisibility=True)
    scatters = [c for c in recorder.calls if c[0] == "scatter"]
    plots = [c for c in recorder.calls if c[0] == "plot"]
    got = t_viewer.map_content(tm, trajectory=traj, gt=gt, draw_covisibility=True)
    np.testing.assert_array_equal(got["landmarks"], np.stack(scatters[0][1], 1))
    _close(got["keyframes"], np.stack(scatters[1][1], 1), CENTRE_TOL)
    covis = [c for c in plots if c[2].get("c") == "tab:green"]
    assert len(covis) == len(got["covisibility"]) > 0
    _close(got["covisibility"], np.asarray([np.stack(c[1], 1) for c in covis]), CENTRE_TOL)
    (tr,) = [c for c in plots if c[2].get("c") == "tab:red"]
    (g,) = [c for c in plots if c[2].get("c") == "black"]
    np.testing.assert_array_equal(got["trajectory"], np.stack(tr[1], 1))
    np.testing.assert_array_equal(got["gt"], np.stack(g[1], 1))
    path = t_viewer.plot_map(tm, trajectory=traj, gt=gt, path=str(tmp_path / "t.png"),
                             draw_covisibility=True)
    assert read_png(path).shape == (t_viewer.MAP_SIZE[1], t_viewer.MAP_SIZE[0], 3)


def test_plot_map_3d_content_matches_jax(systems, recorder, tmp_path):
    js, _ = systems
    tm = convert.map_state_from_numpy(js.map)
    kfs = js.map.valid_kf_ids()
    loops = [(int(kfs[0]), int(kfs[-1]), None, 1.0), (int(kfs[1]), 10_000, None, 1.0)]
    traj = js.trajectory()
    with jax.enable_x64(False):
        j_viewer.plot_map_3d(js.map, trajectory=traj, loop_edges=loops,
                             path=str(tmp_path / "j.png"))
    got = t_viewer.map3d_content(tm, trajectory=traj, loop_edges=loops)
    calls = recorder.calls
    np.testing.assert_array_equal(got["landmarks"], np.stack(calls[0][1], 1))
    seg = lambda c: np.stack(c[1], 1)      # noqa: E731  ([x0, x1], [z0, z1], [-y0, -y1]) → (2, 3)
    frusta = [seg(c) for c in calls if c[2].get("c") == "tab:blue"]
    assert len(frusta) == 8 * len(kfs)
    _close(got["frusta"], np.asarray(frusta), CENTRE_TOL)
    (chain,) = [seg(c) for c in calls if c[2].get("c") == "tab:green"]
    _close(got["chain"], chain, CENTRE_TOL)
    covis = [seg(c) for c in calls if c[2].get("c") == "tab:olive"]
    assert len(covis) == len(got["covisibility"]) > 0
    _close(got["covisibility"], np.asarray(covis), CENTRE_TOL)
    loop_calls = [seg(c) for c in calls if c[2].get("c") == "tab:red" and c[2].get("lw") == 1.5]
    assert len(loop_calls) == len(got["loops"]) == 1       # the edge to an unknown keyframe is skipped
    _close(got["loops"], np.asarray(loop_calls), CENTRE_TOL)
    (tr,) = [seg(c) for c in calls if c[2].get("c") == "tab:red" and c[2].get("lw") == 0.8]
    np.testing.assert_array_equal(got["trajectory"], tr)
    path = t_viewer.plot_map_3d(tm, trajectory=traj, loop_edges=loops, path=str(tmp_path / "t.png"))
    assert read_png(path).shape == (t_viewer.MAP_3D_SIZE[1], t_viewer.MAP_3D_SIZE[0], 3)


def test_draw_frame_from_system_passes_what_jax_passes(systems, monkeypatch, tmp_path):
    js, ts = systems
    seen = {}

    def capture(which):
        def draw_frame(gray, uv, valid, tracked=None, path="frame.png", **kw):
            seen[which] = dict(uv=np.asarray(uv), valid=np.asarray(valid),
                               tracked=np.asarray(tracked), **kw)
            return path
        return draw_frame

    monkeypatch.setattr(j_viewer, "draw_frame", capture("jax"))
    monkeypatch.setattr(t_viewer, "draw_frame", capture("port"))
    gray = np.full((376, 1241), 40.0, np.float32)
    with jax.enable_x64(False):
        j_viewer.draw_frame_from_system(js, gray, path=str(tmp_path / "j.png"))
    t_viewer.draw_frame_from_system(ts, gray, path=str(tmp_path / "t.png"))
    j, t = seen["jax"], seen["port"]
    np.testing.assert_array_equal(t["uv"], j["uv"])
    np.testing.assert_array_equal(t["valid"], j["valid"])
    np.testing.assert_array_equal(t["tracked"], j["tracked"])
    assert (t["state"], t["n_kf"], t["n_lm"]) == (j["state"], j["n_kf"], j["n_lm"]) == (
        "OK", js.map.n_kf, js.map.n_lm)
    assert 50 < int(t["tracked"].sum()) <= int(t["valid"].sum())


def test_draw_frame_raster(tmp_path):
    gray = np.tile(np.linspace(0, 255, 64, dtype=np.float32), (40, 1))
    uv = np.array([[10.0, 12.0], [30.0, 20.0], [50.0, 30.0]])
    path = t_viewer.draw_frame(gray, uv, np.array([True, True, False]),
                               tracked=np.array([False, True, False]), path=str(tmp_path / "f.png"),
                               state="OK", n_kf=3, n_lm=120)
    img = read_png(path)
    bar = t_viewer.BAR_H
    assert img.shape == (40 + bar, 64, 3)
    # the image under the bar, gray; a ring around keypoint 0, a cross on keypoint 1
    assert tuple(img[bar + 2, 0]) == (0, 0, 0) and img[bar + 2, 63, 0] == 255
    r = 3
    assert tuple(img[bar + 12, 10 + r]) == raster.GREEN
    assert tuple(img[bar + 20, 30]) == raster.RED and tuple(img[bar + 20, 33]) == raster.RED
    assert tuple(img[bar + 30, 53]) != raster.GREEN      # the invalid keypoint is not drawn
    # the caption, glyph by glyph, in the status bar
    content = t_viewer.frame_content(uv, np.array([True, True, False]),
                                     np.array([False, True, False]), "OK", 3, 120)
    assert content["caption"] == "OK | KFs: 3 | MPs: 120 | Matches: 1"
    s, y0 = t_viewer.BAR_SCALE, 3 * t_viewer.BAR_SCALE // 2
    for i, ch in enumerate(content["caption"][:len(content["caption"])]):
        x0 = 4 + i * (raster.GLYPH_W + 1) * s
        if x0 + raster.GLYPH_W * s > 64:
            break
        cell = img[y0:y0 + raster.GLYPH_H * s:s, x0:x0 + raster.GLYPH_W * s:s, 0] == 255
        np.testing.assert_array_equal(cell, raster.FONT[ch], err_msg=ch)


def test_canvas_primitives():
    cv = raster.Canvas(20, 30)
    cv.markers([[4.4, 5.6]], raster.RED)
    assert tuple(cv.img[6, 4]) == raster.RED
    assert (cv.img != 255).any(2).sum() == 1
    cv.lines([[0.0, 0.0]], [[29.0, 19.0]], raster.BLUE)
    assert tuple(cv.img[0, 0]) == raster.BLUE and tuple(cv.img[19, 29]) == raster.BLUE
    assert ((cv.img == raster.BLUE).all(2).sum(1) > 0).all()     # one pixel or more in every row
    cv.markers([[-50.0, 5.0], [np.nan, 3.0]], raster.GREEN, radius=2)   # off the canvas: dropped
    assert not (cv.img == raster.GREEN).all(2).any()
    to_px = raster.fit_view([np.array([[0.0, 0.0], [10.0, 5.0]])], (200, 100), margin=10)
    px = to_px(np.array([[0.0, 0.0], [10.0, 5.0]]))
    assert px[0, 1] > px[1, 1] and px[0, 0] < px[1, 0]           # z up, x right
    # one scale on both axes, set by the tighter one (z: 80 px for 5 m)
    np.testing.assert_allclose(abs(px[1] - px[0]), [160.0, 80.0])


def test_viewer_session_names_and_cadence(systems, monkeypatch, tmp_path):
    js, ts = systems
    written = {"jax": [], "port": []}

    def fake(which):
        def render(*a, path=None, **k):
            written[which].append(os.path.basename(path))
            return path
        return render

    for mod, which in ((j_viewer, "jax"), (t_viewer, "port")):
        for name in ("plot_map_3d", "plot_map", "draw_frame_from_system"):
            monkeypatch.setattr(mod, name, fake(which))
    gray = np.zeros((376, 1241), np.float32)
    for map_3d in (True, False):
        sj = j_viewer.ViewerSession(str(tmp_path / f"j{map_3d}"), every=3, map_3d=map_3d)
        st = t_viewer.ViewerSession(str(tmp_path / f"t{map_3d}"), every=3, map_3d=map_3d)
        outs = [(sj.update(js, gray if i % 2 else None), st.update(ts, gray if i % 2 else None))
                for i in range(8)]
        for oj, ot in outs:
            assert (oj is None) == (ot is None)
            if oj is not None:
                assert [os.path.basename(p) for p in oj] == [os.path.basename(p) for p in ot]
    assert written["jax"] == written["port"] and len(written["port"]) == 8
