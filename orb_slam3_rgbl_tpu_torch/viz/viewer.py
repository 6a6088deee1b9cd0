"""Offline map and frame views (counterpart of
``orb_slam3_rgbl_tpu.viz.viewer``; the reference's Pangolin ``Viewer``,
``MapDrawer`` and ``FrameDrawer``, ``src/Viewer.cc``, ``src/MapDrawer.cc``,
``src/FrameDrawer.cc``), drawn off the tracking path.

The JAX package draws with matplotlib, which the card's machine lacks; the
port draws into numpy images (``viz/raster``) and writes PNG. Each view is
split in two: ``*_content`` computes what is drawn, in world or image
units — the same landmarks, keyframe centres and frusta, covisibility pairs,
loop edges, keypoints and status-bar fields as the JAX functions — and
``render_*`` rasterizes it. ``plot_map``, ``draw_frame``,
``draw_frame_from_system``, ``plot_map_3d`` and ``ViewerSession`` keep the
JAX names and arguments.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState
from orb_slam3_rgbl_tpu_torch.viz import raster

MAP_SIZE = (800, 800)       # top-down view, pixels (w, h)
MAP_3D_SIZE = (960, 720)
COVISIBILITY_MIN = 100      # the essential graph's strong-edge weight (Optimizer.cc:1545)
BAR_SCALE = 2               # the status bar's font scale
BAR_H = (raster.GLYPH_H + 3) * BAR_SCALE


def host_image(img) -> np.ndarray:
    """An image as a host numpy array (a device tensor is copied)."""
    return img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)


def _centers(map_state: MapState, kf_ids) -> np.ndarray:
    """(n, 3) world positions of keyframes ``kf_ids``: the translation of
    Twc = Tcw⁻¹."""
    return lie.np_se3_inv(np.asarray(map_state.kf_pose[kf_ids], np.float32))[:, 4:7]


# ---- top-down map (x–z) ---------------------------------------------------------------
def map_content(map_state: MapState, trajectory: Optional[np.ndarray] = None,
                gt: Optional[np.ndarray] = None, draw_covisibility: bool = False) -> dict:
    """What ``plot_map`` draws, as x–z world coordinates: ``landmarks``
    (n, 2), ``keyframes`` (k, 2) centres, ``covisibility`` (e, 2, 2) segments
    (every keyframe to each neighbour sharing ≥ 100 landmarks, both
    directions, in the JAX loop's order; only with ``draw_covisibility``),
    ``trajectory`` and ``gt`` (t, 2) from Twc rows, or None."""
    lms = map_state.lm_pos[map_state.lm_valid]
    kfs = map_state.valid_kf_ids()
    centers = _centers(map_state, kfs) if len(kfs) else np.zeros((0, 3), np.float32)
    segs = []
    if draw_covisibility:
        for i, k in enumerate(kfs):
            w = map_state.covisibility_weights(int(k))
            for nb in np.nonzero(w >= COVISIBILITY_MIN)[0]:
                c2 = _centers(map_state, [nb])[0]
                segs.append([[centers[i, 0], centers[i, 2]], [c2[0], c2[2]]])
    xz = (lambda a: None if a is None or not len(a) else np.asarray(a)[:, [4, 6]])
    return {"landmarks": np.asarray(lms)[:, [0, 2]], "keyframes": centers[:, [0, 2]],
            "covisibility": np.asarray(segs, np.float64).reshape(-1, 2, 2),
            "trajectory": xz(trajectory), "gt": xz(gt)}


def render_map(content: dict, path: str, size=MAP_SIZE) -> str:
    w, h = size
    cv = raster.Canvas(h, w)
    to_px = raster.fit_view([content["landmarks"], content["keyframes"], content["trajectory"],
                             content["gt"]], size)
    cv.markers(to_px(content["landmarks"]), raster.GRAY)
    segs = content["covisibility"]
    if len(segs):
        cv.lines(to_px(segs[:, 0]), to_px(segs[:, 1]), raster.DARK_GREEN)
    if content["gt"] is not None:
        cv.polyline(to_px(content["gt"]), raster.BLACK)
    if content["trajectory"] is not None:
        cv.polyline(to_px(content["trajectory"]), raster.RED)
    cv.markers(to_px(content["keyframes"]), raster.BLUE, radius=2, shape="square")
    cv.text(w // 2 - raster.text_width("x [m]") // 2, h - 14, "x [m]", raster.BLACK)
    cv.text(6, h // 2, "z [m]", raster.BLACK)
    return cv.save(path)


def plot_map(map_state: MapState, trajectory: Optional[np.ndarray] = None,
             gt: Optional[np.ndarray] = None, path: str = "map.png",
             draw_covisibility: bool = False):
    """Top-down (x–z) map view: landmarks (gray), keyframe centres (blue
    squares), the trajectory (red) and the ground truth (black), fitted to
    the image with equal axes."""
    return render_map(map_content(map_state, trajectory, gt, draw_covisibility), path)


# ---- the frame overlay (FrameDrawer::DrawFrame) ----------------------------------------
def frame_content(uv: np.ndarray, valid: np.ndarray, tracked: Optional[np.ndarray] = None,
                  state: Optional[str] = None, n_kf: Optional[int] = None,
                  n_lm: Optional[int] = None) -> dict:
    """What ``draw_frame`` draws: ``keypoints`` (n, 2) valid, ``tracked``
    (t, 2) map-point matches, and the status bar's ``caption`` (state,
    ``KFs:``, ``MPs:``, ``Matches:``, joined by `` | ``;
    ``FrameDrawer.cc:331-369``)."""
    uv = np.asarray(uv).reshape(-1, 2)
    n_matches = 0
    pts_t = np.zeros((0, 2))
    if tracked is not None:
        tracked = np.asarray(tracked, bool)
        pts_t = uv[tracked]
        n_matches = int(tracked.sum())
    parts = []
    if state is not None:
        parts.append(state)
    if n_kf is not None:
        parts.append(f"KFs: {n_kf}")
    if n_lm is not None:
        parts.append(f"MPs: {n_lm}")
    parts.append(f"Matches: {n_matches}")
    return {"keypoints": uv[np.asarray(valid, bool)], "tracked": pts_t,
            "caption": " | ".join(parts)}


def render_frame(gray: np.ndarray, content: dict, path: str) -> str:
    """The gray image under a status bar of ``BAR_H`` rows, keypoints as
    green rings, tracked ones as red crosses."""
    g = np.clip(np.asarray(gray, np.float32), 0, 255).astype(np.uint8)
    h, w = g.shape
    cv = raster.Canvas(h + BAR_H, w, bg=raster.BLACK)
    cv.img[BAR_H:] = g[..., None]
    shift = np.array([0.0, BAR_H])
    cv.markers(content["keypoints"] + shift, raster.GREEN, radius=3, shape="ring")
    cv.crosses(content["tracked"] + shift, raster.RED, size=3)
    cv.text(4, 3 * BAR_SCALE // 2, content["caption"], raster.WHITE, scale=BAR_SCALE)
    return cv.save(path)


def draw_frame(gray: np.ndarray, uv: np.ndarray, valid: np.ndarray,
               tracked: Optional[np.ndarray] = None, path: str = "frame.png",
               state: Optional[str] = None, n_kf: Optional[int] = None,
               n_lm: Optional[int] = None):
    """Keypoint overlay (``FrameDrawer::DrawFrame``): detected keypoints in
    green, tracked map-point matches as red crosses, the reference's status
    bar above the image."""
    return render_frame(gray, frame_content(uv, valid, tracked, state, n_kf, n_lm), path)


def draw_frame_from_system(system, gray: np.ndarray, path: str = "frame.png",
                           keypoints: Optional[tuple] = None):
    """The System's current frame (the per-frame ``FrameDrawer::Update``,
    reference ``Tracking.cc:2235``). ``keypoints``: (uv, valid) already on
    the host (the live viewer copies them on its own stream); else the
    tracker's last features come to the host in one copy on the current
    stream, wherever they lie."""
    from orb_slam3_rgbl_tpu_torch.slam import tracking as trk

    t = system.tracker
    if t is None or (keypoints is None and t.last_feats is None):
        return draw_frame(gray, np.zeros((0, 2)), np.zeros(0, bool), path=path)
    if keypoints is None:
        feats = t.last_feats
        both = torch.cat([torch.as_tensor(feats.uv).reshape(-1, 2).float(),
                          torch.as_tensor(feats.valid).reshape(-1, 1).float()], 1).cpu().numpy()
        keypoints = both[:, :2], both[:, 2] > 0
    tracked = None if t.cur_lm_idx is None else np.asarray(t.cur_lm_idx) >= 0
    return draw_frame(
        gray, *keypoints, tracked=tracked,
        state=trk.STATE_NAMES.get(t.state, str(t.state)),
        n_kf=system.map.n_kf if system.map is not None else 0,
        n_lm=system.map.n_lm if system.map is not None else 0,
        path=path,
    )


# ---- the 3-D map (MapDrawer::DrawMapPoints / DrawKeyFrames) -----------------------------
def _frustum_segments(Twc: np.ndarray, scale: float = 0.6):
    """Camera frustum wireframe segments (``MapDrawer::DrawKeyFrames``
    geometry, ``src/MapDrawer.cc:178``): apex + 4 image-plane corners."""
    w, h, z = 0.5 * scale, 0.3 * scale, 0.4 * scale
    corners = np.array([
        [0, 0, 0], [w, h, z], [-w, h, z], [-w, -h, z], [w, -h, z]
    ], np.float32)
    q, t = Twc[:4], Twc[4:7]
    pts = lie.np_quat_rotate(q[None, :], corners) + t
    idx = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return [(pts[a], pts[b]) for a, b in idx]


def _plot3(p: np.ndarray) -> np.ndarray:
    """World (..., 3) → plot coordinates (x, z, −y), as the JAX view draws."""
    p = np.asarray(p, np.float64)
    return np.stack([p[..., 0], p[..., 2], -p[..., 1]], -1)


def map3d_content(map_state: MapState, trajectory: Optional[np.ndarray] = None,
                  loop_edges: Optional[list] = None, draw_graph: bool = True,
                  frustum_scale: float = 0.6) -> dict:
    """What ``plot_map_3d`` draws, in plot coordinates (x, z, −y):
    ``landmarks`` (n, 3), ``frusta`` (8k, 2, 3) segments, the spanning
    ``chain`` (k, 3) of keyframe centres, ``covisibility`` (e, 2, 3) pairs
    with ``covisibility_matrix`` weight ≥ 100 (upper triangle, more than 2
    keyframes, with ``draw_graph``), ``loops`` (l, 2, 3) between keyframes
    of ``loop_edges``, ``trajectory`` (t, 3) or None."""
    lms = map_state.lm_pos[map_state.lm_valid]
    kfs = map_state.valid_kf_ids()
    frusta, chain = np.zeros((0, 2, 3)), np.zeros((0, 3))
    covis, loops = np.zeros((0, 2, 3)), np.zeros((0, 2, 3))
    if len(kfs):
        Twc = np.asarray(lie.np_se3_inv(np.asarray(map_state.kf_pose[kfs], np.float32)))
        frusta = np.asarray([[a, b] for T in Twc for a, b in _frustum_segments(T, frustum_scale)])
        centers = Twc[:, 4:7]
        chain = centers
        if draw_graph and len(kfs) > 2:
            _, W = map_state.covisibility_matrix()
            hi, hj = np.nonzero(np.triu(W >= COVISIBILITY_MIN, k=1))
            covis = np.stack([centers[hi], centers[hj]], 1)
        if loop_edges:
            slot = {int(k): i for i, k in enumerate(kfs)}
            pairs = [(slot[int(e[0])], slot[int(e[1])]) for e in loop_edges
                     if int(e[0]) in slot and int(e[1]) in slot]
            if pairs:
                a, b = np.asarray(pairs).T
                loops = np.stack([centers[a], centers[b]], 1)
    traj = None
    if trajectory is not None and len(trajectory):
        traj = np.asarray(trajectory)[:, 4:7]
    return {"landmarks": _plot3(np.asarray(lms).reshape(-1, 3)), "frusta": _plot3(frusta),
            "chain": _plot3(chain), "covisibility": _plot3(covis), "loops": _plot3(loops),
            "trajectory": None if traj is None else _plot3(traj)}


def render_map_3d(content: dict, path: str, size=MAP_3D_SIZE) -> str:
    """The content seen obliquely (azimuth −60°, elevation 30°), fitted."""
    w, h = size
    cv = raster.Canvas(h, w)
    proj = raster.oblique()

    def segs(key):
        s = content[key].reshape(-1, 3)
        return proj(s).reshape(-1, 2, 2)

    pts = [proj(content["landmarks"]), proj(content["chain"]), segs("frusta").reshape(-1, 2)]
    if content["trajectory"] is not None:
        pts.append(proj(content["trajectory"]))
    to_px = raster.fit_view(pts, size)
    cv.markers(to_px(proj(content["landmarks"])), raster.GRAY)
    for key, color in (("covisibility", raster.OLIVE), ("frusta", raster.BLUE),
                       ("loops", raster.RED)):
        s = segs(key)
        if len(s):
            cv.lines(to_px(s[:, 0]), to_px(s[:, 1]), color)
    cv.polyline(to_px(proj(content["chain"])), raster.DARK_GREEN)
    if content["trajectory"] is not None:
        cv.polyline(to_px(proj(content["trajectory"])), raster.RED)
    cv.text(6, h - 14, "x [m]  z [m]  -y [m]", raster.BLACK)
    return cv.save(path)


def plot_map_3d(map_state: MapState, trajectory: Optional[np.ndarray] = None,
                loop_edges: Optional[list] = None, path: str = "map3d.png",
                draw_graph: bool = True, frustum_scale: float = 0.6):
    """3-D map view, the offline analog of the Pangolin window
    (``MapDrawer::DrawMapPoints`` / ``DrawKeyFrames`` and the graph toggle
    of ``Viewer::Run``): landmarks, keyframe frusta, the sequential spanning
    chain, strong covisibility edges and loop / merge constraints."""
    return render_map_3d(map3d_content(map_state, trajectory, loop_edges, draw_graph,
                                       frustum_scale), path)


class ViewerSession:
    """Periodic offline rendering during a run, the deployment analog of the
    reference ``Viewer`` thread (``System.cc:236-244``): every ``every``
    frames it saves the FrameDrawer overlay and a map view into ``out_dir``
    (numbered PNG series), off the tracking path."""

    def __init__(self, out_dir: str, every: int = 20, map_3d: bool = True):
        self.out_dir = out_dir
        self.every = max(1, every)
        self.map_3d = map_3d
        self.count = 0
        os.makedirs(out_dir, exist_ok=True)

    def update(self, system, gray: Optional[np.ndarray] = None):
        i = self.count
        self.count += 1
        if i % self.every:
            return None
        outs = []
        if gray is not None:
            outs.append(draw_frame_from_system(
                system, host_image(gray),
                path=os.path.join(self.out_dir, f"frame_{i:06d}.png")))
        if system.map is not None and system.map.n_kf:
            loop_edges = (system.loop_closer.extra_edges
                          if system.loop_closer is not None else None)
            render = plot_map_3d if self.map_3d else plot_map
            kw = dict(loop_edges=loop_edges) if self.map_3d else {}
            outs.append(render(
                system.map, trajectory=None,
                path=os.path.join(self.out_dir, f"map_{i:06d}.png"), **kw))
        return outs
