"""Port vs JAX: the RGB-D sensor — ``frame.attach_depth_map``, the fused
step in its 'rgbd' mode, ``System.track_rgbd`` on the fused path, and the
per-stage path of a distorted camera (keypoints undistorted after the depth
is sampled at the raw pixel).

Both packages see the same frames: the JAX package's rendered 320×192
canyon with its rendered depth images (``synthetic.render_depth``). For the
distorted camera the frames are warped through its radial-tangential model
(``cv2.remap``: bilinear for the image, nearest for depth). JAX runs with
x64 off, as outside the test suite (see test_torch_frame).

Tolerances: ``attach_depth_map``'s depths exact (a gather and one f32
division), its pseudo-stereo column to 1e-4 absolute, where XLA fuses
u − bf/d (7.6e-6 observed; test_torch_depth_match.py's bar);
the fused step as test_torch_step.py holds it (slot depths 1e-6 where the
two extractions put the same keypoint, pose 1e-3); the drives as
test_torch_system.py holds them (the same states and keyframes on every
frame, inliers within 5%, camera centres within 5 mm)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu.config import RGBD
from orb_slam3_rgbl_tpu.ops import fast as j_fast
from orb_slam3_rgbl_tpu.slam import frame as j_frame
from orb_slam3_rgbl_tpu.slam.fast_path import FastPath as JFastPath
from orb_slam3_rgbl_tpu.slam.map_state import MapState as JMapState
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu.slam.tracking import Tracker as JTracker
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import camera as t_cam
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from orb_slam3_rgbl_tpu_torch.slam import frame as t_frame
from orb_slam3_rgbl_tpu_torch.slam import tracking as t_trk
from orb_slam3_rgbl_tpu_torch.slam.fast_path import FastPath as TFastPath
from orb_slam3_rgbl_tpu_torch.slam.system import System as TSystem

from test_torch_system import one_torch_thread  # noqa: F401  (autouse)

N_DRIVE = 12
N_DISTORTED = 6
POSE_TOL_M = 5e-3
IDENTITY = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
DISTORTION = dict(k1=0.02, k2=-0.01, p1=1e-3, p2=-5e-4)


def _config(distorted=False):
    cfg = dataclasses.replace(j_syn.synthetic_rgbl_config(loop_closing=False), sensor=RGBD)
    if distorted:
        cfg = dataclasses.replace(cfg, camera=dataclasses.replace(cfg.camera, **DISTORTION))
    return cfg


@pytest.fixture(scope="module")
def frames():
    cfg = _config()
    cam = cfg.camera
    traj = j_syn.straight_trajectory(N_DRIVE, step=0.6, weave=0.4)
    out = []
    with jax.enable_x64(False):
        world = j_syn.make_world(0, tex_size=256)
        for Twc in traj:
            T = jnp.asarray(Twc)
            args = (world, T, cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width)
            out.append((np.array(j_syn.render_image(*args)), np.array(j_syn.render_depth(*args))))
    return traj, out


def _warp(frames, cam):
    """Frames as the distorted camera sees them: each of its pixels samples
    the pinhole image where its undistorted coordinate lands."""
    cv2 = pytest.importorskip("cv2")
    v, u = np.mgrid[0:cam.height, 0:cam.width].astype(np.float32)
    src = t_cam.undistort_points(cam, torch.from_numpy(np.stack([u, v], -1))).numpy()
    mx, my = np.ascontiguousarray(src[..., 0]), np.ascontiguousarray(src[..., 1])
    return [(cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REPLICATE),
             cv2.remap(dep, mx, my, cv2.INTER_NEAREST, borderMode=cv2.BORDER_REPLICATE))
            for img, dep in frames]


def _systems(cfg):
    js = JSystem(cfg)
    ts = TSystem(convert.config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    return js, ts


def _drive(js, ts, frames, force_kf_every=0):
    log = []
    with jax.enable_x64(False):
        for i, (img, dep) in enumerate(frames):
            rj, rt = js.track_rgbd(img, dep, i * 0.1), ts.track_rgbd(img, dep, i * 0.1)
            for s in (js, ts):
                s.tracker.force_kf_every = force_kf_every
            log.append((rj, rt, js.map.n_kf, ts.map.n_kf))
    return log


def _check_drive(log, traj, max_err):
    for i, (rj, rt, kj, kt) in enumerate(log):
        assert rj.state == rt.state == t_trk.OK, i
        assert rj.created_kf == rt.created_kf and kj == kt, i
        assert abs(rt.n_inliers - rj.n_inliers) <= 0.05 * rj.n_inliers, (i, rj.n_inliers,
                                                                         rt.n_inliers)
    c_j = t_lie.np_se3_centers(np.stack([r[0].pose for r in log]))
    c_t = t_lie.np_se3_centers(np.stack([r[1].pose for r in log]))
    assert np.abs(c_t - c_j).max() < POSE_TOL_M, np.abs(c_t - c_j).max()
    gt = traj[: len(log), 4:7] - traj[0, 4:7]
    assert np.linalg.norm(c_t - gt, axis=1).max() < max_err


def test_render_depth_matches_jax():
    """The port's ``synthetic.render_depth`` against the JAX function that
    renders this file's depth frames, on the same canyon (its planes; the
    depth reads no texture) from three poses: the same hits, depths within
    2e-5 relative (an einsum and a division in each library's order)."""
    from orb_slam3_rgbl_tpu_torch import synthetic as t_syn

    cam = _config().camera
    traj = j_syn.straight_trajectory(3, step=4.0, weave=1.0, yaw_rate=0.2)
    world_t = t_syn.make_world(0, tex_size=8, device="cpu")
    with jax.enable_x64(False):
        world_j = j_syn.make_world(0, tex_size=8)
        for Twc in traj:
            args = (Twc, cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width)
            d_j = np.asarray(j_syn.render_depth(world_j, jnp.asarray(Twc), *args[1:]))
            d_t = t_syn.render_depth(world_t, *args).numpy()
            np.testing.assert_array_equal(d_t > 0, d_j > 0)
            np.testing.assert_allclose(d_t, d_j, rtol=2e-5, atol=0)
            assert (d_t > 0).mean() > 0.9


def test_attach_depth_map_exact():
    rng = np.random.default_rng(2)
    N, H, W = 500, 48, 80
    uv = np.stack([rng.uniform(-2, W + 2, N), rng.uniform(-2, H + 2, N)], 1).astype(np.float32)
    depth = np.where(rng.uniform(size=(H, W)) < 0.3, 0.0,
                     rng.uniform(0.5, 80.0, (H, W))).astype(np.float32) * 256.0
    feats = {"uv": uv, "response": np.zeros(N, np.float32), "octave": np.zeros(N, np.int32),
             "angle": np.zeros(N, np.float32), "desc": np.zeros((N, 8), np.uint32),
             "valid": rng.uniform(size=N) < 0.8, "depth": np.full(N, -1.0, np.float32),
             "u_right": np.full(N, -1.0, np.float32)}
    with jax.enable_x64(False):
        jf = j_frame.FrameFeatures(**{k: jnp.asarray(v) for k, v in feats.items()})
        ref = j_frame.attach_depth_map(jf, jnp.asarray(depth), 96.0, depth_factor=256.0)
    out = t_frame.attach_depth_map(convert.frame_features_from_numpy(feats, "cpu"),
                                   torch.from_numpy(depth), 96.0, depth_factor=256.0)
    np.testing.assert_array_equal(out.depth.numpy(), np.asarray(ref.depth))
    # XLA fuses u − bf/d (test_torch_depth_match.py's bar)
    np.testing.assert_allclose(out.u_right.numpy(), np.asarray(ref.u_right), atol=1e-4, rtol=0)
    assert ((out.u_right.numpy() == -1) == (np.asarray(ref.u_right) == -1)).all()
    assert (out.depth.numpy()[~feats["valid"]] == -1).all()


def test_rgbd_step_matches_jax_on_identical_state(frames):
    _, fr = frames
    cfg = _config()
    n_feat = sum(j_fast.features_per_level(cfg.orb.n_features, cfg.orb.n_levels,
                                           cfg.orb.scale_factor))
    (img0, dep0), (img1, dep1) = fr[0], fr[1]
    with jax.enable_x64(False):
        jt = JTracker(cfg, JMapState.create(64, 8192, n_feat))
        jt.fast = JFastPath(cfg, n_feat, mode="rgbd")
        jt.track_image_rgbd(jnp.asarray(img0), jnp.asarray(dep0), 0.0)
        jfp = jt.fast
        jfp.sync(jt.map, jt.ref_kf, jt.last_feats, jt.last_lm_idx, jt.last_lm_gen)
        state = {k: np.asarray(getattr(jfp, k)) for k in convert.FAST_PATH_STATE}
        out_j = jax.tree_util.tree_map(
            np.asarray, jfp.run(jnp.asarray(img1), jnp.asarray(dep1), None, IDENTITY))
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    tfp = convert.fast_path_state_from_numpy(TFastPath(tcfg, n_feat, mode="rgbd", device="cpu"),
                                             state)
    out_t = tfp.run(img1, dep1, None, IDENTITY)
    assert int(out_j.n_inliers) > 100
    same = (out_t.feats.uv.numpy() == out_j.feats.uv).all(1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(out_t.feats.depth.numpy()[same], out_j.feats.depth[same], atol=1e-6)
    np.testing.assert_allclose(out_t.feats.u_right.numpy()[same], out_j.feats.u_right[same],
                               atol=1e-4)
    for name in ("bind_prev", "bind_win"):
        assert np.mean(getattr(out_t, name).numpy() == getattr(out_j, name)) >= 0.95, name
    assert abs(int(out_t.n_inliers) - int(out_j.n_inliers)) <= 0.05 * int(out_j.n_inliers)
    np.testing.assert_allclose(out_t.Tcw.numpy(), out_j.Tcw, atol=1e-3)


def test_track_rgbd_drive_matches_jax(frames):
    """Mapping on, a keyframe forced every 4 frames: frame 1 on the classic
    ladder, every later frame on the fused step in 'rgbd' mode."""
    traj, fr = frames
    js, ts = _systems(_config())
    log = _drive(js, ts, fr, force_kf_every=4)
    _check_drive(log, traj, max_err=0.1)
    assert ts._fast is not None and ts._fast.mode == js._fast.mode == "rgbd"
    assert log[-1][3] >= 3


def test_distorted_rgbd_drive_takes_the_per_stage_path(frames):
    traj, fr = frames
    cfg = _config(distorted=True)
    js, ts = _systems(cfg)
    assert ts._undistort_cam is not None and not ts.cam.has_distortion
    warped = _warp(fr[:N_DISTORTED], t_cam.PinholeCamera(**dataclasses.asdict(cfg.camera)))
    log = _drive(js, ts, warped, force_kf_every=3)
    _check_drive(log, traj, max_err=0.1)
    # never the fused step: no FastPath on either side
    assert ts._fast is None and js._fast is None
