"""Port vs JAX: the fused tracking step on identical inputs and identical
``FastPath`` state (loaded through ``convert``), then a synthetic drive
through both packages' trackers: the first frame after initialization on
the classic ladder, keyframes by the natural policy, every later frame
fused. JAX runs with x64 off, as outside the test suite (see
test_torch_frame)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu.ops import fast as j_fast
from orb_slam3_rgbl_tpu.slam import compiled as j_compiled
from orb_slam3_rgbl_tpu.slam.fast_path import FastPath as JFastPath
from orb_slam3_rgbl_tpu.slam.map_state import MapState as JMapState
from orb_slam3_rgbl_tpu.slam.tracking import Tracker as JTracker
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from orb_slam3_rgbl_tpu_torch.slam import compiled as t_compiled
from orb_slam3_rgbl_tpu_torch.slam.fast_path import FastPath as TFastPath
from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState as TMapState
from orb_slam3_rgbl_tpu_torch.slam import tracking as t_trk
from orb_slam3_rgbl_tpu_torch.slam.tracking import Tracker as TTracker
from test_torch_system import one_torch_thread  # noqa: F401  (autouse)

N_FRAMES = 10
IDENTITY = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)


@pytest.fixture(scope="module")
def drive_data():
    cfg = j_syn.synthetic_rgbl_config()
    cam = cfg.camera
    traj = j_syn.straight_trajectory(N_FRAMES, step=0.6, weave=0.4)
    with jax.enable_x64(False):
        world = j_syn.make_world(0, tex_size=256)
        frames = []
        for Twc in traj:
            Twc = jnp.asarray(Twc)
            img = np.array(j_syn.render_image(world, Twc, cam.fx, cam.fy, cam.cx, cam.cy,
                                              cam.height, cam.width))
            pts = np.array(j_syn.lidar_scan(world, Twc, n_az=256, n_el=48))
            frames.append((img, pts, np.ones(len(pts), bool)))
    n_feat = sum(j_fast.features_per_level(cfg.orb.n_features, cfg.orb.n_levels,
                                           cfg.orb.scale_factor))
    return cfg, traj, frames, n_feat


def _jax_tracker(cfg, n_feat):
    jt = JTracker(cfg, JMapState.create(64, 8192, n_feat))
    jt.fast = JFastPath(cfg, n_feat)
    return jt


def _port_tracker(cfg, n_feat):
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    tt = TTracker(tcfg, TMapState.create(64, 8192, n_feat), device="cpu")
    tt.fast = TFastPath(tcfg, n_feat, device="cpu")
    return tt


def test_track_step_matches_jax_on_identical_state(drive_data):
    cfg, _, frames, n_feat = drive_data
    img1, pts1, mask1 = frames[1]
    with jax.enable_x64(False):
        jt = _jax_tracker(cfg, n_feat)
        jt.track_image_rgbl(*(jnp.asarray(a) for a in frames[0]), 0.0)
        jfp = jt.fast
        jfp.sync(jt.map, jt.ref_kf, jt.last_feats, jt.last_lm_idx, jt.last_lm_gen)
        state = {k: np.asarray(getattr(jfp, k)) for k in convert.FAST_PATH_STATE}
        out_j = jfp.run(jnp.asarray(img1), jnp.asarray(pts1), jnp.asarray(mask1), IDENTITY)
        out_j = jax.tree_util.tree_map(np.asarray, out_j)

    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    tfp = convert.fast_path_state_from_numpy(TFastPath(tcfg, n_feat, device="cpu"), state)
    np.testing.assert_array_equal(tfp.win_desc.numpy().view(np.uint32), state["win_desc"])
    out_t = tfp.run(img1, pts1, mask1, IDENTITY)

    assert int(out_j.n_inliers) > 100
    # extraction agrees to ~99% of slots (test_torch_frame); bindings
    # follow the features: ≥ 95% of slots carry the same binding
    for name in ("bind_prev", "bind_win"):
        agree = np.mean(getattr(out_t, name).numpy() == getattr(out_j, name))
        assert agree >= 0.95, (name, agree)
    assert abs(int(out_t.n_inliers) - int(out_j.n_inliers)) <= 0.05 * int(out_j.n_inliers)
    # both solves converge on nearly the same inliers: 1e-3 on the unit
    # quaternion and on metres
    np.testing.assert_allclose(out_t.Tcw.numpy(), out_j.Tcw, atol=1e-3)
    assert int(out_t.n_mm_inliers) >= 10     # the motion-model stage carried


def test_drive_matches_jax_tracker(drive_data):
    cfg, traj, frames, n_feat = drive_data
    tt = _port_tracker(cfg, n_feat)
    poses_j, poses_t, inl_j, inl_t = [], [], [], []
    fused_j, fused_t = [], []
    with jax.enable_x64(False):
        jt = _jax_tracker(cfg, n_feat)
        for i, (img, pts, mask) in enumerate(frames):
            # a frame that starts with a velocity and state OK takes the fused step
            fused_j.append(jt.velocity is not None and jt.state == 2)
            fused_t.append(tt.velocity is not None and tt.state == 2)
            rj = jt.track_image_rgbl(jnp.asarray(img), jnp.asarray(pts), jnp.asarray(mask), i * 0.1)
            rt = tt.track_image_rgbl(img, pts, mask, i * 0.1)
            assert rj.state == rt.state == 2
            assert rj.created_kf == rt.created_kf, i
            poses_j.append(rj.pose)
            poses_t.append(rt.pose)
            inl_j.append(rj.n_inliers)
            inl_t.append(rt.n_inliers)
    # frames 0 and 1 on the classic ladder (initialization, then no
    # velocity yet), every later frame fused, on both sides
    assert fused_j == fused_t == [False, False] + [True] * (N_FRAMES - 2)
    assert jt.map.n_kf == tt.map.n_kf
    c_j = t_lie.np_se3_centers(np.stack(poses_j))
    c_t = t_lie.np_se3_centers(np.stack(poses_t))
    # per-frame poses: 5 mm between the packages, inlier counts within 5%
    assert np.abs(c_t - c_j).max() < 5e-3, np.abs(c_t - c_j).max()
    np.testing.assert_allclose(np.stack(poses_t)[:, :4], np.stack(poses_j)[:, :4], atol=1e-3)
    assert np.all(np.abs(np.array(inl_t) - inl_j) <= 0.05 * np.array(inl_j))
    assert min(inl_t[1:]) >= 30
    # and both stay on the ground truth
    gt = traj[:, 4:7] - traj[0, 4:7]
    assert np.linalg.norm(c_t - gt, axis=1).max() < 0.15


def test_frame_step_and_example_inputs(drive_data):
    """``make_frame_step`` (brute-force mutual matching + one solve)
    against the JAX one, the previous frame being frame 0 with its
    depth-unprojected landmarks from the JAX tracker's initialization."""
    cfg, _, frames, n_feat = drive_data
    img1, pts1, _ = frames[1]
    with jax.enable_x64(False):
        jt = _jax_tracker(cfg, n_feat)
        jt.track_image_rgbl(*(jnp.asarray(a) for a in frames[0]), 0.0)
        prev_valid = jt.last_lm_idx >= 0
        prev_Xw = np.where(prev_valid[:, None], jt.map.lm_pos[np.clip(jt.last_lm_idx, 0, None)],
                           0.0).astype(np.float32)
        prev_desc = np.array(jt.last_feats.desc)
        T_j, n_j, _ = jax.jit(j_compiled.make_frame_step(cfg))(
            jnp.asarray(img1), jnp.asarray(pts1), jnp.asarray(prev_desc),
            jnp.asarray(prev_valid), jnp.asarray(prev_Xw), jnp.asarray(IDENTITY))
        shapes_j = [(a.shape, np.dtype(a.dtype)) for a in j_compiled.example_inputs(cfg, 1000)]
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    T_t, n_t, _ = t_compiled.make_frame_step(tcfg, device="cpu")(
        torch.from_numpy(img1), torch.from_numpy(pts1), torch.from_numpy(prev_desc.view(np.int32)),
        torch.from_numpy(prev_valid), torch.from_numpy(prev_Xw), torch.from_numpy(IDENTITY))
    assert int(n_j) > 100
    assert abs(int(n_t) - int(n_j)) <= 0.05 * int(n_j)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-3)   # as the track step
    # example inputs: the JAX shapes; uint32 descriptor words become int32
    shapes_t = [(tuple(a.shape), a.numpy().dtype) for a in t_compiled.example_inputs(tcfg, 1000, device="cpu")]
    assert [s for s, _ in shapes_t] == [s for s, _ in shapes_j]
    assert [d for _, d in shapes_t] == [np.dtype(np.int32) if d == np.uint32 else d for _, d in shapes_j]


def test_textureless_frame_sends_both_trackers_to_recently_lost(drive_data):
    """A fused frame that keeps fewer than 30 inliers goes to the classic
    ladder on both sides, which fails on a blank image: OK → RECENTLY_LOST,
    then LOST (relocalization has no keyframe database here)."""
    cfg, _, frames, n_feat = drive_data
    tt = _port_tracker(cfg, n_feat)
    blank = np.full_like(frames[2][0], 12.0)          # textureless: no corners
    states_j, states_t = [], []
    with jax.enable_x64(False):
        jt = _jax_tracker(cfg, n_feat)
        for i, img in enumerate([frames[0][0], frames[1][0], blank, blank]):
            pts, mask = frames[i][1], frames[i][2]
            rj = jt.track_image_rgbl(jnp.asarray(img), jnp.asarray(pts), jnp.asarray(mask), i * 0.1)
            rt = tt.track_image_rgbl(img, pts, mask, i * 0.1)
            states_j.append(rj.state)
            states_t.append(rt.state)
    assert states_t == states_j == [t_trk.OK, t_trk.OK, t_trk.RECENTLY_LOST, t_trk.LOST]
    assert tt.velocity is None and tt.traj_lost == [False, False, True, True]
