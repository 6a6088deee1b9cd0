"""Port vs JAX: ``System.track_rgbl`` in the tracking-only configuration
(``enable_mapping=False``, ``loop_closing=False``, ``CLOUD_CAP = 16384``)
on the 320×192 synthetic canyon, frame by frame: forced keyframes, a
backward timestamp, the classic-only branch, the configurations that are
refused, and the map queries. The natural-policy drive with its blank
stretch is in test_torch_system_lost.py, the ladder's stages on identical
state in test_torch_ladder.py; both import the helpers here.

The drives with the mapping plane on are in test_torch_system_mapping.py.

Both systems see the same rendered frames (the JAX package's world). JAX
runs with x64 off, as outside the test suite (see test_torch_frame).

Tolerances. The two extractions agree on ~99% of slots and the pose
solves to ~1e-5 m on identical bindings (test_torch_step), so states,
keyframe decisions and keyframe counts are held exactly, inliers to 5%,
and per-frame camera centers to 5 mm, test_torch_step.py's bar for the
fused drive: on these drives the packages stay within 0.1 mm (forced
keyframes) and 2 mm (natural policy), so the bar needed no widening."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from orb_slam3_rgbl_tpu_torch.slam import tracking as t_trk
from orb_slam3_rgbl_tpu_torch.slam.system import System as TSystem

CLOUD_CAP = 16384
POSE_TOL_M = 5e-3
N_FORCED = 20


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite's workers share the machine's cores, and XLA already uses
    them all: one torch intra-op thread per worker keeps the port's small
    CPU ops from oversubscribing them (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _render(traj):
    cfg = j_syn.synthetic_rgbl_config(loop_closing=False)
    cam = cfg.camera
    with jax.enable_x64(False):
        world = j_syn.make_world(0, tex_size=256)
        frames = []
        for Twc in traj:
            Twc = jnp.asarray(Twc)
            img = np.array(j_syn.render_image(world, Twc, cam.fx, cam.fy, cam.cx, cam.cy,
                                              cam.height, cam.width))
            frames.append((img, np.array(j_syn.lidar_scan(world, Twc, n_az=256, n_el=48))))
    return cfg, frames


def _systems(cfg):
    js = JSystem(cfg, enable_mapping=False)
    ts = TSystem(convert.config_from_dict(dataclasses.asdict(cfg)), enable_mapping=False,
                 device="cpu")
    js.CLOUD_CAP = ts.CLOUD_CAP = CLOUD_CAP
    return js, ts


def _drive(js, ts, frames, t0=0, force_kf_every=0, log=None):
    """Feed ``frames`` to both systems; returns per-frame (JAX, port)
    TrackResults and map keyframe counts."""
    log = [] if log is None else log
    with jax.enable_x64(False):
        for i, (img, pts) in enumerate(frames):
            t = (t0 + i) * 0.1
            rj, rt = js.track_rgbl(img, pts, t), ts.track_rgbl(img, pts, t)
            for s in (js, ts):
                s.tracker.force_kf_every = force_kf_every
            log.append((rj, rt, js.map.n_kf, ts.map.n_kf))
    return log


@pytest.fixture(scope="module")
def forced():
    """20 frames with a keyframe every 3, then one frame whose timestamp
    goes backward."""
    traj = j_syn.straight_trajectory(N_FORCED + 1, step=0.6, weave=0.4)
    cfg, frames = _render(traj)
    js, ts = _systems(cfg)
    log = _drive(js, ts, frames[:N_FORCED], force_kf_every=3)
    maps_before = (js.atlas.n_maps(), ts.atlas.n_maps())
    back = _drive(js, ts, frames[N_FORCED:], t0=-1)
    return traj, js, ts, log, maps_before, back


def _centers(results):
    return t_lie.np_se3_centers(np.stack([r.pose for r in results]))


def test_forced_keyframe_drive_matches_jax_frame_by_frame(forced):
    _, js, ts, log, _, _ = forced
    for i, (rj, rt, kj, kt) in enumerate(log):
        assert rj.state == rt.state == t_trk.OK, i
        assert rj.created_kf == rt.created_kf and kj == kt, i
        assert abs(rt.n_inliers - rj.n_inliers) <= 0.05 * rj.n_inliers, (i, rj.n_inliers, rt.n_inliers)
    assert log[-1][3] >= 7          # frame 0, then every 3rd frame
    c_j = _centers([r[0] for r in log])
    c_t = _centers([r[1] for r in log])
    assert np.abs(c_t - c_j).max() < POSE_TOL_M, np.abs(c_t - c_j).max()
    np.testing.assert_allclose(np.stack([r[1].pose for r in log])[:, :4],
                               np.stack([r[0].pose for r in log])[:, :4], atol=1e-3)


def test_backward_timestamp_starts_a_new_map(forced):
    _, js, ts, _, maps_before, back = forced
    assert maps_before == (1, 1)
    assert js.atlas.n_maps() == ts.atlas.n_maps() == 2
    (rj, rt, kj, kt), = back
    # the restarted stream initializes the new map on its first frame
    assert rj.state == rt.state == t_trk.OK and kj == kt == 1
    assert ts.tracker.frame_id == js.tracker.frame_id == N_FORCED
    assert len(ts.trajectory()) == len(js.trajectory()) == N_FORCED + 1


def test_classic_only_drive_matches_jax():
    """``use_fused = False``: every frame takes the classic ladder on the
    raw (unpadded) cloud, on both sides, with the same results."""
    traj = j_syn.straight_trajectory(6, step=0.6, weave=0.4)
    cfg, frames = _render(traj)
    js, ts = _systems(cfg)
    js.use_fused = ts.use_fused = False
    log = _drive(js, ts, frames, force_kf_every=2)
    assert ts._fast is None and ts.tracker.fast is None
    for i, (rj, rt, kj, kt) in enumerate(log):
        assert rj.state == rt.state == t_trk.OK and rj.created_kf == rt.created_kf, i
        assert abs(rt.n_inliers - rj.n_inliers) <= 0.05 * rj.n_inliers, i
    assert np.abs(_centers([r[1] for r in log]) - _centers([r[0] for r in log])).max() < POSE_TOL_M


@pytest.mark.parametrize("change, item", [
    (dict(sensor=2), "items 14 and 17"),                   # RGBD
    (dict(sensor=1), "items 14 and 17"),                   # STEREO
    (dict(sensor=0), "items 14 and 17"),                   # MONOCULAR
    (dict(sensor=5), "item 15"),                           # IMU_RGBD
    (dict(distorted=True), "item 17"),
])
def test_system_refuses_unported_configurations(change, item):
    from orb_slam3_rgbl_tpu_torch import synthetic as t_syn

    cfg = dataclasses.replace(t_syn.synthetic_rgbl_config(), loop_closing=False)
    if change.pop("distorted", False):
        cfg = dataclasses.replace(cfg, camera=dataclasses.replace(cfg.camera, k1=0.1))
    cfg = dataclasses.replace(cfg, **change)
    # with the mapping plane on (the default) and with it off
    for enable_mapping in (True, False):
        with pytest.raises(NotImplementedError, match=item):
            TSystem(cfg, enable_mapping=enable_mapping, device="cpu")
    # loop closing, the atlas weld and the tree vocabulary are ported: the default
    # configuration constructs (tests/test_torch_merge.py, tests/test_torch_tree_vocab.py)
    default = t_syn.synthetic_rgbl_config()
    assert default.loop_closing and not default.vocab_path
    assert TSystem(default, device="cpu").loop_closer is None     # built on the first frame


def test_map_state_queries_match_jax():
    """The map queries that tracking and export read, on a JAX map with a
    culled keyframe (its redirect to a parent) copied through
    ``convert.map_state_from_numpy``: equal results."""
    from orb_slam3_rgbl_tpu.slam.map_state import MapState as JMapState

    rng = np.random.default_rng(5)
    jm = JMapState.create(8, 64, 16, map_id=3)
    with jax.enable_x64(False):
        for k in range(4):
            q = rng.normal(size=4)
            pose = np.concatenate([q / np.linalg.norm(q), rng.normal(size=3)]).astype(np.float32)
            lm = np.full(16, -1, np.int32)
            if k:
                lm[:8] = np.arange(8) + 4 * (k - 1)
            kf = jm.add_keyframe(pose, rng.normal(size=(16, 2)), np.zeros(16, np.int16),
                                 rng.integers(0, 2 ** 32, (16, 8), dtype=np.uint32),
                                 np.ones(16, np.float32), -np.ones(16, np.float32),
                                 np.ones(16, bool), lm, 0.1 * k, k)
            ids = jm.add_landmarks(rng.normal(size=(4, 3)).astype(np.float32),
                                   rng.integers(0, 2 ** 32, (4, 8), dtype=np.uint32), kf,
                                   np.arange(12, 16), np.ones((4, 3), np.float32),
                                   np.ones(4, np.float32), np.ones(4, np.float32))
            assert len(ids) == 4
        jm.remove_keyframe(2)
        ref_poses = [np.asarray(jm.effective_kf_pose(k)) for k in range(4)]
    tm = convert.map_state_from_numpy(jm)
    assert tm.map_id == 3 and tm.n_features == 16 and 2 in tm.kf_redirect
    for k in range(4):
        assert tm.live_ref_kf(k) == jm.live_ref_kf(k)
        np.testing.assert_allclose(tm.effective_kf_pose(k), ref_poses[k], atol=1e-6)
    np.testing.assert_array_equal(tm.observation_counts(), jm.observation_counts())
    tm.refresh_free_list()
    jm.refresh_free_list()
    assert tm.lm_free == jm.lm_free
