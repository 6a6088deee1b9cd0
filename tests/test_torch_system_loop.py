"""Port vs JAX: ``System(kitti_rgbl_config())`` — the default configuration,
mapping and loop closing on — through ``track_features`` on the 90-frame
circular feature drive of ``tests/test_loop_closing.py`` (600 features with
0.6 px of noise and 2% of depth noise a frame).

Held on every frame: tracking state ``OK`` on both and no binding fault.
Held on every frame up to and including the one that closes the loop (frame
84, keyframe 14 against keyframe 1, on both sides): the same keyframe
decision and the same keyframes alive; camera centres within 3 cm over the
first 40 frames (observed 1.2 cm) and within 6 cm up to the event (observed
4.1 cm). The event is pinned to what both packages give: the same frame and the
same ``(kf_cur, kf_matched)``.

That equality needs the module's one torch thread: keyframes are made when
the tracked close points fall to about 100, so a last-bit difference in a sum
can move a keyframe by a frame (with two threads the packages count 107
against 103 on frame 53 and part there). After the correction and the global
BA the two maps agree to millimetres, not bits, and the decisions part at
frame 87. So the frames after the event are held loosely, as a second layer
over the whole drive: the number of keyframes within one, every keyframe of
the port within one frame of one of JAX's, centres within 0.3 m (observed
4.1 cm with one thread and 18 cm with two, both sides within 25 cm of the
ground truth); the trajectory's ATE against
ground truth under 0.5 m on both, as the JAX test asks (observed 0.10 and
0.11 m).
The global BA runs 16 iterations on both sides: the JAX ``System``'s
synchronous branch would run its stale default of 6, so the test points its
``gba_dispatch`` at ``_global_ba(16)``.

JAX runs with x64 off, as outside the test suite."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu.geometry import align as j_align
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.config import kitti_rgbl_config as t_kitti_rgbl_config
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from orb_slam3_rgbl_tpu_torch.slam import map_state as t_ms
from orb_slam3_rgbl_tpu_torch.slam import system as t_system
from orb_slam3_rgbl_tpu_torch.slam import tracking as t_trk
from orb_slam3_rgbl_tpu_torch.slam.loop_closing import LoopCloser
from orb_slam3_rgbl_tpu_torch.slam.system import System as TSystem

from test_torch_loop_closing import N_FRAMES, feats_to_port, loop_drive_features


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def drive():
    cfg, feats, gt = loop_drive_features()
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    assert tcfg == t_kitti_rgbl_config() and tcfg.loop_closing and not tcfg.vocab_path
    js, ts = JSystem(cfg), TSystem(tcfg, device="cpu")      # nothing switched off
    log = []
    with jax.enable_x64(False):
        for i, f in enumerate(feats):
            rj = js.track_features(f, i * 0.1)
            if i == 0:
                js.loop_closer.gba_dispatch = lambda: js.loop_closer._global_ba(16)
            rt = ts.track_features(feats_to_port(f), i * 0.1)
            log.append((rj, rt, js.map.kf_valid.copy(), ts.map.kf_valid.copy(),
                        len(js.loop_closer.events), len(ts.loop_closer.events),
                        t_ms.check_binding_consistency(ts.map)))
    js.shutdown()
    ts.shutdown()
    return js, ts, log, gt


EVENT_FRAME, EVENT_KFS = 84, (14, 1)   # where both packages close the loop, and on what
CENTRE_TOL_TO_EVENT = 0.06


def _fired(log, col):
    return next(i for i, r in enumerate(log) if r[col])


def test_loop_drive_matches_jax_frame_by_frame(drive):
    js, ts, log, _ = drive
    assert isinstance(ts.loop_closer, LoopCloser) and ts.mapper is not None
    assert _fired(log, 4) == _fired(log, 5) == EVENT_FRAME
    for i, (rj, rt, kfs_j, kfs_t, ev_j, ev_t, faults) in enumerate(log):
        assert rj.state == rt.state == t_trk.OK, i
        assert faults == [], (i, faults)
        if i <= EVENT_FRAME:
            assert rj.created_kf == rt.created_kf, i
            np.testing.assert_array_equal(kfs_t, kfs_j, err_msg=f"keyframes alive after frame {i}")
    c_j = t_lie.np_se3_centers(np.stack([r[0].pose for r in log]))
    c_t = t_lie.np_se3_centers(np.stack([r[1].pose for r in log]))
    d = np.abs(c_t - c_j).max(axis=1)
    assert d[:40].max() < 0.03, d[:40].max()
    assert d[: EVENT_FRAME + 1].max() < CENTRE_TOL_TO_EVENT, d[: EVENT_FRAME + 1].max()
    # second layer, the whole drive: loose where the decisions have parted
    assert d.max() < 0.3, d.max()
    made_j = np.array([i for i, r in enumerate(log) if r[0].created_kf])
    made_t = np.array([i for i, r in enumerate(log) if r[1].created_kf])
    assert abs(len(made_t) - len(made_j)) <= 1 and len(made_t) >= 13, (made_j, made_t)
    inner = made_t[made_t < N_FRAMES - 6]      # the drive's end cuts the last interval
    assert np.abs(inner[:, None] - made_j[None, :]).min(axis=1).max() <= 1, (made_j, made_t)


def test_same_loop_event_and_trajectory_quality(drive):
    js, ts, log, gt = drive
    assert len(ts.loop_closer.events) == len(js.loop_closer.events) == 1
    e_t, e_j = ts.loop_closer.events[0], js.loop_closer.events[0]
    tm, jm = ts.map, js.map
    assert (e_t.kf_cur, e_t.kf_matched) == (e_j.kf_cur, e_j.kf_matched) == EVENT_KFS
    assert int(tm.kf_frame_id[e_t.kf_cur]) == int(jm.kf_frame_id[e_j.kf_cur]) == EVENT_FRAME
    assert int(tm.kf_frame_id[e_t.kf_matched]) == int(jm.kf_frame_id[e_j.kf_matched])
    assert tm.kf_frame_id[e_t.kf_cur] - tm.kf_frame_id[e_t.kf_matched] > 30
    # the two RANSACs draw from different streams
    assert abs(e_t.n_inliers - e_j.n_inliers) <= 0.1 * e_j.n_inliers
    assert _fired(log, 4) == _fired(log, 5) == EVENT_FRAME
    rec = ts.loop_closer.stats["events"][0]
    assert rec["pose_graph"] == "applied" and rec["gba"] == "applied"
    assert rec["pg_cost_after"] < rec["pg_cost_before"]
    assert rec["gba_cost_after"] < rec["gba_cost_before"]
    assert rec["fused_search"] > 0 and rec["fused_pairs"] > 0 and rec["edges"] >= rec["nodes"]
    assert ts.loop_closer.last_loop_kf == e_t.kf_cur and len(ts.loop_closer.extra_edges) == 1
    # every keyframe was indexed, in order
    assert [k["kf"] for k in ts.loop_closer.stats["keyframes"]] == list(range(tm.n_kf))
    assert ts.loop_closer.db.present[: tm.n_kf].all() and not ts.loop_closer.db.present[tm.n_kf:].any()
    gt_twc = t_lie.np_se3_inv(gt)
    with jax.enable_x64(False):
        ate_j = float(j_align.ate_rmse(jnp.asarray(gt_twc[:, 4:7]),
                                       jnp.asarray(js.trajectory()[:, 4:7])))
        ate_t = float(j_align.ate_rmse(jnp.asarray(gt_twc[:, 4:7]),
                                       jnp.asarray(ts.trajectory()[:, 4:7])))
    assert ate_j < 0.5 and ate_t < 0.5, (ate_j, ate_t)


def test_plane_wiring_and_resets(drive):
    _, ts, _, _ = drive
    closer = ts.loop_closer
    assert ts.tracker.kf_db is closer.db and ts.tracker.reloc_generator is ts._reloc_rng
    assert ts.atlas.entries[ts.atlas.active_idx].db is closer.db
    assert closer.dev_cache is ts.mapper.dev_cache and closer.generator is ts._loop_rng
    assert closer.gba_dispatch == ts._dispatch_gba and t_system.GBA_ITERATIONS == 16
    assert ts.atlas.n_maps() == 1 and ts._try_merge(ts.map.n_kf - 1) is False
    cfg = ts.cfg
    fresh = TSystem(cfg, device="cpu")
    fresh._spawn_components(64)
    first = fresh.loop_closer
    assert first is not None and first.map is fresh.map
    fresh.reset_active_map()
    assert fresh.loop_closer is not first and fresh.loop_closer.map is fresh.map
    assert fresh.tracker.kf_db is fresh.loop_closer.db and not fresh.loop_closer.db.present.any()
    fresh.reset()
    assert fresh.loop_closer is None and fresh.map is None
    off = TSystem(dataclasses.replace(cfg, loop_closing=False), device="cpu")
    off._spawn_components(64)
    assert off.loop_closer is None and off.tracker.kf_db is None
    no_map = TSystem(cfg, enable_mapping=False, device="cpu")
    no_map._spawn_components(64)
    assert no_map.mapper is None and no_map.loop_closer.dev_cache is not None


def test_a_merge_candidate_in_a_second_map_raises(drive):
    """With two atlas maps, a keyframe that the other map's database
    recognizes starts the cross-map verification, which no longer raises:
    the new map's first keyframe sees exactly what the old map's first
    keyframe saw, so it is verified and welded into the old map (the weld
    against the JAX package: tests/test_torch_merge.py)."""
    _, ts, _, _ = drive
    _, feats, _ = loop_drive_features(2)
    sysm = TSystem(ts.cfg, device="cpu")
    sysm.track_features(feats_to_port(feats[0]), 0.0)
    sysm.track_features(feats_to_port(feats[1]), 0.1)
    assert sysm._try_merge(0) is False                     # one map: nothing to merge
    old_db, old_map = sysm.loop_closer.db, sysm.map
    assert old_db.present[0]
    sysm.map.n_kf = max(sysm.map.n_kf, 2)                  # an archived map worth keeping
    sysm._create_map_in_atlas()
    assert sysm.atlas.n_maps() == 2 and sysm.loop_closer.db is not old_db
    assert sysm.atlas.entries[0].db is old_db
    # the new map's first keyframe sees what the old map's first keyframe saw
    # (a frame needs over 500 points with depth to start a map)
    r = sysm.track_features(feats_to_port(feats[0]), 0.2)
    assert r.state == t_trk.OK and r.created_kf
    assert sysm.atlas.n_maps() == 1 and sysm.map is old_map and sysm.atlas.entries[0].map is old_map
    assert sysm.loop_closer.db is old_db and sysm.tracker.kf_db is old_db
    welded = old_map.n_kf - 1
    assert old_db.present[welded] and sysm.tracker.ref_kf == welded
    assert sysm.loop_closer.extra_edges[-1][:2] == (welded, 0)
    np.testing.assert_allclose(old_map.kf_pose[welded], old_map.kf_pose[0], atol=1e-4)
    assert t_ms.check_binding_consistency(old_map) == []
    assert len(sysm.trajectory()) == 3


def test_box_world_and_loop_trajectories_match_jax():
    """The loop drive's scene: the room's geometry equals the JAX package's
    (the textures come from another generator) and the trajectories agree
    to 1e-6."""
    from orb_slam3_rgbl_tpu import synthetic as j_syn
    from orb_slam3_rgbl_tpu_torch import synthetic as t_syn

    with jax.enable_x64(False):
        wj = j_syn.make_box_world(0, tex_size=32)
    wt = t_syn.make_box_world(0, tex_size=32, device="cpu")
    for name in ("normals", "offsets", "e1", "e2", "tex_scale"):
        np.testing.assert_array_equal(getattr(wt, name).numpy(), np.asarray(getattr(wj, name)))
    assert tuple(wt.tex.shape) == tuple(wj.tex.shape) == (5, 32, 32)
    assert 10.0 <= float(wt.tex.min()) and float(wt.tex.max()) <= 245.0
    np.testing.assert_allclose(t_syn.multi_loop_trajectory(132, radius=6.0, period=84),
                               j_syn.multi_loop_trajectory(132, radius=6.0, period=84), atol=1e-6)
    np.testing.assert_allclose(t_syn.loop_trajectory(84, radius=6.0),
                               j_syn.loop_trajectory(84, radius=6.0), atol=1e-6)
    lap = t_syn.loop_trajectory(84)
    assert lap.dtype == np.float32 and np.abs(lap[0] - [1, 0, 0, 0, 0, 0, 0]).max() == 0
    # a ray from the circle's centre hits a wall 14 m away
    cfg = t_syn.synthetic_rgbl_config()
    cam = cfg.camera
    pts = t_syn.lidar_scan(wt, np.array([1, 0, 0, 0, 0, 0, 0], np.float32), n_az=64, n_el=4)
    assert pts.shape[1] in (3, 4) and torch.isfinite(pts).all()
    img = t_syn.render_image(wt, np.array([1, 0, 0, 0, 0, 0, 0], np.float32), cam.fx, cam.fy,
                             cam.cx, cam.cy, cam.height, cam.width)
    assert tuple(img.shape) == (cam.height, cam.width) and float(img.std()) > 1.0
