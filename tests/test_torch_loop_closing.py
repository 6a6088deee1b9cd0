"""Port vs JAX: the stages of ``LoopCloser`` on one map state.

A JAX ``System`` (the default configuration: mapping and loop closing on)
takes the 90-frame circular feature drive of ``tests/test_loop_closing.py``
up to the keyframe whose detection returns a verified loop; the drive stops
there, before ``apply_event``. The map, the database and the consistency
state as they stood before that detection go into the port
(``convert.map_state_from_numpy``, ``convert.loop_closer_state_from_numpy``).
On that state:

* ``detect_only``: the same event keyframes; the refined Sim3 within 2e-3
  (quaternion) and 2e-2 m, inlier counts within 3 (the two RANSACs draw
  from different streams; observed 5e-5, 1e-3 m and 1);
* ``_search_and_fuse`` and ``_essential_edges`` fed the JAX event: bindings,
  live landmarks, free list and edge lists exact, edge Sim3s to 1e-6;
* ``_correct_loop`` (pose graph, landmark re-anchoring, ``_fuse``):
  keyframe centres within 2e-3 m, landmarks within 5e-3 m (observed 2e-4
  and 4e-4), bindings and live landmarks exact;
* the 16-iteration global BA (JAX ``_global_ba_solve(16)``, the port's
  ``_global_ba(16)``) + ``_apply_gba``: keyframe centres within 5e-3 m
  and landmark medians within 5e-3 m (observed 6e-4 and 2e-4), both costs
  lowered to within 2% of each other.

JAX runs with x64 off, as outside the test suite."""

import copy
import dataclasses
import threading

import numpy as np
import jax
import pytest
import torch

from orb_slam3_rgbl_tpu.config import kitti_rgbl_config
from orb_slam3_rgbl_tpu.slam import loop_closing as j_lc
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from orb_slam3_rgbl_tpu_torch.optim import global_ba as t_global_ba
from orb_slam3_rgbl_tpu_torch.retrieval import tree_vocab as t_tv
from orb_slam3_rgbl_tpu_torch.slam import loop_closing as t_lc
from orb_slam3_rgbl_tpu_torch.slam import map_state as t_ms
from orb_slam3_rgbl_tpu_torch.slam import system as t_system

from test_loop_closing import CircularWorld, circle_trajectory

N_FRAMES, RADIUS = 90, 18.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _LoopFound(Exception):
    pass


def loop_drive_features(n_frames=N_FRAMES):
    """(JAX config, the drive's FrameFeatures, ground-truth Tcw)."""
    cfg = kitti_rgbl_config()
    world = CircularWorld(np.random.default_rng(0), cfg.camera, RADIUS)
    gt = circle_trajectory(N_FRAMES, RADIUS)
    with jax.enable_x64(False):
        feats = [world.render(gt[i], n_feat=600, px_noise=0.6) for i in range(n_frames)]
    return cfg, feats, gt


def feats_to_port(f):
    return convert.frame_features_from_numpy(
        {k: np.asarray(v) for k, v in f._asdict().items()}, device="cpu")


def closer_state(closer, groups=None) -> dict:
    """A JAX ``LoopCloser``'s state as plain numpy and Python values."""
    return {"db_vectors": closer.db.vectors.copy(), "db_present": closer.db.present.copy(),
            "consistent_groups": copy.deepcopy(
                closer._consistent_groups if groups is None else groups),
            "extra_edges": list(closer.extra_edges), "last_loop_kf": closer.last_loop_kf}


def copy_jax_map(jmap):
    out = copy.copy(jmap)
    for f in dataclasses.fields(out):
        v = getattr(out, f.name)
        if isinstance(v, np.ndarray):
            setattr(out, f.name, v.copy())
        elif isinstance(v, (list, dict)):
            setattr(out, f.name, type(v)(v))
    return out


def jax_state_before_loop(stop_after_frames=None):
    """Drive the JAX ``System`` until a detection returns an event (or, with
    ``stop_after_frames``, for that many frames). Returns (system, event or
    None, keyframe id, consistency groups before the detection, pending
    fusion pairs, frames fed)."""
    cfg, feats, _ = loop_drive_features(stop_after_frames or N_FRAMES)
    js = JSystem(cfg)
    seen = {}
    with jax.enable_x64(False):
        for i, f in enumerate(feats):
            if js.loop_closer is not None and "wrapped" not in seen:
                seen["wrapped"] = True
                closer = js.loop_closer
                inner = closer.detect_only

                def detect_only(kf_id, index_only=False, closer=closer, inner=inner):
                    groups = copy.deepcopy(closer._consistent_groups)
                    ev = inner(kf_id, index_only)
                    if ev is not None and stop_after_frames is None:
                        seen.update(ev=ev, kf=kf_id, groups=groups,
                                    pending=closer._pending_fusion)
                        raise _LoopFound
                    return ev

                closer.detect_only = detect_only
            try:
                js.track_features(f, i * 0.1)
            except _LoopFound:
                break
    return js, seen.get("ev"), seen.get("kf"), seen.get("groups"), seen.get("pending"), i + 1


def port_closer(js, tcfg, groups=None, jmap=None, jcloser=None):
    """The port's ``LoopCloser`` on a copy of the JAX map and state."""
    jcloser = jcloser or js.loop_closer
    tm = convert.map_state_from_numpy(jmap if jmap is not None else js.map)
    closer = t_lc.LoopCloser(tcfg, tm, device="cpu",
                             generator=torch.Generator().manual_seed(7))
    return convert.loop_closer_state_from_numpy(closer, closer_state(jcloser, groups))


def jax_closer_copy(js):
    """A JAX ``LoopCloser`` of its own on a copy of the system's map."""
    jmap = copy_jax_map(js.map)
    closer = j_lc.LoopCloser(js.cfg, jmap)
    src = js.loop_closer
    closer.db.vectors = src.db.vectors.copy()
    closer.db.present = src.db.present.copy()
    closer.extra_edges = list(src.extra_edges)
    closer.last_loop_kf = src.last_loop_kf
    return closer


@pytest.fixture(scope="module")
def state():
    js, ev, kf_id, groups, pending, n_fed = jax_state_before_loop()
    assert ev is not None and n_fed < N_FRAMES, "the JAX drive closed no loop"
    tcfg = convert.config_from_dict(dataclasses.asdict(js.cfg))
    return js, ev, kf_id, groups, pending, tcfg


def test_detect_only_returns_the_same_event(state):
    js, ev, kf_id, groups, pending, tcfg = state
    closer = port_closer(js, tcfg, groups)
    # the new keyframe's signature is computed again and lands on the same row
    before = closer.db.vectors[kf_id].clone()
    ev_t = closer.detect_only(kf_id)
    np.testing.assert_array_equal(closer.db.vectors[kf_id].numpy(), before.numpy())
    assert ev_t is not None and (ev_t.kf_cur, ev_t.kf_matched) == (ev.kf_cur, ev.kf_matched)
    m = closer.map
    assert m.kf_frame_id[ev_t.kf_cur] - m.kf_frame_id[ev_t.kf_matched] > 30
    assert abs(ev_t.n_inliers - ev.n_inliers) <= 3, (ev_t.n_inliers, ev.n_inliers)
    np.testing.assert_allclose(ev_t.S12[:4], ev.S12[:4], atol=2e-3)
    np.testing.assert_allclose(ev_t.S12[4:7], ev.S12[4:7], atol=2e-2)
    assert ev_t.S12[7] == ev.S12[7] == 1.0          # the depth sensor fixes the scale
    cur_t, old_t = closer._pending_fusion
    pairs_t, pairs_j = set(zip(cur_t.tolist(), old_t.tolist())), set(zip(*map(np.ndarray.tolist, pending)))
    assert len(pairs_t & pairs_j) >= 0.97 * len(pairs_j), (len(pairs_t), len(pairs_j))
    assert closer._consistent_groups == []          # cleared by an accepted event
    rec = closer.stats["candidates"][-1]
    assert rec["accepted"] and rec["ransac"] >= 20 and rec["guided"] == ev_t.n_inliers
    # the gates before verification: too few keyframes, and right after a loop
    closer.last_loop_kf = kf_id - 2
    assert closer.detect_only(kf_id) is None
    # without the caller's generator the RANSAC refuses to draw
    bare = port_closer(js, tcfg, groups)
    bare.generator = None
    with pytest.raises(ValueError, match="Generator"):
        bare.detect_only(kf_id)


def test_detect_only_without_fixed_scale_matches_jax(state):
    """The monocular closer (``fix_scale=False``, ``LoopCloser.fix_scale``
    for the MONOCULAR sensor) on the same state: the same event keyframes,
    the Sim3 to the tolerances above with its scale free and within 2e-3 of
    JAX's, inlier counts within 3 (the two RANSACs draw from different
    streams)."""
    js, ev, kf_id, groups, pending, tcfg = state
    jc = jax_closer_copy(js)
    jc.fix_scale = False
    jc._consistent_groups = copy.deepcopy(groups)
    with jax.enable_x64(False):
        ev_j = jc.detect_only(kf_id)
    tc = port_closer(js, tcfg, groups)
    tc.fix_scale = False
    ev_t = tc.detect_only(kf_id)
    assert ev_j is not None and ev_t is not None
    assert (ev_t.kf_cur, ev_t.kf_matched) == (ev_j.kf_cur, ev_j.kf_matched)
    assert abs(ev_t.n_inliers - ev_j.n_inliers) <= 3, (ev_t.n_inliers, ev_j.n_inliers)
    np.testing.assert_allclose(ev_t.S12[:4], ev_j.S12[:4], atol=2e-3)
    np.testing.assert_allclose(ev_t.S12[4:7], ev_j.S12[4:7], atol=2e-2)
    assert ev_t.S12[7] != 1.0 and abs(ev_t.S12[7] - ev_j.S12[7]) < 2e-3, (ev_t.S12, ev_j.S12)


def test_search_and_fuse_and_essential_edges_exact(state):
    js, ev, kf_id, groups, pending, tcfg = state
    jc = jax_closer_copy(js)
    tc = port_closer(js, tcfg, groups)
    with jax.enable_x64(False):
        jc._search_and_fuse(ev)
    n_replaced = tc._search_and_fuse(t_lc.LoopEvent(ev.kf_cur, ev.kf_matched, ev.n_inliers,
                                                    ev.S12.copy()))
    jm, tm = jc.map, tc.map
    np.testing.assert_array_equal(tm.kf_lm_idx, jm.kf_lm_idx)
    np.testing.assert_array_equal(tm.lm_valid, jm.lm_valid)
    np.testing.assert_array_equal(tm.lm_gen, jm.lm_gen)
    np.testing.assert_array_equal(tm.lm_found, jm.lm_found)
    np.testing.assert_array_equal(tm.lm_visible, jm.lm_visible)
    assert list(tm.lm_free) == list(jm.lm_free)
    assert n_replaced == int(js.map.lm_valid.sum() - jm.lm_valid.sum()) > 50
    assert t_ms.check_binding_consistency(tm) == []

    valid = tm.valid_kf_ids()
    slot = {int(k): i for i, k in enumerate(valid)}
    ei_j, ej_j, Sij_j, w_j = jc._essential_edges(jm.valid_kf_ids(), slot, ev)
    ei_t, ej_t, Sij_t, w_t = tc._essential_edges(valid, slot, ev)
    assert ei_t == ei_j and ej_t == ej_j and w_t == w_j and len(ei_t) >= len(valid)
    np.testing.assert_allclose(np.stack(Sij_t), np.stack(Sij_j), atol=1e-6)
    assert (ei_t[-1], ej_t[-1], w_t[-1]) == (slot[ev.kf_cur], slot[ev.kf_matched], 10.0)


@pytest.fixture(scope="module")
def corrected(state):
    """Both closers after ``_correct_loop`` of the JAX event, GBA held back."""
    js, ev, kf_id, groups, pending, tcfg = state
    jc = jax_closer_copy(js)
    tc = port_closer(js, tcfg, groups)
    jc.run_gba = tc.run_gba = False
    jc._pending_fusion = tuple(a.copy() for a in pending)
    tc._pending_fusion = tuple(a.copy() for a in pending)
    with jax.enable_x64(False):
        jc._correct_loop(ev)
    tc._correct_loop(t_lc.LoopEvent(ev.kf_cur, ev.kf_matched, ev.n_inliers, ev.S12.copy()))
    return jc, tc


def test_correct_loop_matches_jax(state, corrected):
    js, ev = state[0], state[1]
    jc, tc = corrected
    jm, tm = jc.map, tc.map
    np.testing.assert_array_equal(tm.kf_lm_idx, jm.kf_lm_idx)
    np.testing.assert_array_equal(tm.lm_valid, jm.lm_valid)
    assert tm.version == jm.version == js.map.version + 1
    live = tm.valid_kf_ids()
    c_t, c_j = t_lie.np_se3_centers(tm.kf_pose[live]), t_lie.np_se3_centers(jm.kf_pose[live])
    assert np.abs(c_t - c_j).max() < 2e-3, np.abs(c_t - c_j).max()
    # the correction moved the late keyframes, and left the matched one alone
    moved = np.abs(c_j - t_lie.np_se3_centers(js.map.kf_pose[live])).max()
    assert moved > 0.05, moved
    np.testing.assert_allclose(tm.kf_pose[ev.kf_matched], js.map.kf_pose[ev.kf_matched],
                               atol=1e-6)
    lms = np.nonzero(tm.lm_valid)[0]
    assert np.abs(tm.lm_pos[lms] - jm.lm_pos[lms]).max() < 5e-3
    assert t_ms.check_binding_consistency(tm) == []
    assert len(tc.extra_edges) == len(jc.extra_edges) == 1
    assert tc.extra_edges[0][:2] == (ev.kf_cur, ev.kf_matched) and tc.extra_edges[0][3] == 10.0
    rec = tc.stats["events"][-1]
    assert rec["pose_graph"] == "applied" and rec["pg_cost_after"] < rec["pg_cost_before"]
    assert rec["fused_pairs"] > 50 and rec["gba"] == "skipped"


def test_global_ba_and_writeback_match_jax(corrected):
    jc, tc = corrected
    with jax.enable_x64(False):
        out_j = jc._global_ba_solve(16)
        cost_j = float(out_j[2].cost)
        jc._apply_gba(out_j)
    before = tc.map.kf_pose.copy()
    tc._global_ba(16)
    jm, tm = jc.map, tc.map
    rec = tc.stats["events"][-1]
    assert rec["gba"] == "applied" and rec["gba_cost_after"] < 0.5 * rec["gba_cost_before"]
    assert abs(rec["gba_cost_after"] - cost_j) < 0.02 * cost_j, (rec["gba_cost_after"], cost_j)
    # the real sizes, not the JAX side's padded tiers
    assert rec["gba_poses"] == tm.n_kf - int((~tm.kf_valid[: tm.n_kf]).sum())
    assert out_j[2].poses.shape[0] >= 32 > rec["gba_poses"]
    live = tm.valid_kf_ids()
    c_t, c_j = t_lie.np_se3_centers(tm.kf_pose[live]), t_lie.np_se3_centers(jm.kf_pose[live])
    assert np.abs(c_t - c_j).max() < 5e-3, np.abs(c_t - c_j).max()
    assert np.abs(tm.kf_pose[live] - before[live]).max() > 1e-4
    lms = np.nonzero(tm.lm_valid)[0]
    assert np.median(np.abs(tm.lm_pos[lms] - jm.lm_pos[lms]).max(axis=1)) < 5e-3
    assert tm.version == jm.version
    assert t_ms.check_binding_consistency(tm) == []


def test_apply_gba_rejects_a_diverged_result(corrected):
    _, tc = corrected
    snapshot = tc._gba_assemble()
    window, lm_ids, res, pose_before, gen_before = tc._gba_iterate(snapshot, 2)
    bad = res._replace(poses=res.poses + 1e6)
    kept = tc.map.kf_pose.copy()
    assert tc._apply_gba((window, lm_ids, bad, pose_before, gen_before)) is False
    np.testing.assert_array_equal(tc.map.kf_pose, kept)
    nan = res._replace(landmarks=res.landmarks * float("nan"))
    assert tc._apply_gba((window, lm_ids, nan, pose_before, gen_before)) is False


def test_correct_loop_4dof_on_an_initialized_map(state):
    """The same event on the map as an initialized inertial map (sensor
    IMU_RGBD): the essential graph is the 4-DoF one on both packages —
    every keyframe keeps the direction of the world's z axis in its camera
    frame (roll and pitch, within 1e-5) — and the corrected keyframe
    centres agree within 2e-3 m, as the Sim3 branch's do."""
    from orb_slam3_rgbl_tpu.config import IMU_RGBD, ImuConfig

    js, ev, kf_id, groups, pending, tcfg = state
    jcfg = dataclasses.replace(js.cfg, sensor=IMU_RGBD, imu=ImuConfig())
    jmap = copy_jax_map(js.map)
    jmap.imu_initialized = True
    jc = j_lc.LoopCloser(jcfg, jmap)
    jc.db.vectors = js.loop_closer.db.vectors.copy()
    jc.db.present = js.loop_closer.db.present.copy()
    tc = port_closer(js, convert.config_from_dict(dataclasses.asdict(jcfg)), groups, jmap=jmap,
                     jcloser=js.loop_closer)
    assert tc.map.imu_initialized and tc.cfg.inertial
    jc.run_gba = tc.run_gba = False
    jc._pending_fusion = tuple(a.copy() for a in pending)
    tc._pending_fusion = tuple(a.copy() for a in pending)
    before = tc.map.kf_pose.copy()
    with jax.enable_x64(False):
        jc._correct_loop(ev)
    tc._correct_loop(t_lc.LoopEvent(ev.kf_cur, ev.kf_matched, ev.n_inliers, ev.S12.copy()))
    rec = tc.stats["events"][-1]
    assert rec["pose_graph_dof"] == 4 and rec["pose_graph"] == "applied"
    assert rec["pg_cost_after"] < rec["pg_cost_before"]
    live = tc.map.valid_kf_ids()
    z = np.tile(np.float32([0.0, 0.0, 1.0]), (live.size, 1))
    z_before = t_lie.np_quat_rotate(before[live, :4], z)
    z_after = t_lie.np_quat_rotate(tc.map.kf_pose[live, :4], z)
    assert np.abs(z_after - z_before).max() < 1e-5, np.abs(z_after - z_before).max()
    c_t = t_lie.np_se3_centers(tc.map.kf_pose[live])
    c_j = t_lie.np_se3_centers(jc.map.kf_pose[live])
    assert np.abs(c_t - c_j).max() < 2e-3, np.abs(c_t - c_j).max()
    assert np.abs(c_j - t_lie.np_se3_centers(before[live])).max() > 0.05


def test_apply_event_without_pose_graph_matches_jax(state):
    """``run_pose_graph=False`` (``tools/triage_ate.py``'s ``nopg`` mode)
    through ``apply_event`` on both packages: the essential graph is not
    solved, so every keyframe keeps its pose (the fusion's landmark
    writeback, the recorded edge and the event still happen); the corrected
    centres agree within this file's 2e-3 m."""
    js, ev, kf_id, groups, pending, tcfg = state
    jc = jax_closer_copy(js)
    tc = port_closer(js, tcfg, groups)
    jc.run_gba = tc.run_gba = False
    jc._pending_fusion = tuple(a.copy() for a in pending)
    tc._pending_fusion = tuple(a.copy() for a in pending)
    before = tc.map.kf_pose.copy()
    with jax.enable_x64(False):
        jc.apply_event(ev, run_pose_graph=False)
    tc.apply_event(t_lc.LoopEvent(ev.kf_cur, ev.kf_matched, ev.n_inliers, ev.S12.copy()),
                   run_pose_graph=False)
    rec = tc.stats["events"][-1]
    assert rec["pose_graph"] == "skipped" and "pg_cost_after" not in rec
    live = tc.map.valid_kf_ids()
    c_t = t_lie.np_se3_centers(tc.map.kf_pose[live])
    c_j = t_lie.np_se3_centers(jc.map.kf_pose[live])
    assert np.abs(c_t - c_j).max() < 2e-3, np.abs(c_t - c_j).max()
    assert np.abs(c_t - t_lie.np_se3_centers(before[live])).max() < 1e-5
    assert tc.events[-1].kf_cur == jc.events[-1].kf_cur == ev.kf_cur
    assert len(tc.extra_edges) == len(jc.extra_edges) == 1
    assert t_ms.check_binding_consistency(tc.map) == []


def test_triage_nopg_skips_the_pose_graph_on_both_planes(state):
    """``tools/triage_ate.py``'s ``nopg`` mode (``skip_pose_graph``) on the
    port's closer, through both callers of the correction: the inline
    plane's ``on_keyframe`` (detection, then ``apply_event``) and the
    asynchronous loop plane's ``apply_event``. Each closes the loop with the
    pose graph skipped, every keyframe keeping its pose (1e-5 m, as above)."""
    from orb_slam3_rgbl_tpu_torch.tools import triage_ate

    js, ev, kf_id, groups, pending, tcfg = state
    for inline in (True, False):
        tc = port_closer(js, tcfg, groups)
        tc.run_gba = False
        triage_ate.skip_pose_graph(tc)
        before = tc.map.kf_pose.copy()
        if inline:
            got = tc.on_keyframe(kf_id)
            assert got is not None and (got.kf_cur, got.kf_matched) == (ev.kf_cur, ev.kf_matched)
        else:
            tc._pending_fusion = tuple(a.copy() for a in pending)
            tc.apply_event(t_lc.LoopEvent(ev.kf_cur, ev.kf_matched, ev.n_inliers, ev.S12.copy()))
        assert [r["pose_graph"] for r in tc.stats["events"]] == ["skipped"], inline
        assert len(tc.events) == 1 and tc.last_loop_kf == ev.kf_cur
        live = tc.map.valid_kf_ids()
        moved = np.abs(t_lie.np_se3_centers(tc.map.kf_pose[live])
                       - t_lie.np_se3_centers(before[live])).max()
        assert moved < 1e-5, (inline, moved)


def test_closer_refuses_unported_branches(state, tmp_path):
    js, tcfg = state[0], state[5]
    tm = convert.map_state_from_numpy(js.map)
    # vocab_path is ported: the closer's database scores with the tree vocabulary
    path = str(tmp_path / "vocab.npz")
    t_tv.train_vocabulary(tm.kf_desc[0][tm.kf_feat_valid[0]], k=4, depth=2,
                          device="cpu").save(path)
    closer = t_lc.LoopCloser(dataclasses.replace(tcfg, vocab_path=path), tm, device="cpu")
    assert closer.db.vocabulary is not None and closer.db.vectors.shape == (tm.capacity_kf, 16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_lc.LoopCloser(tcfg, tm)
    assert t_lc.LOOP_SPANS == ("loop.index", "loop.detect", "loop.verify", "loop.fuse",
                               "loop.pose_graph", "loop.gba")


# ---------------------------------------------------------------------------
# the global BA of the asynchronous plane (tests/test_gba_async.py's checks),
# on the corrected state


def test_gba_abort_leaves_the_map_and_stops_between_chunks(corrected):
    jc, tc = corrected
    kept_t, kept_j = tc.map.kf_pose.copy(), jc.map.kf_pose.copy()
    preset = threading.Event()
    preset.set()
    with jax.enable_x64(False):
        assert jc._global_ba_solve(iterations=6, abort_event=preset) is None
    assert tc._gba_iterate(tc._gba_assemble(), 6, preset) is None
    np.testing.assert_array_equal(tc.map.kf_pose, kept_t)
    np.testing.assert_array_equal(jc.map.kf_pose, kept_j)

    chunks = []
    solve = t_global_ba.global_bundle_adjust

    class Tripwire:                  # passes the first check, then aborts
        def __init__(self):
            self.n = 0

        def is_set(self):
            self.n += 1
            return self.n > 1

    def counted(*a, **k):
        chunks.append(k.get("iterations"))
        return solve(*a, **k)

    wire = Tripwire()
    t_global_ba.global_bundle_adjust = counted
    try:
        assert tc._gba_iterate(tc._gba_assemble(), 6, wire) is None
    finally:
        t_global_ba.global_bundle_adjust = solve
    assert wire.n == 2 and chunks == [t_lc.GBA_CHUNK]      # exactly one chunk ran
    np.testing.assert_array_equal(tc.map.kf_pose, kept_t)


def test_gba_writeback_propagates_to_keyframes_made_during_the_solve(corrected):
    """A keyframe and a landmark created between the snapshot and the
    writeback move rigidly with their anchor (1e-4) and reference keyframe
    (1e-3), as tests/test_gba_async.py holds JAX; the two packages' results
    agree as in test_global_ba_and_writeback_match_jax (centres 5e-3 m)."""
    jc, tc = corrected
    with jax.enable_x64(False):
        out_j = jc._global_ba_solve(iterations=4)
    out_t = tc._gba_iterate(tc._gba_assemble(), 4)
    window = out_t[0]
    np.testing.assert_array_equal(window, np.asarray(out_j[0])[: len(window)])
    anchor = int(window[-1])
    T_rel = np.array([0.99875, 0.03, 0.04, -0.01, 0.1, 0.02, -0.05], np.float32)
    T_rel[:4] /= np.linalg.norm(T_rel[:4])
    X_new = np.array([[1.0, 2.0, 25.0]], np.float32)
    fresh = []
    for m in (jc.map, tc.map):
        kf_new = m.add_keyframe(
            t_lie.np_se3_mul(T_rel, m.kf_pose[anchor]), m.kf_uv[anchor], m.kf_octave[anchor],
            m.kf_desc[anchor], m.kf_depth[anchor], m.kf_ur[anchor], m.kf_feat_valid[anchor],
            m.kf_lm_idx[anchor].copy(), 99.9, 999, angle=m.kf_angle[anchor])
        lm_new = m.add_landmarks(X_new, m.kf_desc[kf_new][:1], kf_new, np.array([0]),
                                 np.array([[0, 0, 1.0]], np.float32),
                                 np.array([30.0], np.float32), np.array([3.0], np.float32))[0]
        fresh.append((kf_new, lm_new, t_lie.np_se3_mul(m.kf_pose[kf_new],
                                                        t_lie.np_se3_inv(m.kf_pose[anchor])),
                      t_lie.np_se3_apply(m.kf_pose[kf_new], X_new[0])))
    assert fresh[0][:2] == fresh[1][:2]
    with jax.enable_x64(False):
        jc._apply_gba(out_j)
    assert tc._apply_gba(out_t) is True
    for m, (kf_new, lm_new, rel_before, xc_before) in zip((jc.map, tc.map), fresh):
        rel = t_lie.np_se3_mul(m.kf_pose[kf_new], t_lie.np_se3_inv(m.kf_pose[anchor]))
        np.testing.assert_allclose(rel, rel_before, atol=1e-4)
        np.testing.assert_allclose(t_lie.np_se3_apply(m.kf_pose[kf_new], m.lm_pos[lm_new]),
                                   xc_before, atol=1e-3)
    live = tc.map.valid_kf_ids()
    np.testing.assert_array_equal(live, jc.map.valid_kf_ids())
    c_t = t_lie.np_se3_centers(tc.map.kf_pose[live])
    c_j = t_lie.np_se3_centers(jc.map.kf_pose[live])
    assert np.abs(c_t - c_j).max() < 5e-3, np.abs(c_t - c_j).max()
    assert t_ms.check_binding_consistency(tc.map) == []


def test_a_second_dispatch_supersedes_the_running_solve(corrected, monkeypatch):
    """``_dispatch_gba`` twice on the asynchronous plane: the first solve
    is aborted before its first chunk, the second lands at
    ``_poll_gba(wait=True)``, both on the ``gba`` thread."""
    tc = corrected[1]
    monkeypatch.setattr(t_system, "GBA_ITERATIONS", 2)   # supersession, not convergence
    ts = t_system.System(tc.cfg, device="cpu")
    ts.async_mapping = True
    ts.map, ts.loop_closer = tc.map, tc
    calls, results = [], []
    iterate = tc._gba_iterate

    def held(snapshot, iterations, abort_event=None):
        calls.append((iterations, threading.current_thread().name))
        if len(calls) == 1:       # held until the next dispatch aborts it
            assert abort_event.wait(60.0)
        out = iterate(snapshot, iterations, abort_event)
        results.append(out)
        return out

    tc._gba_iterate = held
    try:
        ts._dispatch_gba()
        ts._dispatch_gba()
        n_events = len(tc.stats["events"])
        ts._poll_gba(wait=True)
    finally:
        del tc._gba_iterate
        ts.shutdown()
    assert [c[0] for c in calls] == [2, 2] and {c[1] for c in calls} == {"gba_0"}
    assert results[0] is None and results[1] is not None
    assert ts._gba_future is None and ts._gba_exec is None
    assert tc.stats["events"][n_events - 1]["gba"] == "applied"
    assert t_ms.check_binding_consistency(tc.map) == []


def _imu_chain(m, dt_min=1e-3):
    """An IMU chain over the map's keyframes in id order, its preintegrations
    read off the poses as they stand (the body is the camera, velocities by
    central differences of the centres): the map is inertially consistent
    before the correction bends it."""
    from orb_slam3_rgbl_tpu_torch.imu.preintegration import GRAVITY
    kfs = m.valid_kf_ids()
    Twb = t_lie.np_se3_inv(m.kf_pose[kfs])
    t = m.kf_timestamp[kfs]
    p = Twb[:, 4:7].astype(np.float64)
    vel = np.gradient(p, t, axis=0)
    g = np.array([0.0, 0.0, -GRAVITY])
    for a in range(len(kfs) - 1):
        dt = max(float(t[a + 1] - t[a]), dt_min)
        rel = t_lie.np_se3_mul(t_lie.np_se3_inv(Twb[a][None]), Twb[a + 1][None])[0]
        q1 = Twb[a, :4] * np.float32([1, -1, -1, -1])
        dV = t_lie.np_quat_rotate(q1[None], (vel[a + 1] - vel[a] - g * dt)[None])[0]
        dP = t_lie.np_quat_rotate(q1[None], (p[a + 1] - p[a] - vel[a] * dt
                                             - 0.5 * g * dt * dt)[None])[0]
        eye = np.eye(3, dtype=np.float32)
        cov = np.diag([1e-7] * 3 + [1e-5] * 3 + [1e-6] * 3).astype(np.float32) * dt
        m.imu_preint[int(kfs[a + 1])] = (
            np.float32(dt), rel[:4].astype(np.float32), dV.astype(np.float32),
            dP.astype(np.float32), -dt * eye, 0 * eye, -dt * eye, 0 * eye, -0.5 * dt * dt * eye,
            cov, np.zeros(3, np.float32), np.zeros(3, np.float32))
        m.kf_prev_imu[kfs[a + 1]] = kfs[a]
    m.kf_vel[kfs] = vel.astype(np.float32)


def test_an_initialized_inertial_map_runs_the_whole_map_inertial_ba(state, monkeypatch):
    """The event on the map as an initialized inertial map (IMU_RGBD) with an
    IMU chain: after the 4-DoF correction the global BA is the whole-map
    inertial one (``FullInertialBA(7)``: one call, 7 LM iterations), not the
    visual one; it lowers the map's cost and moves velocities and biases;
    the keyframes keep their IMU chain. A preset abort stops it before the
    call. A keyframe made during the solve follows its anchor, its velocity
    turned with its correction (1e-6), its biases kept. (The JAX package
    runs the visual global BA here: the port follows the reference.)"""
    from orb_slam3_rgbl_tpu.config import IMU_RGBD, ImuConfig
    from orb_slam3_rgbl_tpu_torch.optim import global_inertial_ba as t_giba

    js, ev, kf_id, groups, pending, tcfg = state
    jcfg = dataclasses.replace(js.cfg, sensor=IMU_RGBD, imu=ImuConfig())
    jmap = copy_jax_map(js.map)
    jmap.imu_initialized = True
    tc = port_closer(js, convert.config_from_dict(dataclasses.asdict(jcfg)), groups, jmap=jmap,
                     jcloser=js.loop_closer)
    _imu_chain(tc.map)
    tc._pending_fusion = tuple(a.copy() for a in pending)
    visual, inertial = [], []
    solve_v, solve_i = t_global_ba.global_bundle_adjust, t_giba.global_inertial_bundle_adjust
    monkeypatch.setattr(t_global_ba, "global_bundle_adjust",
                        lambda *a, **k: visual.append(k) or solve_v(*a, **k))
    monkeypatch.setattr(t_giba, "global_inertial_bundle_adjust",
                        lambda *a, **k: inertial.append(k) or solve_i(*a, **k))
    m = tc.map
    live = m.valid_kf_ids()
    chain = m.kf_prev_imu.copy()
    before = dict(vel=m.kf_vel[live].copy(), bg=m.kf_bg[live].copy(), ba=m.kf_ba[live].copy())
    tc._correct_loop(t_lc.LoopEvent(ev.kf_cur, ev.kf_matched, ev.n_inliers, ev.S12.copy()))
    rec = tc.stats["events"][-1]
    assert rec["pose_graph_dof"] == 4 and rec["gba"] == "applied"
    assert visual == [] and len(inertial) == 1 and tc.counts["inertial_gba_runs"] == 1
    assert inertial[0]["iterations"] == inertial[0]["huber_iters"] == t_lc.GBA_VI_ITERATIONS == 7
    assert rec["gba_cost_after"] < rec["gba_cost_before"]
    assert rec["gba_poses"] == live.size
    np.testing.assert_array_equal(m.kf_prev_imu, chain)
    assert np.abs(m.kf_vel[live] - before["vel"]).max() > 1e-3
    assert np.abs(m.kf_bg[live] - before["bg"]).max() > 0
    assert np.abs(m.kf_ba[live] - before["ba"]).max() > 0
    assert np.isfinite(m.kf_vel[live]).all() and np.isfinite(m.kf_ba[live]).all()
    # the snapshot is the inertial one, every link of the chain a valid pair;
    # a preset abort stops the solve before its call
    snapshot = tc._gba_assemble()
    assert isinstance(snapshot[0], t_lc.VIBAProblem)
    assert int(snapshot[0].pair_valid.sum()) == live.size - 1
    preset = threading.Event()
    preset.set()
    assert tc._gba_iterate(snapshot, 6, preset) is None and len(inertial) == 1

    # a keyframe made during the solve: its velocity turns with its
    # correction (R_wc' · R_cw, the reference's Rcor), its biases stay
    out = tc._gba_iterate(snapshot, 6)
    anchor = int(out[0][-1])
    T_rel = np.array([0.99875, 0.03, 0.04, -0.01, 0.1, 0.02, -0.05], np.float32)
    T_rel[:4] /= np.linalg.norm(T_rel[:4])
    kf_new = m.add_keyframe(
        t_lie.np_se3_mul(T_rel, m.kf_pose[anchor]), m.kf_uv[anchor], m.kf_octave[anchor],
        m.kf_desc[anchor], m.kf_depth[anchor], m.kf_ur[anchor], m.kf_feat_valid[anchor],
        m.kf_lm_idx[anchor].copy(), 99.9, 999, angle=m.kf_angle[anchor])
    v0, bg0 = np.float32([0.3, -0.2, 1.1]), np.float32([1e-3, 2e-3, 3e-3])
    m.kf_vel[kf_new], m.kf_bg[kf_new] = v0, bg0
    # the anchor and the new keyframe turned together meanwhile (0.05 rad
    # about the world's z): the writeback takes the anchor back
    turn = np.float32([np.cos(0.025), 0, 0, np.sin(0.025), 0, 0, 0])
    for k in (anchor, kf_new):
        m.kf_pose[k] = t_lie.np_se3_mul(m.kf_pose[k], turn)
    q_old = m.kf_pose[kf_new, :4].copy()
    assert tc._apply_gba(out) is True
    q_new = m.kf_pose[kf_new, :4] * np.float32([1, -1, -1, -1])
    want = t_lie.np_quat_rotate(q_new[None], t_lie.np_quat_rotate(q_old[None], v0[None]))[0]
    np.testing.assert_allclose(m.kf_vel[kf_new], want, atol=1e-6)
    assert np.abs(m.kf_vel[kf_new] - v0).max() > 1e-2
    np.testing.assert_array_equal(m.kf_bg[kf_new], bg0)
    np.testing.assert_allclose(
        t_lie.np_se3_mul(m.kf_pose[kf_new], t_lie.np_se3_inv(m.kf_pose[anchor])), T_rel,
        atol=1e-4)


def test_a_visual_map_keeps_the_visual_global_ba(corrected, monkeypatch):
    """On a map without an initialized IMU the global BA is the visual
    solve, chunk by chunk as before, and the inertial one never runs."""
    from orb_slam3_rgbl_tpu_torch.optim import global_inertial_ba as t_giba
    _, tc = corrected
    chunks = []
    solve = t_global_ba.global_bundle_adjust
    monkeypatch.setattr(t_global_ba, "global_bundle_adjust",
                        lambda *a, **k: chunks.append(k["iterations"]) or solve(*a, **k))
    monkeypatch.setattr(t_giba, "global_inertial_bundle_adjust", None)
    snapshot = tc._gba_assemble()
    assert not isinstance(snapshot[0], t_lc.VIBAProblem)
    window, lm_ids, res, _, _ = tc._gba_iterate(snapshot, 4)
    assert chunks == [t_lc.GBA_CHUNK, t_lc.GBA_CHUNK] and tc.counts["inertial_gba_runs"] == 0
    # the same chunks called directly give the same bits
    problem, segments = snapshot[0], snapshot[5]
    poses, lms = problem.poses, problem.landmarks
    for _ in range(2):
        direct = solve(problem._replace(poses=poses, landmarks=lms), tc.cam, segments,
                       iterations=t_lc.GBA_CHUNK, cg_iters=t_lc.GBA_CG_ITERS)
        poses, lms = direct.poses, direct.landmarks
    assert torch.equal(res.poses, direct.poses) and torch.equal(res.landmarks, direct.landmarks)
