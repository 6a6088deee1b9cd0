"""Port vs JAX: ``System.async_mapping = True``, the mapping, loop and
global-BA workers on threads of their own.

* the drive of ``tests/test_image_e2e.py::TestAsyncMapping`` (30 frames of
  the 320×192 canyon, the default configuration of the synthetic world:
  mapping and loop closing on) through both packages' ``System`` with the
  asynchronous planes on: each holds the JAX test's bounds (every frame OK,
  ATE < 0.2 m, at least 2 keyframes), and the port's mapping jobs ran on
  its ``mapping`` thread. Thread timing decides which keyframes the busy
  gate declines and which detections are shed, so the two drives are not
  compared frame by frame;
* the busy gate, on both packages with a job held on a ``threading.Event``:
  three keyframes queued or in flight make ``mapping_busy_fn()`` true and
  ``deferred_kf`` count the insertion it declined; after the release
  ``_join_mapping`` leaves every queue empty;
* the tracker's statistics buffer: ``_bump_stats`` buffers while a job is in
  flight and ``flush_stat_buffer`` drops the entries whose landmark slot was
  recycled meanwhile, equal to JAX's on the same arrays (integers: exact);
* ``detect_only(index_only=True)``: the keyframe's database row as JAX
  writes it (held to 1e-6, the bar of test_torch_retrieval.py for rows)
  and no detection, on a map of 12 keyframes where detection would run;
* a loop worker whose detection raises: the traceback lands in
  ``System.worker_errors`` and the plane drains.

The weld's asynchronous half (the queue remap of ``_do_merge``) is tested in
test_torch_merge.py on that file's JAX state, and the global BA's abort,
propagation and supersession in test_torch_loop_closing.py.

JAX runs with x64 off, as outside the test suite."""

import dataclasses
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu.geometry.align import ate_rmse as j_ate_rmse
from orb_slam3_rgbl_tpu.slam.loop_closing import LoopCloser as JLoopCloser
from orb_slam3_rgbl_tpu.slam.map_state import MapState as JMapState
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu.slam.tracking import Tracker as JTracker
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import align as t_align
from orb_slam3_rgbl_tpu_torch.slam import map_state as t_ms, tracking as t_trk
from orb_slam3_rgbl_tpu_torch.slam.local_mapping import LocalMapper
from orb_slam3_rgbl_tpu_torch.slam.loop_closing import LoopCloser as TLoopCloser
from orb_slam3_rgbl_tpu_torch.slam.system import System as TSystem

from test_torch_system import CLOUD_CAP

N_FRAMES = 30
WAIT_S = 60.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(jcfg):
    return convert.config_from_dict(dataclasses.asdict(jcfg))


def test_async_drive_holds_jax_bounds():
    jcfg = j_syn.synthetic_rgbl_config()
    cam = jcfg.camera
    traj = j_syn.straight_trajectory(N_FRAMES, step=0.6, weave=0.4)
    js, ts = JSystem(jcfg), TSystem(_tcfg(jcfg), device="cpu")
    js.CLOUD_CAP = ts.CLOUD_CAP = CLOUD_CAP
    js.async_mapping = ts.async_mapping = True
    threads = []
    process = LocalMapper.process_keyframe

    def recorded(self, kf_id, *a, **k):
        threads.append(threading.current_thread().name)
        return process(self, kf_id, *a, **k)

    LocalMapper.process_keyframe = recorded
    states = {"jax": [], "port": []}
    try:
        with jax.enable_x64(False):
            world = j_syn.make_world(0, tex_size=256)
            for i, Twc in enumerate(traj):
                T = jnp.asarray(Twc)
                img = np.asarray(j_syn.render_image(world, T, cam.fx, cam.fy, cam.cx, cam.cy,
                                                    cam.height, cam.width))
                pts = np.asarray(j_syn.lidar_scan(world, T, n_az=256, n_el=48))
                states["jax"].append(js.track_rgbl(img, pts, i * 0.1).state)
                states["port"].append(ts.track_rgbl(img, pts, i * 0.1).state)
            js.shutdown()
            ts.shutdown()
            est_j = js.trajectory()
            err_j = float(j_ate_rmse(jnp.asarray(est_j[:, 4:7]),
                                     jnp.asarray(traj[:, 4:7] - traj[0, 4:7])))
    finally:
        LocalMapper.process_keyframe = process
    est_t = ts.trajectory()
    err_t = float(t_align.ate_rmse(traj[:, 4:7] - traj[0, 4:7], est_t[:, 4:7]))
    for name, sysm, err in (("jax", js, err_j), ("port", ts, err_t)):
        assert all(s == t_trk.OK for s in states[name]), (name, states[name])
        assert err < 0.2, (name, err)
        assert sysm.map.n_kf >= 2, name
        assert not sysm._map_queue and not sysm._loop_queue and not sysm._loop_inbox
    assert est_t.shape == est_j.shape == (N_FRAMES, 7)
    # the port's jobs ran on its mapping thread, one per mapping job
    assert threads and set(threads) == {"mapping_0"}, threads
    assert ts.worker_errors == [] and ts._map_exec is None and ts._loop_exec is None
    assert t_ms.check_binding_consistency(ts.map) == []
    # every keyframe was indexed by the loop worker (a shed one twice, when
    # the idle plane detects it again)
    assert {k["kf"] for k in ts.loop_closer.stats["keyframes"]} == set(range(ts.map.n_kf))


@pytest.mark.parametrize("package", ["jax", "port"])
def test_busy_gate_with_a_held_job(package):
    jcfg = j_syn.synthetic_rgbl_config(loop_closing=False)
    sysm = JSystem(jcfg) if package == "jax" else TSystem(_tcfg(jcfg), device="cpu")
    sysm.async_mapping = True
    with jax.enable_x64(False):
        sysm._spawn_components(64)
    gate, started, ran = threading.Event(), threading.Event(), []

    def held_job(kf_id, defer_merge):
        started.set()
        assert gate.wait(WAIT_S)
        ran.append((kf_id, defer_merge, threading.current_thread().name))

    sysm._mapping_job = held_job
    t = sysm.tracker
    t.ref_kf, t.frame_id, t.last_kf_frame, t.force_kf_every = 0, 8, 4, 4
    sysm._dispatch_mapping(0)
    assert started.wait(WAIT_S)
    assert not t.mapping_busy_fn() and t.mapping_inflight_fn()      # one in flight
    assert t._fast_kf_policy(200, 0, 0) and t.deferred_kf == 0       # a forced keyframe is due
    sysm._dispatch_mapping(1)
    assert not t.mapping_busy_fn() and sysm.mapper.backlog_fn() == 1
    sysm._dispatch_mapping(2)
    assert t.mapping_busy_fn() and sysm.mapper.backlog_fn() == 2     # 2 queued + 1 in flight
    assert not t._fast_kf_policy(200, 0, 0) and t.deferred_kf == 1
    gate.set()
    sysm._join_mapping()
    assert [r[:2] for r in ran] == [(0, True), (1, True), (2, True)]
    assert {r[2] for r in ran} == {"mapping_0"}
    assert not sysm._map_queue and sysm._map_future is None
    assert not sysm._loop_queue and not sysm._loop_inbox and sysm._loop_future is None
    assert not t.mapping_busy_fn() and not t.mapping_inflight_fn()
    sysm.shutdown()
    assert sysm._map_exec is None


def test_stat_buffer_matches_jax():
    rng = np.random.default_rng(3)
    jcfg = j_syn.synthetic_rgbl_config(loop_closing=False)
    n_lm = 40
    visible = rng.integers(1, 9, n_lm)
    gen = rng.integers(0, 3, n_lm).astype(np.int32)
    jm, tm = JMapState.create(8, 64, 16), t_ms.MapState.create(8, 64, 16)
    for m in (jm, tm):
        m.lm_visible[:n_lm] = visible
        m.lm_found[:n_lm] = visible - 1
        m.lm_gen[:n_lm] = gen
    with jax.enable_x64(False):
        jt = JTracker(jcfg, jm)
    tt = t_trk.Tracker(_tcfg(jcfg), tm, device="cpu")
    bumps = []
    for _ in range(3):
        vis = np.unique(rng.integers(0, n_lm, 20)).astype(np.int64)
        found = vis[rng.uniform(size=vis.size) < 0.6]
        bumps.append((vis, gen[vis].copy(), found, gen[found].copy()))
    before = tm.lm_visible.copy(), tm.lm_found.copy()
    inflight = [True]
    for t in (jt, tt):
        t.mapping_inflight_fn = lambda: inflight[0]
        for b in bumps:
            t._bump_stats(*b)
        assert len(t._stat_buffer) == 3
    np.testing.assert_array_equal(tm.lm_visible, before[0])
    np.testing.assert_array_equal(tm.lm_found, before[1])
    # a job culls and recycles some slots meanwhile
    recycled = np.arange(0, n_lm, 3)
    for m in (jm, tm):
        m.lm_gen[recycled] += 1
    jt.flush_stat_buffer()
    tt.flush_stat_buffer()
    assert jt._stat_buffer == [] and tt._stat_buffer == []
    np.testing.assert_array_equal(tm.lm_visible, jm.lm_visible)
    np.testing.assert_array_equal(tm.lm_found, jm.lm_found)
    np.testing.assert_array_equal(tm.lm_visible[recycled], before[0][recycled])
    assert (tm.lm_visible != before[0]).any()
    # with no job in flight the increments land at once, after the buffer
    inflight[0] = False
    for t in (jt, tt):
        t._stat_buffer.append(bumps[0])
        t._bump_stats(*bumps[1])
        assert t._stat_buffer == []
    np.testing.assert_array_equal(tm.lm_visible, jm.lm_visible)
    np.testing.assert_array_equal(tm.lm_found, jm.lm_found)


def _keyframe_map(pkg, rng, n_kf=12, n_feat=400):
    """A map of ``n_kf`` keyframes with random descriptors and a
    landmark-free chain of poses (enough for the closer's gates)."""
    m = pkg.create(32, 64, n_feat)
    for k in range(n_kf):
        pose = np.array([1, 0, 0, 0, 0, 0, 0.5 * k], np.float32)
        m.add_keyframe(pose, rng.uniform(0, 300, (n_feat, 2)).astype(np.float32),
                       rng.integers(0, 4, n_feat).astype(np.int16),
                       rng.integers(0, 2 ** 32, (n_feat, 8), dtype=np.uint32),
                       np.full(n_feat, 8.0, np.float32), np.full(n_feat, 100.0, np.float32),
                       rng.uniform(size=n_feat) < 0.9, np.full(n_feat, -1, np.int32),
                       0.1 * k, 3 * k, angle=rng.uniform(-3, 3, n_feat).astype(np.float32))
    return m


def test_index_only_writes_jax_row():
    jcfg = j_syn.synthetic_rgbl_config()
    jm = _keyframe_map(JMapState, np.random.default_rng(5))
    tm = convert.map_state_from_numpy(jm)
    with jax.enable_x64(False):
        jc = JLoopCloser(jcfg, jm)
    tc = TLoopCloser(_tcfg(jcfg), tm, device="cpu", generator=torch.Generator().manual_seed(0))

    def no_detection(kf_id):
        raise AssertionError("index_only ran a detection")

    jc._detect = tc._detect = no_detection
    assert jm.n_kf == tm.n_kf == 12          # detection would run from here
    for kf in (11, 4):
        with jax.enable_x64(False):
            assert jc.detect_only(kf, index_only=True) is None
        assert tc.detect_only(kf, index_only=True) is None
        assert tc.db.present[kf] and jc.db.present[kf]
        row_t, row_j = tc.db.vectors[kf].numpy(), np.asarray(jc.db.vectors[kf])
        assert (row_j > 0).sum() > 10
        np.testing.assert_allclose(row_t, row_j, atol=1e-6)
    np.testing.assert_array_equal(tc.db.present, jc.db.present)
    rec = tc.stats["keyframes"][-1]
    assert rec["kf"] == 4 and rec["index_only"] is True


def test_failed_loop_detection_lands_in_worker_errors():
    jcfg = j_syn.synthetic_rgbl_config()
    ts = TSystem(_tcfg(jcfg), device="cpu")
    ts.async_mapping = True
    ts._spawn_components(64)
    calls = []

    def failing(kf_id, index_only=False):
        calls.append((kf_id, threading.current_thread().name))
        raise RuntimeError(f"detection of keyframe {kf_id} broke")

    ts.loop_closer.detect_only = failing
    ts._enqueue_loop_detect(3)
    ts._enqueue_loop_detect(4)
    ts._join_mapping()
    assert [c[0] for c in calls] == [3, 4] and {c[1] for c in calls} == {"loop_0"}
    assert len(ts.worker_errors) == 2
    assert "detection of keyframe 3 broke" in ts.worker_errors[0]
    assert "RuntimeError" in ts.worker_errors[1]
    assert ts._loop_future is None and not ts._loop_queue
    # the plane goes on: no event, no merge candidate of the failed keyframes
    assert not ts._loop_inbox and ts._merge_candidate is None
    ts.shutdown()
