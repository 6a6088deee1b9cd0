"""Port vs JAX: ``System(cfg, enable_mapping=True)`` (``loop_closing``
off, the synchronous plane) over 24 frames of the 320×192 canyon with the
natural keyframe policy: after every frame the same state, keyframe
decision, keyframes alive (created and culled) and landmarks alive within
2%; camera centres within 5 mm, the bar of test_torch_system.py. Observed
on this drive: 6 keyframes, live landmarks equal on every frame, centres
within 0.08 mm (they part only after frame 26, where one landmark's fate
differs, and reach 1 cm by frame 35: the drive stops before that).

JAX runs with x64 off, as outside the test suite."""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu_torch import convert, synthetic as t_syn
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from orb_slam3_rgbl_tpu_torch.slam import map_state as t_ms
from orb_slam3_rgbl_tpu_torch.slam import tracking as t_trk
from orb_slam3_rgbl_tpu_torch.slam.local_mapping import LocalMapper
from orb_slam3_rgbl_tpu_torch.slam.system import System as TSystem

from test_torch_system import CLOUD_CAP, POSE_TOL_M, _render

N_FRAMES = 24


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def drive():
    traj = j_syn.straight_trajectory(N_FRAMES, step=0.6, weave=0.4)
    cfg, frames = _render(traj)
    js = JSystem(cfg, enable_mapping=True)
    ts = TSystem(convert.config_from_dict(dataclasses.asdict(cfg)), device="cpu")  # the default
    js.CLOUD_CAP = ts.CLOUD_CAP = CLOUD_CAP
    log = []
    with jax.enable_x64(False):
        for i, (img, pts) in enumerate(frames):
            rj, rt = js.track_rgbl(img, pts, i * 0.1), ts.track_rgbl(img, pts, i * 0.1)
            log.append((rj, rt, js.map.kf_valid.copy(), ts.map.kf_valid.copy(),
                        int(js.map.lm_valid.sum()), int(ts.map.lm_valid.sum()),
                        t_ms.check_binding_consistency(ts.map)))
    js.shutdown()
    ts.shutdown()
    return js, ts, log


def test_mapping_drive_matches_jax_frame_by_frame(drive):
    js, ts, log = drive
    assert isinstance(ts.mapper, LocalMapper) and not js.async_mapping and not ts.async_mapping
    for i, (rj, rt, kfs_j, kfs_t, lms_j, lms_t, faults) in enumerate(log):
        assert rj.state == rt.state == t_trk.OK, i
        assert rj.created_kf == rt.created_kf, i
        np.testing.assert_array_equal(kfs_t, kfs_j, err_msg=f"keyframes alive after frame {i}")
        assert abs(lms_t - lms_j) <= 0.02 * lms_j, (i, lms_j, lms_t)
        assert abs(rt.n_inliers - rj.n_inliers) <= 0.05 * rj.n_inliers, (i, rj.n_inliers, rt.n_inliers)
        assert faults == [], (i, faults)
    assert ts.map.n_kf == js.map.n_kf >= 6
    c_j = t_lie.np_se3_centers(np.stack([r[0].pose for r in log]))
    c_t = t_lie.np_se3_centers(np.stack([r[1].pose for r in log]))
    assert np.abs(c_t - c_j).max() < POSE_TOL_M, np.abs(c_t - c_j).max()


def test_mapping_plane_worked_as_in_jax(drive):
    """What the plane did: landmarks were culled, triangulated and fused,
    local BA ran after every keyframe from the third on, and the exported
    trajectory (resolved against the refined keyframe poses) agrees."""
    js, ts, _ = drive
    c = ts.mapper.counts
    assert c["mp_culled"] > 100 and c["triangulated"] > 50 and c["lba_runs"] == ts.map.n_kf - 2
    assert c["fuse_bound"] > 0 and c["fuse_replaced"] > 0
    assert ts.map.version == js.map.version
    assert len(ts.map.lm_free) == len(js.map.lm_free) > 0
    np.testing.assert_array_equal(ts.map.kf_valid, js.map.kf_valid)
    tr_t, tr_j = ts.trajectory(), js.trajectory()
    assert tr_t.shape == tr_j.shape == (N_FRAMES, 7)
    assert np.abs(tr_t[:, 4:] - tr_j[:, 4:]).max() < POSE_TOL_M
    # the keyframe mirror is fed by the tracker; the asynchronous plane's
    # hooks are wired, as in the JAX System, and idle on the synchronous plane
    t = ts.tracker
    assert t.kf_feats_hook == ts.mapper.dev_cache.add and t.join_mapping_fn == ts._join_mapping
    assert t.mapping_busy_fn() is False and t.mapping_inflight_fn() is False
    assert t.kf_guard is ts._kf_lock and t.deferred_kf == js.tracker.deferred_kf == 0
    assert ts.mapper.backlog_fn() == 0 and ts._map_exec is None and ts._map_future is None
    assert ts.mapper.dev_cache.have == set(range(ts.map.n_kf))


def test_async_mapping_is_accepted_and_wired_as_in_jax():
    """The setter takes True (the JAX default is False, as here), and
    ``_spawn_components`` wires the tracker's and the mapper's hooks as the
    JAX ``System`` does: the same answers from the busy gate, the in-flight
    test and the backlog for the same queue, job and freeze."""
    jcfg = j_syn.synthetic_rgbl_config()
    js = JSystem(jcfg, enable_mapping=True)
    ts = TSystem(convert.config_from_dict(dataclasses.asdict(jcfg)), enable_mapping=True,
                 device="cpu")
    assert js.async_mapping is ts.async_mapping is False
    ts.async_mapping = True
    assert ts.async_mapping is True
    with jax.enable_x64(False):
        js._spawn_components(64)
    ts._spawn_components(64)
    for s in (js, ts):
        t = s.tracker
        assert t.pre_kf_hook == s._poll_mapping and t.join_mapping_fn == s._join_mapping
        assert t.kf_guard is s._kf_lock and t.kf_feats_hook == s.mapper.dev_cache.add
        assert s.loop_closer.gba_dispatch == s._dispatch_gba
    assert ts.loop_closer.rng_lock is ts._rng_lock and ts.tracker.reloc_generator is ts._reloc_rng

    class Running:                    # a job in flight
        def done(self):
            return False

    for queued, running, frozen in [(0, False, False), (2, False, False), (3, False, False),
                                    (2, True, False), (1, True, False), (0, True, False),
                                    (0, False, True)]:
        answers = []
        for s in (js, ts):
            s._map_queue.clear()
            s._map_queue.extend(range(queued))
            s._map_future = Running() if running else None
            s._freeze_kf = frozen
            answers.append((s.tracker.mapping_busy_fn(), s.tracker.mapping_inflight_fn(),
                            s.mapper.backlog_fn()))
        assert answers[0] == answers[1], (queued, running, frozen, answers)
        assert answers[1][0] == (frozen or queued + running >= 3)
    for s in (js, ts):
        s._map_queue.clear()
        s._map_future = None
        s._freeze_kf = False


def test_reset_drops_the_mapper():
    cfg = dataclasses.replace(t_syn.synthetic_rgbl_config(), loop_closing=False)
    sysm = TSystem(cfg, enable_mapping=True, device="cpu")
    sysm._spawn_components(64)
    first = sysm.mapper
    assert first is not None and first.map is sysm.map and sysm._fast is None
    sysm.reset_active_map()
    assert sysm.mapper is not first and sysm.mapper.map is sysm.map
    sysm.reset()
    assert sysm.mapper is None and sysm.map is None
    off = TSystem(cfg, enable_mapping=False, device="cpu")
    off._spawn_components(64)
    assert off.mapper is None and off.tracker.kf_feats_hook is None
