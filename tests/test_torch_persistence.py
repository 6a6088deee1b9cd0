"""Port vs JAX: atlas and map checkpoints, resuming from one, and
localization mode.

Both ``System``s (the default configuration: mapping and loop closing on)
drive the 320×192 canyon's first 11 frames with a keyframe every 3 and save
their atlas. Archives cross between the packages in both directions: the
map arrays, counters and trajectory segments load exact, database rows to
1e-6 (observed equal: the rows travel as f32). The inertial state (the
velocity, bias and IMU-chain arrays, the preintegrations,
``imu_initialized``) crosses both ways exact, an initialized inertial map
included. Then a fresh System of each package loads the JAX archive and
sees frame 7 again, later in time: both relocalize on that frame — the
port's PnP RANSAC fed the integers JAX's key chain draws, since RANSAC
decides the pose — to the same reference keyframe, poses within 1e-3 m
(test_torch_reloc.py's bar for a relocalization on JAX's draws). Both then
switch to localization mode for frames 8–16, the last six past the mapped
stretch: every frame OK on both, no keyframe, every map array unchanged but
the two visibility counters (which the reference's localization mode bumps
too), the visual-odometry branch reached past the map, centres within 5 mm.

JAX runs with x64 off, as outside the test suite (see test_torch_frame)."""

import dataclasses
import json

import numpy as np
import jax
import pytest
import torch

from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu.slam.loop_closing import _pair_tier
from orb_slam3_rgbl_tpu.slam.map_state import MapState as JMapState
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu.utils import serialization as j_ser
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from orb_slam3_rgbl_tpu_torch.slam import tracking as t_trk
from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState as TMapState
from orb_slam3_rgbl_tpu_torch.slam.system import System as TSystem
from orb_slam3_rgbl_tpu_torch.utils import serialization as t_ser

from test_torch_system import CLOUD_CAP, _render, one_torch_thread  # noqa: F401  (autouse)

N_MAPPED, N_TOTAL, BACK_TO = 11, 17, 7
DB_TOL = 1e-6
RELOC_TOL_M = 1e-3
POSE_TOL_M = 5e-3
VISIBILITY = ("lm_visible", "lm_found")   # bumped by tracking in localization mode too
ARRAYS = [f.name for f in dataclasses.fields(TMapState)
          if f.name.startswith(("kf_", "lm_")) and f.name not in ("lm_free", "kf_redirect")]


def _map_arrays(m):
    return {k: np.asarray(getattr(m, k)) for k in ARRAYS}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    traj = j_syn.straight_trajectory(N_TOTAL, step=0.6, weave=0.4)
    cfg, frames = _render(traj)
    cfg = dataclasses.replace(cfg, loop_closing=True)
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    js, ts = JSystem(cfg), TSystem(tcfg, device="cpu")
    js.CLOUD_CAP = ts.CLOUD_CAP = CLOUD_CAP
    with jax.enable_x64(False):
        for i, (img, pts) in enumerate(frames[:N_MAPPED]):
            rj, rt = js.track_rgbl(img, pts, i * 0.1), ts.track_rgbl(img, pts, i * 0.1)
            for s in (js, ts):
                s.tracker.force_kf_every = 3
            assert rj.state == rt.state == t_trk.OK, i
    d = tmp_path_factory.mktemp("atlas")
    paths = {"jax": str(d / "jax.npz"), "port": str(d / "port.npz")}
    js.save_atlas(paths["jax"])
    ts.save_atlas(paths["port"])
    return cfg, tcfg, traj, frames, js, ts, paths


def _check_entry(m_loaded, m_ref, db_loaded, db_ref):
    for k, v in _map_arrays(m_ref).items():
        got = np.asarray(getattr(m_loaded, k))
        assert got.dtype == v.dtype and np.array_equal(got, v), k
    for k in ("n_kf", "n_lm", "version", "map_id"):
        assert getattr(m_loaded, k) == getattr(m_ref, k), k
    v_l = db_loaded.vectors.cpu().numpy() if isinstance(db_loaded.vectors, torch.Tensor) \
        else db_loaded.vectors
    v_r = db_ref.vectors.cpu().numpy() if isinstance(db_ref.vectors, torch.Tensor) \
        else db_ref.vectors
    np.testing.assert_allclose(v_l, v_r, atol=DB_TOL, rtol=0)
    np.testing.assert_array_equal(db_loaded.present, db_ref.present)


def _check_trajectory(sys_loaded, sys_ref):
    t_l, t_r = sys_loaded.tracker, sys_ref.tracker
    np.testing.assert_array_equal(np.stack(t_l.traj_rel), np.stack(t_r.traj_rel))
    assert t_l.traj_ref_kf == t_r.traj_ref_kf and t_l.traj_lost == t_r.traj_lost
    assert t_l.traj_time == t_r.traj_time


def test_vocabulary_checksums_agree():
    assert t_ser.vocabulary_checksum() == j_ser.vocabulary_checksum()
    assert t_ser.FORMAT_VERSION == j_ser.FORMAT_VERSION


def test_port_atlas_round_trip(saved):
    _, tcfg, _, _, _, ts, paths = saved
    with np.load(paths["port"]) as data:
        assert data["m0_kf_desc"].dtype == np.uint32
    loaded = TSystem(tcfg, device="cpu")
    loaded.load_atlas(paths["port"])
    assert loaded.atlas.n_maps() == 1 and loaded.map.n_kf >= 4
    _check_entry(loaded.map, ts.map, loaded.loop_closer.db, ts.loop_closer.db)
    _check_trajectory(loaded, ts)
    t = loaded.tracker
    assert t.state == t_trk.LOST and t.frame_id == N_MAPPED - 1
    assert t.kf_db is loaded.loop_closer.db is loaded.atlas.entries[0].db
    assert loaded.mapper is not None and loaded.mapper.map is loaded.map
    np.testing.assert_array_equal(loaded.trajectory(), ts.trajectory())


def test_archives_cross_between_packages(saved):
    cfg, tcfg, _, _, js, ts, paths = saved
    with jax.enable_x64(False):
        j_loaded = JSystem(cfg)
        j_loaded.load_atlas(paths["port"])
    _check_entry(j_loaded.map, ts.map, j_loaded.loop_closer.db, ts.loop_closer.db)
    _check_trajectory(j_loaded, ts)
    # a complete JAX map: the inertial arrays of a map without an IMU
    assert j_loaded.map.kf_vel.shape == (ts.map.capacity_kf, 3)
    assert (j_loaded.map.kf_prev_imu == -1).all() and j_loaded.map.imu_preint == {}
    t_loaded = TSystem(tcfg, device="cpu")
    t_loaded.load_atlas(paths["jax"])
    _check_entry(t_loaded.map, js.map, t_loaded.loop_closer.db, js.loop_closer.db)
    _check_trajectory(t_loaded, js)
    assert t_loaded.tracker.frame_id == j_loaded.tracker.frame_id == N_MAPPED - 1
    # the same keys and meta in both packages' archives
    with np.load(paths["jax"]) as dj, np.load(paths["port"]) as dt:
        assert set(dj.files) == set(dt.files)
        mj, mt = json.loads(str(dj["__meta__"])), json.loads(str(dt["__meta__"]))
    assert mj.keys() == mt.keys() and mj["maps"][0].keys() == mt["maps"][0].keys()


def test_single_map_round_trip_both_ways(saved, tmp_path):
    _, _, _, _, js, ts, _ = saved
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j_ser.save_map(pj, js.map)
    ts.save_map(pt)
    m_t = t_ser.load_map(pj)
    with jax.enable_x64(False):
        m_j = j_ser.load_map(pt)
    for m_loaded, m_ref in ((m_t, js.map), (m_j, ts.map)):
        for k, v in _map_arrays(m_ref).items():
            assert np.array_equal(np.asarray(getattr(m_loaded, k)), v), k
        assert m_loaded.n_kf == m_ref.n_kf and m_loaded.version == m_ref.version
    assert isinstance(m_j, JMapState) and isinstance(m_t, TMapState)


def test_vocabulary_guard_and_inertial_maps(saved, tmp_path, monkeypatch):
    _, tcfg, _, _, js, _, paths = saved
    with monkeypatch.context() as mp:
        mp.setattr(t_ser, "vocabulary_checksum", lambda: "deadbeef")
        with pytest.raises(ValueError, match="vocabulary"):
            t_ser.load_atlas(paths["jax"], tcfg, device="cpu")
        with pytest.raises(ValueError, match="vocabulary"):
            TSystem(tcfg, device="cpu").load_atlas(paths["jax"])
        assert t_ser.load_atlas(paths["jax"], tcfg, strict_vocab=False, device="cpu").n_maps() == 1
    with np.load(paths["jax"]) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(str(arrays.pop("__meta__")))
    # a preintegration chain on a map whose IMU is not initialized: ignored
    arrays["m0_imu_pre_ids"] = np.array([1, 2], np.int32)
    for j in range(12):
        arrays[f"m0_imu_pre_f{j}"] = np.ones((2, 3), np.float32)
    path = str(tmp_path / "preint.npz")
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)
    atlas = t_ser.load_atlas(path, tcfg, device="cpu")
    assert np.array_equal(atlas.entries[0].map.kf_pose, js.map.kf_pose)
    assert sorted(atlas.entries[0].map.imu_preint) == [1, 2]
    assert not atlas.entries[0].map.imu_initialized
    # an initialized inertial map: loaded, its IMU state with it
    meta["maps"][0]["imu_initialized"] = True
    path = str(tmp_path / "inertial.npz")
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)
    m = t_ser.load_atlas(path, tcfg, device="cpu").entries[0].map
    assert m.imu_initialized and sorted(m.imu_preint) == [1, 2]
    np.testing.assert_array_equal(m.imu_preint[2][5], np.ones(3, np.float32))


def test_initialized_inertial_archive_both_ways(saved, tmp_path):
    """An initialized inertial map (the JAX map given velocities, biases, a
    temporal IMU chain and its preintegrations) saved by JAX loads in the
    port, and the port's archive of it loads back in JAX: every inertial
    array and preintegration exact, ``imu_initialized`` kept."""
    cfg, tcfg, _, _, _, _, paths = saved
    rng = np.random.default_rng(5)
    with jax.enable_x64(False):
        j_sys = JSystem(cfg)
        j_sys.load_atlas(paths["jax"])
    m = j_sys.map
    kfs = m.valid_kf_ids()
    m.kf_vel[kfs] = rng.normal(size=(kfs.size, 3)).astype(np.float32)
    m.kf_bg[kfs] = rng.normal(0, 0.01, (kfs.size, 3)).astype(np.float32)
    m.kf_ba[kfs] = rng.normal(0, 0.1, (kfs.size, 3)).astype(np.float32)
    m.kf_prev_imu[kfs[1:]] = kfs[:-1]
    shapes = [(), (4,), (3,), (3,), (3, 3), (3, 3), (3, 3), (3, 3), (3, 3), (9, 9), (3,), (3,)]
    m.imu_preint = {int(k): tuple(rng.normal(size=sh).astype(np.float32) for sh in shapes)
                    for k in kfs[1:]}
    m.imu_initialized = True
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    with jax.enable_x64(False):
        j_sys.save_atlas(pj)
    t_sys = TSystem(tcfg, device="cpu")
    t_sys.load_atlas(pj)
    t_sys.save_atlas(pt)
    with jax.enable_x64(False):
        j_back = JSystem(cfg)
        j_back.load_atlas(pt)
    for loaded in (t_sys.map, j_back.map):
        assert loaded.imu_initialized
        for k in ("kf_vel", "kf_bg", "kf_ba", "kf_prev_imu"):
            np.testing.assert_array_equal(getattr(loaded, k), getattr(m, k))
        assert sorted(loaded.imu_preint) == sorted(m.imu_preint)
        for k, t in m.imu_preint.items():
            for a, b in zip(loaded.imu_preint[k], t):
                np.testing.assert_array_equal(np.asarray(a), b)
    with np.load(pj) as dj, np.load(pt) as dt:
        assert set(dj.files) == set(dt.files)


@pytest.fixture(scope="module")
def resumed(saved):
    """Fresh Systems of both packages load the JAX archive, see frame 7
    again (relocalization), then frames 8–16 in localization mode."""
    cfg, tcfg, _, frames, _, _, paths = saved
    js, ts = JSystem(cfg), TSystem(tcfg, device="cpu")
    js.CLOUD_CAP = ts.CLOUD_CAP = CLOUD_CAP
    with jax.enable_x64(False):
        js.load_atlas(paths["jax"])
        ts.load_atlas(paths["jax"])
        # the port draws what JAX will draw: the same chain of key splits
        chain = [js.tracker._reloc_key]

        def jax_draws(n_pairs):
            chain[0], sub = jax.random.split(chain[0])
            return torch.from_numpy(np.asarray(jax.random.randint(
                sub, (t_trk.RELOC_HYPOTHESES, 3), 0, _pair_tier(n_pairs))))

        ts.tracker._reloc_draws = jax_draws
        img, pts = frames[BACK_TO]
        t0 = N_MAPPED * 0.1
        reloc = (js.track_rgbl(img, pts, t0), ts.track_rgbl(img, pts, t0),
                 js.tracker.ref_kf, ts.tracker.ref_kf)
        before = (_map_arrays(js.map), _map_arrays(ts.map),
                  (js.map.n_kf, js.map.n_lm, js.map.version),
                  (ts.map.n_kf, ts.map.n_lm, ts.map.version))
        js.activate_localization_mode()
        ts.activate_localization_mode()
        log = []
        for k, i in enumerate(range(BACK_TO + 1, N_TOTAL)):
            img, pts = frames[i]
            t = t0 + (k + 1) * 0.1
            rj, rt = js.track_rgbl(img, pts, t), ts.track_rgbl(img, pts, t)
            log.append((i, rj, rt, js.tracker._loc_total_inliers, ts.tracker._loc_total_inliers))
    return js, ts, reloc, before, log


def test_both_packages_relocalize_after_load(saved, resumed):
    traj = saved[2]
    js, ts, (rj, rt, ref_j, ref_t), _, _ = resumed
    assert rj.state == rt.state == t_trk.OK
    assert js.tracker.last_reloc_frame == ts.tracker.last_reloc_frame == N_MAPPED
    assert ref_t == ref_j
    assert abs(rt.n_inliers - rj.n_inliers) <= 0.05 * rj.n_inliers
    c_t, c_j = t_lie.np_se3_centers(rt.pose[None]), t_lie.np_se3_centers(rj.pose[None])
    assert np.abs(c_t - c_j).max() < RELOC_TOL_M, np.abs(c_t - c_j).max()
    gt = traj[BACK_TO, 4:7] - traj[0, 4:7]
    assert np.abs(c_t[0] - gt).max() < 0.15


def test_localization_mode_freezes_the_map_on_both(saved, resumed):
    traj = saved[2]
    js, ts, _, (arr_j, arr_t, cnt_j, cnt_t), log = resumed
    assert js.tracker.only_tracking and ts.tracker.only_tracking
    for i, rj, rt, _, _ in log:
        assert rj.state == rt.state == t_trk.OK, i
        assert not rj.created_kf and not rt.created_kf, i
    for m, before, cnt in ((js.map, arr_j, cnt_j), (ts.map, arr_t, cnt_t)):
        assert (m.n_kf, m.n_lm, m.version) == cnt
        for k, v in before.items():
            if k not in VISIBILITY:
                assert np.array_equal(np.asarray(getattr(m, k)), v), k
    # past the mapped stretch the motion model solves on map and VO points
    past = [(tj, tt) for i, _, _, tj, tt in log if i >= N_MAPPED]
    assert all(tj > 0 and tt > 0 for tj, tt in past), past
    c_j = t_lie.np_se3_centers(np.stack([r[1].pose for r in log]))
    c_t = t_lie.np_se3_centers(np.stack([r[2].pose for r in log]))
    assert np.abs(c_t - c_j).max() < POSE_TOL_M, np.abs(c_t - c_j).max()
    gt = traj[BACK_TO + 1:N_TOTAL, 4:7] - traj[0, 4:7]
    assert np.linalg.norm(c_t - gt, axis=1).max() < 0.2
    ts.deactivate_localization_mode()
    js.deactivate_localization_mode()
    assert not ts.tracker.only_tracking and not js.tracker.only_tracking
