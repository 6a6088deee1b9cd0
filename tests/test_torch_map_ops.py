"""Port vs JAX: the mapping plane's map operations (numpy on both sides)
on the same map state, copied through ``convert.map_state_from_numpy``.
After every operation every array, the free list, the cull redirects and
the counters are equal exactly (tolerance 0: the port carries the JAX
package's arithmetic and tie rules over as they are)."""

import dataclasses

import numpy as np
import pytest

from orb_slam3_rgbl_tpu.geometry.camera import PinholeCamera as JCamera
from orb_slam3_rgbl_tpu.slam import map_state as j_ms
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.slam import map_state as t_ms

K, N, M = 12, 96, 600
CAM = JCamera(fx=420.0, fy=415.0, cx=160.0, cy=96.0, width=320, height=192, bf=40.0)


def _build(seed):
    """A JAX map of K keyframes along a line looking at a cloud of
    landmarks: every keyframe binds the landmarks that project inside its
    image (up to N), so landmarks have 1 to K observers; a few slots are
    bound twice to one landmark and a few landmarks are left with no
    observer, for the dedup and orphan paths."""
    rng = np.random.default_rng(seed)
    m = j_ms.MapState.create(K + 2, M, N, map_id=1)
    X = np.stack([rng.uniform(-6, 6, 400), rng.uniform(-2, 2, 400), rng.uniform(6, 30, 400)], 1)
    for k in range(K):
        q = np.array([1.0, 0, 0, 0]) + rng.normal(0, 0.02, 4)
        pose = np.concatenate([q / np.linalg.norm(q), [-0.4 * k, 0.0, -0.3 * k]]).astype(np.float32)
        kf = m.add_keyframe(pose, np.zeros((N, 2), np.float32), rng.integers(0, 8, N).astype(np.int16),
                            rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32),
                            np.full(N, -1.0, np.float32), np.full(N, -1.0, np.float32),
                            np.ones(N, bool), np.full(N, -1, np.int32), 0.1 * k, k,
                            angle=rng.uniform(-3, 3, N).astype(np.float32))
        if k == 0:
            m.lm_pos[:400] = X
            m.lm_valid[:400] = True
            m.lm_desc[:400] = rng.integers(0, 2 ** 32, (400, 8), dtype=np.uint32)
            m.lm_max_dist[:400] = m.lm_min_dist[:400] = 1.0
            m.lm_ref_kf[:400] = m.lm_first_kf[:400] = 0
            m.n_lm = 400
        pc = j_ms.lie.np_quat_rotate(pose[:4], X.astype(np.float32)) + pose[4:]
        uv = np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx, CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy], 1)
        vis = np.nonzero((uv[:, 0] > 0) & (uv[:, 0] < 320) & (uv[:, 1] > 0) & (uv[:, 1] < 192))[0]
        vis = rng.permutation(vis)[: N - 8]
        slots = rng.permutation(N)[: vis.size]
        m.kf_lm_idx[kf, slots] = vis
        m.kf_uv[kf, slots] = uv[vis] + rng.normal(0, 0.5, (vis.size, 2))
        m.kf_ur[kf, slots] = np.where(rng.uniform(size=vis.size) < 0.5,
                                      m.kf_uv[kf, slots, 0] - CAM.bf / pc[vis, 2], -1.0)
        m.lm_ref_kf[vis] = np.where(m.lm_ref_kf[vis] == 0, kf, m.lm_ref_kf[vis])
    # duplicates: some keyframes bind a landmark at a second slot
    for kf in (2, 5, 9):
        row = m.kf_lm_idx[kf]
        free = np.nonzero(row < 0)[0][:3]
        m.kf_lm_idx[kf, free] = row[row >= 0][:3]
    return m


def _assert_equal(tm, jm, what):
    for f in dataclasses.fields(t_ms.MapState):
        if f.name == "alloc_lock":
            continue
        a, b = getattr(tm, f.name), getattr(jm, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, (what, f.name)
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {f.name}")
        elif f.name == "kf_redirect":
            assert sorted(a) == sorted(b), (what, f.name)
            for k in a:
                assert a[k][0] == b[k][0], (what, k)
                np.testing.assert_array_equal(a[k][1], b[k][1], err_msg=f"{what}: redirect {k}")
        else:
            assert a == b, (what, f.name, a, b)


@pytest.fixture
def maps():
    jm = _build(3)
    tm = convert.map_state_from_numpy(jm)
    assert tm.alloc_lock is not jm.alloc_lock
    _assert_equal(tm, jm, "copy")
    return tm, jm


def _both(maps, what, fn):
    """Apply ``fn(map, module)`` to both maps; results and states equal."""
    tm, jm = maps
    rt, rj = fn(tm, t_ms), fn(jm, j_ms)
    _assert_equal(tm, jm, what)
    return rt, rj


@pytest.mark.parametrize("max_obs", [2, 4, 8, 12])
def test_gather_observations_exact(maps, max_obs):
    """Landmarks with more observers than ``max_obs`` keep the even-stride
    sample; the dropped count is the same."""
    window = np.array([3, 1, 7, 0, 10, 5, 8, 2, 11, 4, 9, 6])
    lm_ids = np.arange(5, 380, 3)
    rt, rj = _both(maps, "gather", lambda m, _: m.gather_observations(window, lm_ids, max_obs))
    for a, b in zip(rt, rj):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tm, jm = maps
    assert tm.last_dropped_obs == jm.last_dropped_obs
    assert (tm.last_dropped_obs > 0) == (max_obs <= 4)


def test_covisibility_matrix_exact(maps):
    (vt, Wt), (vj, Wj) = _both(maps, "covisibility", lambda m, _: m.covisibility_matrix(max_obs=6))
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(Wt, Wj)
    assert Wt.max() > 15 and (Wt == Wt.T).all()


def test_landmark_stats_dedup_and_checks_exact(maps):
    tm, jm = maps
    faults_t, faults_j = _both(maps, "check", lambda m, mod: mod.check_binding_consistency(m))
    assert faults_t == faults_j and any("twice" in s for s in faults_t)
    _both(maps, "dedup", lambda m, mod: mod.dedup_kf_bindings(m))
    _both(maps, "stats by keyframe", lambda m, _: m.update_landmark_stats(np.array([4, 7])))
    _both(maps, "stats by landmark",
          lambda m, _: m.update_landmark_stats(lm_ids=np.array([-1, 3, 3, 50, 399, 120])))
    assert np.abs(tm.lm_normal).sum() > 0 and tm.lm_max_dist[50] != 1.0
    faults_t, faults_j = _both(maps, "check", lambda m, mod: mod.check_binding_consistency(m))
    assert faults_t == faults_j and not any("twice" in s for s in faults_t)
    et, ej = _both(maps, "reprojection", lambda m, mod: mod.debug_reprojection_error(m, CAM))
    assert et == ej and et["n"] > 500 and et["median_px"] < 2.0


def test_remove_and_cull_exact(maps):
    tm, jm = maps
    _both(maps, "dedup", lambda m, mod: mod.dedup_kf_bindings(m))
    _both(maps, "remove landmarks",
          lambda m, _: m.remove_landmarks(np.array([7, 7, 12, 300, 41])))
    assert not tm.lm_valid[[7, 12, 300, 41]].any() and tm.lm_gen[7] == 1
    assert tm.lm_free == jm.lm_free and len(tm.lm_free) >= 4
    # unbind every observation of a few landmarks, then cull the orphans
    seen = int(np.argmax(tm.observation_counts()))

    def unbind(m, _):
        for lm in (20, 21, 22):
            m.kf_lm_idx[m.kf_lm_idx == lm] = -1
        m.cull_orphans(np.array([20, 21, 22, seen, -1, 7]))
    _both(maps, "cull orphans", unbind)
    assert seen not in (20, 21, 22) and not tm.lm_valid[[20, 21, 22]].any() and tm.lm_valid[seen]
    # recycled slots come back last-freed first
    def add(m, _):
        return m.add_landmarks(np.ones((5, 3), np.float32), np.zeros((5, 8), np.uint32), 3,
                               np.array([90, 91, 92, 93, 94]), np.ones((5, 3), np.float32),
                               np.ones(5, np.float32), np.ones(5, np.float32))
    it, ij = _both(maps, "add after free", add)
    np.testing.assert_array_equal(it, ij)


@pytest.mark.parametrize("kf", [5, 11, 0])
def test_remove_keyframe_exact(maps, kf):
    tm, jm = maps
    _both(maps, "dedup", lambda m, mod: mod.dedup_kf_bindings(m))
    _both(maps, "remove keyframe", lambda m, _: m.remove_keyframe(kf))
    assert not tm.kf_valid[kf] and kf in tm.kf_redirect
    _both(maps, "second keyframe", lambda m, _: m.remove_keyframe(6))
    for k in range(K):
        assert tm.live_ref_kf(k) == jm.live_ref_kf(k)
        np.testing.assert_array_equal(tm.effective_kf_pose(k), jm.effective_kf_pose(k))
    faults_t, faults_j = _both(maps, "check", lambda m, mod: mod.check_binding_consistency(m))
    assert faults_t == faults_j
