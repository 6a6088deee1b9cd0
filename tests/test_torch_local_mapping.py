"""Port vs JAX: the local-mapping plane on one map state.

A JAX ``System(enable_mapping=True)`` drives 19 frames of the 320×192
canyon with a keyframe every 3 frames; the mapping job of its 7th keyframe
is held back, and the map as it stands (with the mapper's list of recent
landmarks) is copied into the port through ``convert.map_state_from_numpy``.
On that state:

* ``_fuse_project_batch`` (through ``fuse_project_targets``): matched
  feature indices and Hamming distances exact on every real target (the
  JAX side pads to 16 target slots, the port runs the real ones only);
* ``_triangulate_batch``: accepted pairs equal on ≥ 99%, their points
  within 1e-3 m or 2e-4 of their distance (the JAX side pads to 12
  neighbour slots, the port runs the real ones only);
* ``process_keyframe`` whole, on both: the same landmarks alive and the
  same bindings on ≥ 99% of slots, the same keyframes alive, keyframe
  poses within 1e-4 m.

JAX runs with x64 off, as outside the test suite."""

import copy
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu.slam import local_mapping as j_lm
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from orb_slam3_rgbl_tpu_torch.slam import local_mapping as t_lm
from orb_slam3_rgbl_tpu_torch.slam import map_state as t_ms

from test_torch_system import CLOUD_CAP, _render

N_FRAMES, KF_EVERY = 19, 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def state():
    """(JAX system with the last keyframe's mapping job pending, that
    keyframe's id, the port's config)."""
    traj = j_syn.straight_trajectory(N_FRAMES, step=0.6, weave=0.4)
    cfg, frames = _render(traj)
    js = JSystem(cfg, enable_mapping=True)
    js.CLOUD_CAP = CLOUD_CAP
    held = []
    with jax.enable_x64(False):
        for i, (img, pts) in enumerate(frames):
            if i == N_FRAMES - 1:
                js._dispatch_mapping = held.append
            res = js.track_rgbl(img, pts, i * 0.1)
            js.tracker.force_kf_every = KF_EVERY
    assert res.created_kf and held == [js.map.n_kf - 1] and js.map.n_kf >= 7
    return js, held[0], convert.config_from_dict(dataclasses.asdict(cfg))


def _port_mapper(js, tcfg):
    tm = convert.map_state_from_numpy(js.map)
    mapper = t_lm.LocalMapper(tcfg, tm, device="cpu")
    mapper.recent_lm = [(ids.copy(), born) for ids, born in js.mapper.recent_lm]
    return mapper


def test_device_kf_cache_mirrors_the_map(state):
    js, kf_id, tcfg = state
    mapper = _port_mapper(js, tcfg)
    c, m = mapper.dev_cache, mapper.map
    c.ensure(m, range(m.n_kf))
    assert c.have == set(range(m.n_kf)) and c.d_desc.dtype == torch.int32
    k = kf_id
    np.testing.assert_array_equal(c.d_uv[k].numpy(), m.kf_uv[k])
    np.testing.assert_array_equal(c.d_desc[k].numpy().view(np.uint32), m.kf_desc[k])
    np.testing.assert_array_equal(c.d_oct[k].numpy(), m.kf_octave[k])
    np.testing.assert_array_equal(c.d_valid[k].numpy(), m.kf_feat_valid[k])
    np.testing.assert_array_equal(c.d_ur[k].numpy(), m.kf_ur[k])
    # a row written in place: the arrays keep their storage, and grow by copy
    ptr = c.d_uv.data_ptr()
    c.add(3, t_lm._HostFeats(m.kf_uv[2], m.kf_desc[2], m.kf_octave[2].astype(np.int32),
                             m.kf_angle[2], m.kf_feat_valid[2], m.kf_ur[2]))
    assert c.d_uv.data_ptr() == ptr
    np.testing.assert_array_equal(c.d_uv[3].numpy(), m.kf_uv[2])
    c.add(c.cap + 5, t_lm._HostFeats(m.kf_uv[1], m.kf_desc[1], m.kf_octave[1].astype(np.int32),
                                     m.kf_angle[1], m.kf_feat_valid[1], m.kf_ur[1]))
    assert c.cap == 256 and c.d_uv.shape[0] == 256
    np.testing.assert_array_equal(c.d_uv[k].numpy(), m.kf_uv[k])
    np.testing.assert_array_equal(c.d_angle[133].numpy(), m.kf_angle[1])


def test_fuse_project_batch_exact(state):
    """This keyframe's landmarks into every earlier keyframe (6 real
    targets; 10 more padded slots on the JAX side), and the
    neighbourhood's landmarks back into it (one target, 2·N landmark
    slots)."""
    js, kf_id, tcfg = state
    jm = js.map
    mapper = _port_mapper(js, tcfg)
    cap = jm.n_features
    own = np.unique(jm.kf_lm_idx[kf_id][jm.kf_lm_idx[kf_id] >= 0])
    others = np.unique(jm.kf_lm_idx[:kf_id][jm.kf_lm_idx[:kf_id] >= 0])
    others = others[~np.isin(others, own)]
    n_matched = 0
    for lm_ids, targets, TB, size in ((own, np.arange(kf_id), 16, cap),
                                      (others, np.array([kf_id]), 1, 2 * cap)):
        lm_ids = lm_ids[:size]
        P = np.zeros((size, 3), np.float32)
        Pdesc = np.zeros((size, 8), np.uint32)
        Pmaxd = np.ones(size, np.float32)
        Pvalid = np.zeros(size, bool)
        P[: lm_ids.size] = jm.lm_pos[lm_ids]
        Pdesc[: lm_ids.size] = jm.lm_desc[lm_ids]
        Pmaxd[: lm_ids.size] = jm.lm_max_dist[lm_ids]
        Pvalid[: lm_ids.size] = True
        with jax.enable_x64(False):
            idx_j, d_j = j_lm.fuse_project_targets(js.mapper, targets, P, Pdesc, Pmaxd, Pvalid, TB)
        idx_t, d_t = t_lm.fuse_project_targets(mapper, targets, P, Pdesc, Pmaxd, Pvalid)
        T = len(targets)
        assert idx_t.shape == (T, size) and idx_j.shape == (TB, size)
        np.testing.assert_array_equal(idx_t, idx_j[:T].astype(np.int32))
        np.testing.assert_array_equal(d_t, d_j[:T].astype(np.float32))
        n_matched += int((idx_t >= 0).sum())
        # JAX's padded target slots hold nothing the port leaves out
        assert (idx_j[T:] == -1).all()
    assert n_matched > 300


def _triangulation_inputs(m, kf_id, NBB=12):
    nb = m.best_covisible(kf_id, 10, min_weight=1)[:NBB]
    unbound1 = (m.kf_lm_idx[kf_id] < 0) & m.kf_feat_valid[kf_id]
    unbound2 = (m.kf_lm_idx[nb] < 0) & m.kf_feat_valid[nb]

    def pad(a, fill=0):
        out = np.full((NBB,) + a.shape[1:], fill, a.dtype)
        out[: len(nb)] = a
        return out

    return nb, (np.int32(kf_id), m.kf_pose[kf_id], unbound1, pad(nb.astype(np.int32)),
                pad(m.kf_pose[nb]), pad(unbound2), pad(np.ones(len(nb), bool)))


def test_triangulate_batch_matches_jax(state):
    js, kf_id, tcfg = state
    mapper = _port_mapper(js, tcfg)
    nb, args = _triangulation_inputs(js.map, kf_id)
    assert len(nb) >= 5
    js.mapper.dev_cache.ensure(js.map, range(js.map.n_kf))
    mapper.dev_cache.ensure(mapper.map, range(mapper.map.n_kf))
    cj, ct = js.mapper.dev_cache, mapper.dev_cache
    sf = float(tcfg.orb.scale_factor)
    with jax.enable_x64(False):
        out_j = j_lm._triangulate_batch(js.mapper.geo_cam, sf, *(jnp.asarray(a) for a in args),
                                        cj.d_uv, cj.d_desc, cj.d_oct, cj.d_angle)
        f1_j, f2_j, X_j, cnt_j = (np.asarray(a) for a in out_j)
    # the port's call: the real neighbours only, no validity flags
    NB = len(nb)
    real = (args[0], args[1], args[2], args[3][:NB], args[4][:NB], args[5][:NB])
    dtypes = (torch.int64, torch.float32, torch.bool, torch.int64, torch.float32, torch.bool)
    out_t = t_lm._triangulate_batch(
        mapper.geo_cam, sf, *(torch.as_tensor(np.array(a), dtype=d) for a, d in zip(real, dtypes)),
        ct.d_uv, ct.d_desc, ct.d_oct, ct.d_angle)
    f1_t, f2_t, X_t, cnt_t = (a.numpy() for a in out_t)
    assert f1_j.shape == (12, t_lm.TRI_CAP) and t_lm.TRI_NEIGHBORS_CAP == 12
    assert f1_t.shape == (NB, t_lm.TRI_CAP) and X_t.shape == (NB, t_lm.TRI_CAP, 3)
    assert (cnt_j[NB:] == 0).all()
    n_j = n_common = 0
    worst = 0.0
    for a in range(len(nb)):
        pairs_j = {(int(f1), int(f2)): X for f1, f2, X in
                   zip(f1_j[a][: cnt_j[a]], f2_j[a][: cnt_j[a]], X_j[a])}
        pairs_t = {(int(f1), int(f2)): X for f1, f2, X in
                   zip(f1_t[a][: cnt_t[a]], f2_t[a][: cnt_t[a]], X_t[a])}
        common = pairs_j.keys() & pairs_t.keys()
        n_j += len(pairs_j | pairs_t)
        n_common += len(common)
        for key in common:
            # a triangulated point lies 20-120 m away, near the parallax
            # gate: held to 1e-3 m or 2e-4 of its distance, whichever is
            # larger (test_torch_triangulation: the packages' closed forms
            # differ by up to 7.7e-5 of the distance; 2.5 mm was seen here)
            diff = float(np.abs(pairs_t[key] - pairs_j[key]).max())
            worst = max(worst, diff / max(1.0, 0.2 * float(np.linalg.norm(pairs_j[key]))))
        # accepted pairs come in ascending feature order (the stable sort)
        assert (np.diff(f1_t[a][: cnt_t[a]]) > 0).all()
    assert n_j > 15 and n_common >= 0.99 * n_j, (n_j, n_common)
    assert worst < 1e-3, worst


def test_process_keyframe_matches_jax(state):
    """The whole mapping job of the held keyframe on both packages (the
    JAX side on a copy of its map, so the fixture stays as it was)."""
    js, kf_id, tcfg = state
    mapper = _port_mapper(js, tcfg)
    tm = mapper.map
    jm_before = convert.map_state_from_numpy(js.map)        # for "something happened"
    # the JAX job on a deep copy of its own map and mapper state
    jmap = copy.copy(js.map)
    for f in dataclasses.fields(jmap):
        v = getattr(jmap, f.name)
        if isinstance(v, np.ndarray):
            setattr(jmap, f.name, v.copy())
        elif isinstance(v, (list, dict)):
            setattr(jmap, f.name, type(v)(v))
    jmapper = j_lm.LocalMapper(js.cfg, jmap)
    jmapper.recent_lm = [(ids.copy(), born) for ids, born in js.mapper.recent_lm]
    with jax.enable_x64(False):
        jmapper.process_keyframe(kf_id)
    mapper.process_keyframe(kf_id)

    assert t_ms.check_binding_consistency(tm) == []
    np.testing.assert_array_equal(tm.kf_valid, jmap.kf_valid)
    n = max(tm.n_lm, jmap.n_lm)
    assert (tm.lm_valid[:n] == jmap.lm_valid[:n]).mean() >= 0.99
    live = tm.valid_kf_ids()
    assert (tm.kf_lm_idx[live] == jmap.kf_lm_idx[live]).mean() >= 0.99
    assert np.abs(t_lie.np_se3_centers(tm.kf_pose[live])
                  - t_lie.np_se3_centers(jmap.kf_pose[live])).max() < 1e-4
    both = tm.lm_valid[:n] & jmap.lm_valid[:n]
    assert np.median(np.abs(tm.lm_pos[:n][both] - jmap.lm_pos[:n][both]).max(axis=1)) < 1e-3
    # and the job did something: landmarks culled and created, poses moved
    c = mapper.counts
    assert c["triangulated"] > 0 and c["mp_culled"] > 0 and c["lba_runs"] == 1
    assert c["fuse_bound"] + c["fuse_replaced"] > 0
    assert np.abs(tm.kf_pose[live] - jm_before.kf_pose[live]).max() > 1e-5
    assert [len(ids) for ids, _ in mapper.recent_lm] == [len(ids) for ids, _ in jmapper.recent_lm]
    # the reference's literal 1.2 in the host reprojection gate
    ok_t = mapper._reproj_ok(tm.lm_pos[:50], tm.kf_pose[kf_id], tm.kf_uv[kf_id][:50],
                             tm.kf_octave[kf_id][:50])
    ok_j = jmapper._reproj_ok(tm.lm_pos[:50], tm.kf_pose[kf_id], tm.kf_uv[kf_id][:50],
                              tm.kf_octave[kf_id][:50])
    np.testing.assert_array_equal(ok_t, ok_j)


def test_mapper_refuses_inertial_configs(state):
    """An inertial sensor without an IMU configuration is refused; with one
    the mapper starts with its inertial state (no IMU initialization, no
    VIBA, the body ← camera extrinsic of ``cfg.imu``)."""
    from orb_slam3_rgbl_tpu_torch.config import ImuConfig

    _, _, tcfg = state
    with pytest.raises(ValueError, match="cfg.imu"):
        t_lm.LocalMapper(dataclasses.replace(tcfg, sensor=5), t_ms.MapState.create(4, 16, 8),
                         device="cpu")
    mapper = t_lm.LocalMapper(dataclasses.replace(tcfg, sensor=5, imu=ImuConfig()),
                              t_ms.MapState.create(4, 16, 8), device="cpu")
    assert not mapper.bad_imu and mapper._viba_stage == 0 and mapper._imu_init_time is None
    np.testing.assert_array_equal(mapper._T_bc, t_lie.np_se3_identity())
    assert mapper.maybe_initialize_imu() is None


def test_matching_at_the_mappers_arguments_is_exact(state):
    """``distance_table`` + ``mutual_best_match`` as triangulation calls
    them (TH_LOW, ratio 0.8, rotation check) and
    ``windowed_projection_match`` as fusion calls it (TH_LOW, no angles),
    on two real keyframes' features: indices and distances exact."""
    from orb_slam3_rgbl_tpu.ops import matching as j_match
    from orb_slam3_rgbl_tpu_torch.ops import matching as t_match

    js, kf_id, _ = state
    m = js.map
    a, b = kf_id, kf_id - 1
    unb_a = (m.kf_lm_idx[a] < 0) & m.kf_feat_valid[a]
    unb_b = (m.kf_lm_idx[b] < 0) & m.kf_feat_valid[b]
    radius = (3.0 * 1.2 ** m.kf_octave[a].astype(np.float32)).astype(np.float32)
    shifted = (m.kf_uv[a] + np.float32([2.0, -1.0])).astype(np.float32)
    with jax.enable_x64(False):
        d_j = j_match.distance_table(jnp.asarray(m.kf_desc[a]), jnp.asarray(m.kf_desc[b]),
                                     jnp.asarray(unb_a), jnp.asarray(unb_b))
        idx_j, best_j = j_match.mutual_best_match(
            d_j, jnp.asarray(m.kf_angle[a]), jnp.asarray(m.kf_angle[b]), th=j_match.TH_LOW,
            ratio=0.8, check_rotation=True)
        widx_j, wd_j = j_match.windowed_projection_match(
            jnp.asarray(shifted), jnp.asarray(m.kf_feat_valid[a]), jnp.asarray(m.kf_desc[a]),
            jnp.asarray(m.kf_octave[a].astype(np.int32)), jnp.asarray(m.kf_uv[b]),
            jnp.asarray(m.kf_feat_valid[b]), jnp.asarray(m.kf_desc[b]),
            jnp.asarray(m.kf_octave[b].astype(np.int32)), jnp.asarray(radius), th=j_match.TH_LOW)

    def t(x, dtype=None):
        x = np.array(x)
        return torch.as_tensor(x.view(np.int32) if x.dtype == np.uint32 else x, dtype=dtype)

    d_t = t_match.distance_table(t(m.kf_desc[a]), t(m.kf_desc[b]), t(unb_a), t(unb_b))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    idx_t, best_t = t_match.mutual_best_match(d_t, t(m.kf_angle[a]), t(m.kf_angle[b]),
                                              th=t_match.TH_LOW, ratio=0.8, check_rotation=True)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(best_t.numpy(), np.asarray(best_j))
    widx_t, wd_t = t_match.windowed_projection_match(
        t(shifted), t(m.kf_feat_valid[a]), t(m.kf_desc[a]), t(m.kf_octave[a], torch.int32),
        t(m.kf_uv[b]), t(m.kf_feat_valid[b]), t(m.kf_desc[b]), t(m.kf_octave[b], torch.int32),
        t(radius), th=t_match.TH_LOW)
    np.testing.assert_array_equal(widx_t.numpy(), np.asarray(widx_j))
    np.testing.assert_array_equal(wd_t.numpy(), np.asarray(wd_j))
    assert (idx_t >= 0).sum() > 5 and t_match.TH_LOW == j_match.TH_LOW == 50


def _four_rounds(remap):
    """The JAX package's path compression of the Replace remap
    (``LocalMapper._search_in_neighbors``): up to four rounds of
    ``remap[remap]``."""
    for _ in range(4):
        nxt = remap[remap]
        if np.array_equal(nxt, remap):
            break
        remap = nxt
    return remap


def test_settle_cycles_keeps_settled_remaps_and_chain_winners():
    """A cycle-free remap whose chains are at most 16 links long comes out
    of the four rounds settled, and ``_settle_cycles`` leaves it bit for bit
    as the JAX package has it. A 40-link acyclic chain goes to its winner
    (a large id, not the smallest); a planted 3-cycle with a tail goes to
    the cycle's smallest id (the rounds themselves undo a 2-cycle: its two
    members map to themselves); every other entry stays."""
    rng = np.random.default_rng(3)
    n = 400
    remap = np.arange(n, dtype=np.int32)
    perm = rng.permutation(n).astype(np.int32)
    at = 0
    while at < n - 17:                     # disjoint chains of 1–16 links
        length = int(rng.integers(1, 17))
        chain = perm[at:at + length + 1]
        remap[chain[:-1]] = chain[1:]
        at += length + 1
    jax_like = _four_rounds(remap)
    assert np.array_equal(jax_like[jax_like], jax_like)
    out = t_lm._settle_cycles(jax_like)
    assert out is jax_like

    remap = np.arange(n, dtype=np.int32)
    chain = np.arange(10, 51, dtype=np.int32)           # 10 → 11 → … → 50
    remap[chain[:-1]] = chain[1:]
    remap[[300, 200, 250]] = [200, 250, 300]            # 3-cycle 300 → 200 → 250 → 300
    remap[[301, 302]] = [302, 300]                      # tail 301 → 302 → 300
    out = t_lm._settle_cycles(_four_rounds(remap))
    assert np.all(out[chain] == 50)
    assert np.all(out[[200, 250, 300, 301, 302]] == 200)
    assert np.array_equal(out[out], out)
    rest = np.setdiff1d(np.arange(n), np.r_[chain, 200, 250, 300, 301, 302])
    np.testing.assert_array_equal(out[rest], rest)
