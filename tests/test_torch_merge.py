"""Port vs JAX: the atlas weld (``slam/merging.py``, ``Tracker.
rebind_after_merge``, ``System._try_merge`` / ``_do_merge``).

* the weld math of ``tests/test_map_merge.py::TestWeldMath`` through both
  packages: the world alignment 1e-4 (as there), transported poses and
  landmarks 1e-5 of each other, remaps and bindings exact;
* a blackout drive of both ``System``s in the default configuration
  (``SyntheticWorld`` features, as ``tests/test_map_merge.py`` drives it, cut
  to 31 frames before the blackout, which keeps 2 archived keyframes: 12
  blank frames, the camera held at its last pose, start a second map; 10
  frames resume the path). Both weld on the same frame and keyframe pair,
  end with one atlas map and keep ATE < 0.5 m (the JAX test's bound;
  observed 0.028 and 0.032 m); the welded keyframe centres agree within
  2e-2 m (observed 1.0e-2 m: the two RANSACs draw from different streams,
  so the two welds start from Sim3s a few mm apart);
* on the JAX state caught just before its weld, copied into the port:
  ``verify_cross_map`` fed JAX's own RANSAC draws gives the same S12 to
  1e-4, the same inlier count and fusion pairs; ``merge_maps`` +
  ``apply_fusion`` give the same remaps and bindings exactly, poses and
  landmarks within 1e-5; ``rebind_after_merge`` the same tracker state
  (poses 1e-5, ids exact); ``System._do_merge`` whole: up to the
  weld-window local BA the same welded map (ids exact, geometry 1e-5;
  observed 1e-6), after it bindings on ≥ 99% of slots and keyframe centres
  within 5e-3 m (observed 1.7e-3 m: three keyframes 15 m apart on a
  straight line hold the f32 solve weakly along the view), the same atlas,
  trajectory log, database and closer state; the fused step's device
  window re-syncs on the welded map; with ``async_mapping`` on, a solve in
  flight is discarded and the queued keyframes take their welded ids by the
  JAX ``System``'s rule.

JAX runs with x64 off, as outside the test suite."""

import collections
import concurrent.futures
import copy
import dataclasses
import threading
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu.config import kitti_rgbl_config
from orb_slam3_rgbl_tpu.geometry import align as j_align, lie as j_lie
from orb_slam3_rgbl_tpu.optim import sim3 as j_sim3
from orb_slam3_rgbl_tpu.slam import merging as j_merging
from orb_slam3_rgbl_tpu.slam.map_state import MapState as JMapState
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu.slam.tracking import Tracker as JTracker
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import align as t_align, lie as t_lie
from orb_slam3_rgbl_tpu_torch.slam import map_state as t_ms, merging as t_merging
from orb_slam3_rgbl_tpu_torch.slam import tracking as t_trk
from orb_slam3_rgbl_tpu_torch.slam.atlas import Atlas
from orb_slam3_rgbl_tpu_torch.slam.fast_path import FastPath
from orb_slam3_rgbl_tpu_torch.slam.local_mapping import LocalMapper
from orb_slam3_rgbl_tpu_torch.slam.loop_closing import RANSAC_HYPOTHESES, LoopCloser
from orb_slam3_rgbl_tpu_torch.slam.system import System as TSystem

from synthetic_world import SyntheticWorld
from test_torch_loop_closing import closer_state, copy_jax_map, feats_to_port

N_FWD, N_BLANK, N_AFTER = 31, 12, 10
TOL = 1e-5
CENTRE_TOL_DRIVE = 2e-2
CENTRE_TOL_BA = 5e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the weld math of tests/test_map_merge.py::TestWeldMath, through both packages

def _rand_se3(rng):
    tau = np.concatenate([rng.normal(0, 2.0, 3), rng.normal(0, 0.4, 3)]).astype(np.float32)
    with jax.enable_x64(False):
        return np.asarray(j_lie.se3_exp(jnp.asarray(tau)), np.float32)


def _same_pose(a, b, tol):
    """Poses compared as transforms (a quaternion and its negative are one
    rotation)."""
    d = t_lie.np_se3_mul(np.asarray(a, np.float32), t_lie.np_se3_inv(np.asarray(b, np.float32)))
    np.testing.assert_allclose(d[..., 4:7], 0.0, atol=tol)
    np.testing.assert_allclose(np.abs(d[..., 0]), 1.0, atol=tol)


def test_world_alignment_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        S_w2_w1 = np.concatenate([_rand_se3(rng), [rng.uniform(0.7, 1.4)]]).astype(np.float32)
        T_c1_w1, T_c2_w2 = _rand_se3(rng), _rand_se3(rng)
        # the camera-frame constraint the weld starts from
        S_c1_w2 = t_lie.np_sim3_mul(t_lie.np_sim3_from_se3(T_c1_w1), t_lie.np_sim3_inv(S_w2_w1))
        S12 = t_lie.np_sim3_mul(S_c1_w2, t_lie.np_sim3_inv(t_lie.np_sim3_from_se3(T_c2_w2)))
        with jax.enable_x64(False):
            out_j = j_merging.world_alignment(S12, T_c1_w1, T_c2_w2)
        out_t = t_merging.world_alignment(S12, T_c1_w1, T_c2_w2)
        assert out_t.dtype == np.float32
        eye = np.eye(3, dtype=np.float32)
        np.testing.assert_allclose(t_lie.np_sim3_apply(out_t, eye),
                                   t_lie.np_sim3_apply(out_j, eye), atol=1e-4)
        np.testing.assert_allclose(t_lie.np_sim3_apply(out_t, eye),
                                   t_lie.np_sim3_apply(S_w2_w1, eye), atol=1e-4)


def _weld_maps(pkg, N=16):
    """An archived map of one keyframe and an active map of two keyframes
    and 10 landmarks, in ``pkg``'s ``MapState``; the transport between
    them; ground truth in the archived frame."""
    rng = np.random.default_rng(1)
    T_w2 = np.stack([_rand_se3(rng) for _ in range(2)])
    X_w2 = rng.normal(0, 5.0, (10, 3)).astype(np.float32)
    S_w2_w1 = np.concatenate([_rand_se3(rng), [1.25]]).astype(np.float32)
    T_w1 = t_lie.np_sim3_to_se3(t_lie.np_sim3_mul(t_lie.np_sim3_from_se3(T_w2), S_w2_w1[None]))
    X_w1 = t_lie.np_sim3_apply(t_lie.np_sim3_inv(S_w2_w1), X_w2).astype(np.float32)

    def empty(valid):
        return (np.zeros((N, 2), np.float32), np.zeros(N, np.int16),
                rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32), np.full(N, 4.0, np.float32),
                np.full(N, 3.0, np.float32), np.full(N, valid), np.full(N, -1, np.int32))

    old = pkg.create(8, 64, N)
    old.add_keyframe(t_lie.np_se3_identity(), *empty(False), 0.0, 0)
    active = pkg.create(8, 64, N, map_id=1)
    for i, T in enumerate(T_w1):
        active.add_keyframe(T.astype(np.float32), *empty(True), float(i), i)
    ids = active.add_landmarks(X_w1, rng.integers(0, 2 ** 32, (10, 8), dtype=np.uint32), 0,
                               np.arange(10), np.tile([0, 0, 1.0], (10, 1)).astype(np.float32),
                               np.ones(10, np.float32), np.full(10, 0.1, np.float32))
    active.kf_lm_idx[1, 3:13] = ids           # the second keyframe sees them too
    return old, active, S_w2_w1, T_w2, X_w2, ids


def test_merge_maps_and_fusion_match_jax():
    res = {}
    for name, pkg, mod in (("jax", JMapState, j_merging), ("port", t_ms.MapState, t_merging)):
        old, active, S, T_w2, X_w2, ids = _weld_maps(pkg)
        with jax.enable_x64(False):
            r = mod.merge_maps(old, active, 1, S)
            # two transported landmarks are duplicates of each other's twins
            fuse = mod.apply_fusion(r.map, r.lm_remap[ids[[2, 3]]], r.lm_remap[ids[[0, 1]]])
        res[name] = (r, fuse)
    (rj, fj), (rt, ft) = res["jax"], res["port"]
    mj, mt = rj.map, rt.map
    assert (mt.n_kf, mt.n_lm, rt.kf_cur_new) == (mj.n_kf, mj.n_lm, rj.kf_cur_new) == (3, 10, 2)
    for a in ("kf_remap", "lm_remap", "appended_kfs"):
        np.testing.assert_array_equal(getattr(rt, a), getattr(rj, a))
    np.testing.assert_array_equal(ft[: mt.n_lm], fj[: mj.n_lm])
    for a in ("kf_lm_idx", "kf_valid", "kf_frame_id", "kf_octave", "kf_desc", "kf_feat_valid"):
        np.testing.assert_array_equal(getattr(mt, a)[:3], getattr(mj, a)[:3])
    for a in ("lm_valid", "lm_desc", "lm_ref_kf", "lm_first_kf", "lm_gen"):
        np.testing.assert_array_equal(getattr(mt, a)[:10], getattr(mj, a)[:10])
    for a in ("kf_depth", "kf_ur"):
        np.testing.assert_allclose(getattr(mt, a)[:3], getattr(mj, a)[:3], atol=TOL)
    for a in ("lm_pos", "lm_normal", "lm_max_dist", "lm_min_dist"):
        np.testing.assert_allclose(getattr(mt, a)[:10], getattr(mj, a)[:10], atol=TOL)
    _same_pose(mt.kf_pose[:3], mj.kf_pose[:3], TOL)
    # against ground truth: the transported geometry lands on the archived frame
    _, _, S, T_w2, X_w2, ids = _weld_maps(t_ms.MapState)
    _same_pose(mt.kf_pose[rt.kf_remap[[0, 1]]], T_w2, 1e-4)
    keep = rt.lm_remap[ids[4:]]
    np.testing.assert_allclose(mt.lm_pos[keep], X_w2[4:], atol=1e-4)
    np.testing.assert_allclose(mt.kf_depth[2][mt.kf_feat_valid[2]], 4.0 * 1.25, atol=TOL)
    # the duplicates are gone, and every binding points at their twins
    assert not mt.lm_valid[rt.lm_remap[ids[[2, 3]]]].any()
    assert set(mt.lm_free) >= set(rt.lm_remap[ids[[2, 3]]].tolist())
    np.testing.assert_array_equal(mt.kf_lm_idx[rt.kf_remap[0], 2:4], rt.lm_remap[ids[[0, 1]]])


def test_map_capacity_grows_for_the_weld():
    """A weld that does not fit grows the archived map: keyframes to what
    it needs, landmarks through ``_grow_landmarks`` (doubling)."""
    old, active, S, *_ = _weld_maps(t_ms.MapState)
    old.kf_pose, old.kf_valid = old.kf_pose[:1].copy(), old.kf_valid[:1].copy()
    for a in ("kf_timestamp", "kf_frame_id", "kf_uv", "kf_octave", "kf_desc", "kf_depth",
              "kf_ur", "kf_feat_valid", "kf_lm_idx", "kf_angle"):
        setattr(old, a, getattr(old, a)[:1].copy())
    old.n_lm = 60                              # 4 free landmark slots of 64
    r = t_merging.merge_maps(old, active, 0, S)
    assert r.map.capacity_kf == 3 and r.map.n_kf == 3
    assert r.map.capacity_lm == 128 and r.map.n_lm == 70
    assert (r.map.kf_lm_idx[1:3] >= 60).sum() == 20 and r.map.kf_pose[1:, 0].all()
    for a in dataclasses.fields(t_ms.MapState):
        v = getattr(r.map, a.name)
        if isinstance(v, np.ndarray):
            assert v.shape[0] == (3 if a.name.startswith("kf_") else 128), a.name


# ---------------------------------------------------------------------------
# the blackout drive

def blackout_features():
    """(JAX config, per-frame FrameFeatures, ground-truth Tcw, blank frames):
    forward, then textureless frames with the camera held at its last pose,
    then the path resumes."""
    cfg = kitti_rgbl_config()
    n = N_FWD + N_BLANK + N_AFTER
    with jax.enable_x64(False):
        world = SyntheticWorld(np.random.default_rng(0), cam=cfg.camera, length=45.0)
        full = world.trajectory(N_FWD + N_AFTER, step=0.5)
        gt = np.stack([full[min(i, N_FWD - 1)] if i < N_FWD + N_BLANK else full[i - N_BLANK]
                       for i in range(n)])
        feats = []
        for i in range(n):
            f = world.render(gt[i])
            if N_FWD <= i < N_FWD + N_BLANK:
                f = f._replace(valid=jnp.zeros_like(f.valid))
            feats.append(f)
    return cfg, feats, gt


def _np_feats(f):
    return {k: np.array(v) for k, v in f._asdict().items()}


def _tracker_state(tr):
    st = {k: copy.deepcopy(getattr(tr, k)) for k in convert.TRACKER_STATE}
    st.update(cur_lm_idx=copy.deepcopy(getattr(tr, "cur_lm_idx", None)),
              last_feats=None if tr.last_feats is None else _np_feats(tr.last_feats),
              th_depth_m=tr.th_depth_m,
              **{k: copy.deepcopy(getattr(tr, k))
                 for k in ("traj_rel", "traj_ref_kf", "traj_time", "traj_lost")})
    return st


def _entry_copy(e):
    db = None if e.db is None else types.SimpleNamespace(
        vectors=e.db.vectors.copy(), present=e.db.present.copy(), vocabulary=e.db.vocabulary)
    return types.SimpleNamespace(map=copy_jax_map(e.map), db=db,
                                 **{k: copy.deepcopy(getattr(e, k))
                                    for k in ("traj_rel", "traj_ref_kf", "traj_time", "traj_lost")})


@pytest.fixture(scope="module")
def drive():
    """Both Systems over the blackout drive. The JAX side records the state
    just before its weld, the verification that found it (with the RANSAC
    key and the padded pair count), the tracker's rebind and the state just
    after the weld."""
    cfg, feats, gt = blackout_features()
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    js, ts = JSystem(cfg), TSystem(tcfg, device="cpu")
    rec = {"verify": [], "ransac_P": [], "frame": None}
    orig = {"verify": j_merging.verify_cross_map, "ransac": j_sim3.sim3_ransac,
            "do_merge": JSystem._do_merge, "rebind": JTracker.rebind_after_merge,
            "t_do_merge": TSystem._do_merge}

    def verify(cfg_, m1, kf1, m2, kf2, key, fix_scale):
        n = len(rec["ransac_P"])
        args = dict(m1=copy_jax_map(m1), kf1=kf1, m2=copy_jax_map(m2), kf2=kf2,
                    key=np.asarray(key), fix_scale=fix_scale)
        out = orig["verify"](cfg_, m1, kf1, m2, kf2, key, fix_scale)
        rec["verify"].append(dict(args, out=out, P=rec["ransac_P"][n:]))
        return out

    def ransac(p1, *a, **k):
        rec["ransac_P"].append(int(p1.shape[0]))
        return orig["ransac"](p1, *a, **k)

    def do_merge(self, ei, kf_cur, kf_cand, S12, fusion):
        closer = self.loop_closer
        rec["before"] = dict(
            frame=rec["frame"], ei=ei, kf_cur=kf_cur, kf_cand=kf_cand, S12=np.array(S12),
            fusion=(fusion[0].copy(), fusion[1].copy()),
            entries=[_entry_copy(e) for e in self.atlas.entries],
            active_idx=self.atlas.active_idx, next_map_id=self.atlas._next_map_id,
            n_features=self.atlas.n_features, tracker=_tracker_state(self.tracker),
            closer=closer_state(closer),
            recent_lm=[(ids.copy(), k) for ids, k in self.mapper.recent_lm])
        lba = self.mapper.local_bundle_adjustment

        def recorded_lba(kf_id, *a, **k):
            rec["pre_ba"] = copy_jax_map(self.map)
            return lba(kf_id, *a, **k)

        self.mapper.local_bundle_adjustment = recorded_lba
        try:
            orig["do_merge"](self, ei, kf_cur, kf_cand, S12, fusion)
        finally:
            del self.mapper.local_bundle_adjustment
        rec["after"] = dict(
            map=copy_jax_map(self.map), n_maps=self.atlas.n_maps(),
            active_idx=self.atlas.active_idx, tracker=_tracker_state(self.tracker),
            db_vectors=self.loop_closer.db.vectors.copy(),
            db_present=self.loop_closer.db.present.copy(),
            extra_edges=copy.deepcopy(self.loop_closer.extra_edges),
            last_loop_kf=self.loop_closer.last_loop_kf,
            recent_lm=[(ids.copy(), k) for ids, k in self.mapper.recent_lm])

    def rebind(self, new_map, kf_remap, lm_map, S_w2_w1):
        before = _tracker_state(self)
        orig["rebind"](self, new_map, kf_remap, lm_map, S_w2_w1)
        rec["rebind"] = dict(lm_gen=new_map.lm_gen.copy(), kf_remap=kf_remap.copy(),
                             lm_map=lm_map.copy(), S=np.array(S_w2_w1), before=before,
                             after=_tracker_state(self))

    def t_do_merge(self, ev):
        orig["t_do_merge"](self, ev)
        live = self.map.valid_kf_ids()
        rec["port"] = dict(frame=rec["frame"], kf_cur=ev.kf_cur, kf_matched=ev.kf_matched,
                           centres=t_lie.np_se3_centers(self.map.kf_pose[live]), S12=ev.S12,
                           faults=t_ms.check_binding_consistency(self.map))

    j_merging.verify_cross_map, j_sim3.sim3_ransac = verify, ransac
    JSystem._do_merge, JTracker.rebind_after_merge = do_merge, rebind
    TSystem._do_merge = t_do_merge
    states, maps = [], []
    try:
        with jax.enable_x64(False):
            for i, f in enumerate(feats):
                rec["frame"] = i
                rj = js.track_features(f, i * 0.1)
                rt = ts.track_features(feats_to_port(f), i * 0.1)
                states.append((rj.state, rt.state))
                maps.append((js.atlas.n_maps(), ts.atlas.n_maps()))
                if "after" in rec and "centres_j" not in rec:
                    live = js.map.valid_kf_ids()
                    rec["centres_j"] = t_lie.np_se3_centers(js.map.kf_pose[live])
    finally:
        j_merging.verify_cross_map, j_sim3.sim3_ransac = orig["verify"], orig["ransac"]
        JSystem._do_merge, JTracker.rebind_after_merge = orig["do_merge"], orig["rebind"]
        TSystem._do_merge = orig["t_do_merge"]
    return dict(cfg=cfg, tcfg=tcfg, gt=gt, js=js, ts=ts, rec=rec, states=states, maps=maps)


def _ate(sysm, gt):
    est = sysm.trajectory()
    ok = ~np.asarray(sysm.tracker.traj_lost)
    gt_twc = t_lie.np_se3_inv(gt.astype(np.float32))
    return est, float(t_align.ate_rmse(gt_twc[ok, 4:7], est[ok, 4:7]))


def test_blackout_drive_welds_like_jax(drive):
    js, ts, rec, gt = drive["js"], drive["ts"], drive["rec"], drive["gt"]
    states = np.array(drive["states"])
    np.testing.assert_array_equal(states[:, 1], states[:, 0])
    blank = states[N_FWD:N_FWD + N_BLANK, 1]
    assert blank[0] == t_trk.RECENTLY_LOST and (blank[1:] == t_trk.LOST).all()
    assert (states[N_FWD + N_BLANK:, 1] == t_trk.OK).all()
    assert (2, 2) in drive["maps"]                     # a second map started...
    assert drive["maps"][-1] == (1, 1)                 # ...and was welded back
    b, p = rec["before"], rec["port"]
    assert (p["frame"], p["kf_cur"], p["kf_matched"]) == (b["frame"], b["kf_cur"], b["kf_cand"])
    assert p["frame"] == N_FWD + N_BLANK and b["entries"][b["ei"]].map.n_kf >= 2
    assert p["faults"] == [] and p["S12"][7] == 1.0    # RGB-L fixes the scale
    # the welded keyframes: the two RANSACs draw from different streams
    assert p["centres"].shape == rec["centres_j"].shape
    np.testing.assert_allclose(p["centres"], rec["centres_j"], atol=CENTRE_TOL_DRIVE)
    est_t, ate_t = _ate(ts, gt)
    est_j, ate_j = _ate(js, gt)
    assert est_t.shape == est_j.shape == (len(gt), 7) and np.isfinite(est_t).all()
    assert ate_t < 0.5 and ate_j < 0.5, (ate_t, ate_j)
    assert t_ms.check_binding_consistency(ts.map) == []


def test_verify_cross_map_on_jax_draws(drive):
    rec, tcfg = drive["rec"], drive["tcfg"]
    calls = [c for c in rec["verify"] if c["out"] is not None]
    assert len(calls) == 1 and len(calls[0]["P"]) == 1
    c = calls[0]
    with jax.enable_x64(False):
        draws = np.asarray(jax.random.randint(jnp.asarray(c["key"]), (RANSAC_HYPOTHESES, 3), 0,
                                              c["P"][0]))
    out = t_merging.verify_cross_map(tcfg, convert.map_state_from_numpy(c["m1"]), c["kf1"],
                                     convert.map_state_from_numpy(c["m2"]), c["kf2"],
                                     c["fix_scale"], draws=torch.from_numpy(draws), device="cpu")
    S_j, n_j, (lm1_j, lm2_j) = c["out"]
    S_t, n_t, (lm1_t, lm2_t) = out
    assert S_t.dtype == np.float32 and n_t == n_j >= 25
    sign = np.sign(np.dot(S_t[:4], S_j[:4]))
    np.testing.assert_allclose(S_t[:4] * sign, S_j[:4], atol=1e-4)
    np.testing.assert_allclose(S_t[4:], S_j[4:], atol=1e-4)
    np.testing.assert_array_equal(lm1_t, lm1_j)
    np.testing.assert_array_equal(lm2_t, lm2_j)
    # a keyframe with too few bound features is refused before any match
    m1 = convert.map_state_from_numpy(c["m1"])
    m1.kf_lm_idx[c["kf1"]] = -1
    assert t_merging.verify_cross_map(tcfg, m1, c["kf1"], convert.map_state_from_numpy(c["m2"]),
                                      c["kf2"], True, draws=torch.from_numpy(draws),
                                      device="cpu") is None


def test_rebind_after_merge_matches_jax(drive):
    rec, tcfg = drive["rec"], drive["tcfg"]
    r = rec["rebind"]
    new_map = convert.map_state_from_numpy(rec["after"]["map"])
    new_map.lm_gen = r["lm_gen"].copy()
    tr = t_trk.Tracker(tcfg, None, device="cpu")
    convert.tracker_state_from_numpy(tr, r["before"])
    tr._stat_buffer.append(("stale", 0))
    S = r["S"].copy()
    S[7] = 1.3                       # a scaled weld moves depths and velocity too
    with jax.enable_x64(False):
        jt = JTracker(drive["cfg"], None)
    for k, v in r["before"].items():
        if k == "last_feats":
            v = type(drive["js"].tracker.last_feats)(**{f: jnp.asarray(a) for f, a in v.items()})
        setattr(jt, k, copy.deepcopy(v))
    for s in (r["S"], S):
        t_tr = copy.copy(tr)
        t_tr._stat_buffer = list(tr._stat_buffer)
        j_tr = copy.copy(jt)
        with jax.enable_x64(False):
            j_tr.rebind_after_merge(rec["after"]["map"], r["kf_remap"], r["lm_map"], s)
        t_tr.rebind_after_merge(new_map, r["kf_remap"], r["lm_map"], s)
        assert t_tr.map is new_map and t_tr._stat_buffer == []
        for k in ("cur_pose", "last_pose", "velocity"):
            if getattr(j_tr, k) is None:
                assert getattr(t_tr, k) is None
            else:
                np.testing.assert_allclose(getattr(t_tr, k), getattr(j_tr, k), atol=TOL)
        for k in ("last_lm_idx", "last_lm_gen", "cur_lm_idx"):
            np.testing.assert_array_equal(getattr(t_tr, k), getattr(j_tr, k))
        assert t_tr.ref_kf == j_tr.ref_kf and t_tr.th_depth_m == pytest.approx(j_tr.th_depth_m)
        np.testing.assert_allclose(t_tr.last_feats.depth.numpy(),
                                   np.asarray(j_tr.last_feats.depth), atol=TOL)


def port_system_before_weld(drive):
    """The port's ``System`` on a copy of the JAX System's state just
    before its weld: the atlas entries with their databases, the tracker,
    the mapping plane's recent landmarks and the closer."""
    b, tcfg = drive["rec"]["before"], drive["tcfg"]
    ts = TSystem(tcfg, device="cpu")
    ts.atlas = Atlas(tcfg, b["n_features"])
    ts.atlas.entries = [convert.atlas_entry_from_numpy(e, device="cpu") for e in b["entries"]]
    ts.atlas.active_idx, ts.atlas._next_map_id = b["active_idx"], b["next_map_id"]
    ts.map = ts.atlas.active
    ts.tracker = t_trk.Tracker(tcfg, ts.map, device="cpu")
    convert.tracker_state_from_numpy(ts.tracker, b["tracker"])
    ts.mapper = LocalMapper(tcfg, ts.map, device="cpu")
    ts.mapper.recent_lm = [(ids.copy(), k) for ids, k in b["recent_lm"]]
    ts.loop_closer = LoopCloser(tcfg, ts.map, device="cpu", generator=ts._loop_rng,
                                dev_cache=ts.mapper.dev_cache)
    convert.loop_closer_state_from_numpy(ts.loop_closer, b["closer"])
    ts.atlas.entries[ts.atlas.active_idx].db = ts.tracker.kf_db = ts.loop_closer.db
    return ts


def test_do_merge_matches_jax(drive):
    rec = drive["rec"]
    b, a = rec["before"], rec["after"]
    ts = port_system_before_weld(drive)
    old_entry = ts.atlas.entries[b["ei"]]
    active_map = ts.map
    # the fused step's device window, synced on the active map before the weld
    fp = FastPath(drive["tcfg"], ts.map.n_features, device="cpu")
    fp.sync(ts.map, ts.tracker.ref_kf, ts.tracker.last_feats, ts.tracker.last_lm_idx,
            ts.tracker.last_lm_gen)
    # what the map decides (the last frame's own features carry over)
    map_state = ("win_pos", "win_desc", "win_maxdist", "win_valid", "prev_Xw", "prev_bound")
    old_window = [getattr(fp, k) for k in map_state]
    ts.mapper.dev_cache.ensure(active_map, active_map.valid_kf_ids())
    lba, pre_ba = ts.mapper.local_bundle_adjustment, {}

    def recorded_lba(kf_id, *a, **k):
        pre_ba.update(kf_id=kf_id, map=copy_jax_map(ts.map))
        return lba(kf_id, *a, **k)

    ts.mapper.local_bundle_adjustment = recorded_lba
    ts._do_merge(t_merging.MergeEvent(kf_cur=b["kf_cur"], kf_matched=b["kf_cand"],
                                      entry_idx=b["ei"], n_inliers=0, S12=b["S12"],
                                      fusion=b["fusion"]))
    m, jm = ts.map, a["map"]
    # the weld itself, up to the weld-window BA: ids exact, geometry 1e-5
    pm, pj = pre_ba["map"], rec["pre_ba"]
    assert pre_ba["kf_id"] == a["last_loop_kf"] == pm.n_kf - 1
    assert (pm.n_kf, pm.n_lm) == (pj.n_kf, pj.n_lm)

    def rows(m, name):
        return getattr(m, name)[: m.n_kf if name.startswith("kf_") else m.n_lm]

    for name in ("kf_lm_idx", "kf_valid", "lm_valid", "lm_gen", "lm_ref_kf", "lm_first_kf",
                 "kf_desc", "lm_desc", "lm_visible", "lm_found"):
        np.testing.assert_array_equal(rows(pm, name), rows(pj, name), err_msg=name)
    _same_pose(rows(pm, "kf_pose"), rows(pj, "kf_pose"), TOL)
    for name in ("lm_pos", "lm_normal", "lm_max_dist", "lm_min_dist", "kf_depth", "kf_ur"):
        np.testing.assert_allclose(rows(pm, name), rows(pj, name), atol=TOL, err_msg=name)
    assert sorted(pm.lm_free) == sorted(pj.lm_free) and t_ms.check_binding_consistency(pm) == []
    assert m is old_entry.map and ts.atlas.n_maps() == a["n_maps"] == 1
    assert ts.atlas.active_idx == a["active_idx"] and ts.atlas.entries[0] is old_entry
    assert ts.mapper.map is m and ts.loop_closer.map is m and ts.tracker.map is m
    assert ts.loop_closer.db is old_entry.db is ts.tracker.kf_db
    assert (m.n_kf, m.n_lm) == (jm.n_kf, jm.n_lm)
    np.testing.assert_array_equal(m.kf_valid, jm.kf_valid)
    np.testing.assert_array_equal(m.kf_frame_id[: m.n_kf], jm.kf_frame_id[: jm.n_kf])
    same = (m.kf_lm_idx == jm.kf_lm_idx)[m.kf_valid]
    assert same.mean() >= 0.99, same.mean()
    assert (m.lm_valid[: m.n_lm] == jm.lm_valid[: jm.n_lm]).mean() >= 0.99
    live = m.valid_kf_ids()
    np.testing.assert_allclose(t_lie.np_se3_centers(m.kf_pose[live]),
                               t_lie.np_se3_centers(jm.kf_pose[live]), atol=CENTRE_TOL_BA)
    assert t_ms.check_binding_consistency(m) == []
    # the trajectory log, the database and the closer
    tj, tt = a["tracker"], ts.tracker
    assert tt.traj_ref_kf == tj["traj_ref_kf"] and tt.traj_lost == tj["traj_lost"]
    np.testing.assert_allclose(np.stack(tt.traj_rel), np.stack(tj["traj_rel"]), atol=TOL)
    assert tt.traj_time == tj["traj_time"]
    np.testing.assert_array_equal(old_entry.db.present, a["db_present"])
    np.testing.assert_allclose(old_entry.db.vectors.numpy(), a["db_vectors"], atol=1e-6)
    assert ts.loop_closer.last_loop_kf == a["last_loop_kf"]
    assert ts.loop_closer._consistent_groups == []
    (ka, kb, S, w), (ja, jb, jS, jw) = ts.loop_closer.extra_edges[-1], a["extra_edges"][-1]
    assert (ka, kb, w) == (ja, jb, jw) == (a["last_loop_kf"], b["kf_cand"], 10.0)
    np.testing.assert_array_equal(S, jS)
    assert [(k, len(ids)) for ids, k in ts.mapper.recent_lm] == \
        [(k, len(ids)) for ids, k in a["recent_lm"]]
    assert tt.ref_kf == tj["ref_kf"]
    np.testing.assert_array_equal(tt.last_lm_idx, tj["last_lm_idx"])
    # the mirror of keyframe features was dropped (ids moved) and fits the welded map
    assert not ts.mapper.dev_cache.have - set(live.tolist())
    assert ts.mapper.dev_cache.cap >= m.capacity_kf
    # the fused step re-syncs on the welded map: nothing of the old window is left
    fp.sync(m, tt.ref_kf, tt.last_feats, tt.last_lm_idx, tt.last_lm_gen)
    assert fp._sync_key[0] is m
    for k, old in zip(map_state, old_window):
        assert getattr(fp, k) is not old, k
    n = len(fp.win_ids)
    assert n > 0 and m.lm_valid[fp.win_ids].all()
    np.testing.assert_array_equal(fp.win_pos[:n].numpy(), m.lm_pos[fp.win_ids])
    bound = fp.prev_bound.numpy()
    np.testing.assert_array_equal(fp.prev_Xw.numpy()[bound], m.lm_pos[tt.last_lm_idx[bound]])


def test_do_merge_without_the_mapping_plane(drive):
    """With ``enable_mapping=False`` the closer keeps a feature mirror of its
    own: the weld drops it too, and no weld-window BA runs."""
    b = drive["rec"]["before"]
    ts = port_system_before_weld(drive)
    ts.mapper = None
    ts.loop_closer = LoopCloser(drive["tcfg"], ts.map, device="cpu", generator=ts._loop_rng)
    convert.loop_closer_state_from_numpy(ts.loop_closer, b["closer"])
    ts.atlas.entries[ts.atlas.active_idx].db = ts.tracker.kf_db = ts.loop_closer.db
    cache = ts.loop_closer.dev_cache
    cache.ensure(ts.map, ts.map.valid_kf_ids())
    assert cache.have
    ts._do_merge(t_merging.MergeEvent(kf_cur=b["kf_cur"], kf_matched=b["kf_cand"],
                                      entry_idx=b["ei"], n_inliers=0, S12=b["S12"],
                                      fusion=b["fusion"]))
    assert ts.atlas.n_maps() == 1 and ts.loop_closer.map is ts.map
    assert not cache.have and cache.cap >= ts.map.capacity_kf
    assert t_ms.check_binding_consistency(ts.map) == []


def test_do_merge_remaps_the_asynchronous_queues(drive):
    """The weld's asynchronous half on the JAX state before the weld: a solve
    in flight is aborted and discarded, queued mapping keyframes take their
    welded ids by JAX's rule (``_do_merge``: ``kf_remap[k]`` for every
    in-range keyframe that survives, the rest dropped, order kept), and the
    queued detections and events, the merge candidate and the shed
    keyframe, all carrying old ids, are dropped."""
    b, r = drive["rec"]["before"], drive["rec"]["rebind"]
    ts = port_system_before_weld(drive)
    ts.async_mapping = True
    kf_remap = r["kf_remap"]
    queue = [int(b["kf_cur"]), len(kf_remap) - 1, len(kf_remap) + 3, -1]
    expect = [int(kf_remap[k]) for k in queue
              if 0 <= k < len(kf_remap) and kf_remap[k] >= 0]     # JAX system.py:1003-1005
    assert expect and expect[0] >= 0
    ts._map_queue = collections.deque(queue)
    ts._loop_queue.extend([1, 2])
    ts._loop_inbox.append((ts.map, None))
    ts._merge_candidate, ts._last_shed_kf = (ts.map, 0), 0
    abort, running = threading.Event(), concurrent.futures.Future()
    running.set_result(None)
    ts._gba_abort, ts._gba_future = abort, running
    ts._do_merge(t_merging.MergeEvent(kf_cur=b["kf_cur"], kf_matched=b["kf_cand"],
                                      entry_idx=b["ei"], n_inliers=0, S12=b["S12"],
                                      fusion=b["fusion"]))
    np.testing.assert_array_equal(ts.tracker.ref_kf, drive["rec"]["after"]["tracker"]["ref_kf"])
    assert list(ts._map_queue) == expect
    assert abort.is_set() and ts._gba_future is None
    assert not ts._loop_queue and not ts._loop_inbox
    assert ts._merge_candidate is None and ts._last_shed_kf is None
    assert ts.atlas.n_maps() == 1 and t_ms.check_binding_consistency(ts.map) == []
