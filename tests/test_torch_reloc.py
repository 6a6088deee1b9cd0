"""Port vs JAX: relocalization against the keyframe database.

Both ``System``s (default configuration) take 30 frames of the circular
feature drive, then 6 frames without a feature (fewer than ``fps``, so no new
atlas map), then the features of frames 20–25 again, a place the map holds.
After every frame the same state on both: ``OK``, ``RECENTLY_LOST`` on the
first blank frame, ``LOST`` on the others, and ``OK`` from the first frame
with features on, recovered by ``Tracker._relocalization`` against the same
candidate keyframe, in the one atlas map. On the recovery frame
``_relocalization`` is also called directly, on the JAX tracker (its state
put back afterwards) and on a port tracker that stands on a copy of the JAX
map, tracker state and database, its PnP RANSAC fed the integers JAX's key
chain draws: the same reference keyframe, the same inlier count within 2, bindings
equal on ≥ 99% of the features that either binds, pose within 1e-3 m / 1e-4
(observed: equal counts and bindings, 3e-5 m). Left to their own streams the
two RANSACs pick different winners from hypotheses made of three points with
2% depth noise (277 against 222 inliers on this frame), and the frame still
recovers on both.

JAX runs with x64 off, as outside the test suite."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu.slam.loop_closing import _pair_tier
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from orb_slam3_rgbl_tpu_torch.retrieval.keyframe_db import KeyFrameDatabase
from orb_slam3_rgbl_tpu_torch.slam import tracking as t_trk
from orb_slam3_rgbl_tpu_torch.slam.system import System as TSystem

from test_torch_loop_closing import feats_to_port, loop_drive_features

N_LEAD, N_BLANK, BACK_TO = 30, 6, 20


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def drive():
    cfg, feats, gt = loop_drive_features(N_LEAD)
    blank = feats[0]._replace(valid=jnp.zeros(600, bool), depth=jnp.full(600, -1.0, jnp.float32),
                              u_right=jnp.full(600, -1.0, jnp.float32))
    seq = feats + [blank] * N_BLANK + feats[BACK_TO:BACK_TO + 6]
    where = list(range(N_LEAD)) + [None] * N_BLANK + list(range(BACK_TO, BACK_TO + 6))
    assert N_BLANK < cfg.fps
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    js, ts = JSystem(cfg), TSystem(tcfg, device="cpu")
    log, direct = [], None
    with jax.enable_x64(False):
        for i, f in enumerate(seq):
            tf = feats_to_port(f)
            if i == N_LEAD + N_BLANK:
                direct = _relocalize_directly(js, tcfg, f, tf)
            rj, rt = js.track_features(f, i * 0.1), ts.track_features(tf, i * 0.1)
            log.append((rj, rt, js.tracker.last_reloc_frame, ts.tracker.last_reloc_frame,
                        js.tracker.ref_kf, ts.tracker.ref_kf))
    return js, ts, log, direct, gt, where


def _relocalize_directly(js, tcfg, f, tf):
    """``_relocalization`` as the coming frame will call it: on the JAX
    tracker (with what it changes put back afterwards) and on a port tracker
    standing on a copy of the JAX map, tracker state and database."""
    jt = js.tracker
    keep_j = (jt.cur_pose, jt.last_reloc_frame, jt.ref_kf, jt._reloc_key)
    tt = t_trk.Tracker(tcfg, convert.map_state_from_numpy(js.map), device="cpu")
    convert.tracker_state_from_numpy(tt, {k: getattr(jt, k) for k in convert.TRACKER_STATE})
    tt.n_feat = jt.n_feat
    tt.kf_db = KeyFrameDatabase(js.map.capacity_kf, device="cpu")
    tt.kf_db.vectors.copy_(torch.from_numpy(js.loop_closer.db.vectors))
    tt.kf_db.present = js.loop_closer.db.present.copy()
    # the port draws what JAX will draw: the same chain of key splits, over
    # JAX's padded pair count (a draw is folded onto the real pairs by both)
    chain = [jt._reloc_key]

    def jax_draws(n_pairs):
        chain[0], sub = jax.random.split(chain[0])
        return torch.from_numpy(np.asarray(jax.random.randint(
            sub, (t_trk.RELOC_HYPOTHESES, 3), 0, _pair_tier(n_pairs))))

    tt._reloc_draws = jax_draws
    out_j = jt._relocalization(f)
    out_t = tt._relocalization(tf)
    res = (out_j, jt.cur_pose.copy(), jt.ref_kf, jt.last_reloc_frame,
           out_t, tt.cur_pose.copy(), tt.ref_kf, tt.last_reloc_frame)
    jt.cur_pose, jt.last_reloc_frame, jt.ref_kf, jt._reloc_key = keep_j
    return res


def test_states_through_loss_and_recovery_match_jax(drive):
    js, ts, log, _, gt, where = drive
    first_back = N_LEAD + N_BLANK
    want = ([t_trk.OK] * N_LEAD + [t_trk.RECENTLY_LOST] + [t_trk.LOST] * (N_BLANK - 1)
            + [t_trk.OK] * 6)
    assert [r[0].state for r in log] == [r[1].state for r in log] == want
    for i, (rj, rt, reloc_j, reloc_t, ref_j, ref_t) in enumerate(log):
        assert reloc_t == reloc_j == (-9999 if i < first_back else first_back), i
        assert ref_t == ref_j, i
        assert rt.created_kf == rj.created_kf, i
        if where[i] is not None:
            c_t, c_j = t_lie.np_se3_centers(rt.pose[None]), t_lie.np_se3_centers(rj.pose[None])
            assert np.abs(c_t - c_j).max() < 0.02, (i, np.abs(c_t - c_j).max())
            # and the recovered pose is the place's, not just JAX's
            c_gt = t_lie.np_se3_centers(gt[where[i]][None])
            assert np.abs(c_t - c_gt).max() < 0.15, (i, np.abs(c_t - c_gt).max())
    assert ts.atlas.n_maps() == js.atlas.n_maps() == 1
    assert log[first_back][1].n_inliers >= 30
    assert ts.tracker.kf_db is ts.loop_closer.db


def test_relocalization_called_directly_matches_jax(drive):
    _, ts, _, direct, _, _ = drive
    (lm_j, n_j), pose_j, ref_j, at_j, (lm_t, n_t), pose_t, ref_t, at_t = direct
    assert at_t == at_j == N_LEAD + N_BLANK - 1     # the frame counter moves when the frame is tracked
    assert ref_t == ref_j and n_t >= 30 and abs(n_t - n_j) <= 2, (n_j, n_t)
    assert lm_t.dtype == np.int32 and lm_t.shape == (600,)
    either = (lm_j >= 0) | (lm_t >= 0)
    assert (lm_t[either] == lm_j[either]).mean() >= 0.99, (lm_t[either] == lm_j[either]).mean()
    assert np.abs(t_lie.np_se3_centers(pose_t[None]) - t_lie.np_se3_centers(pose_j[None])).max() < 1e-3
    sign = np.sign(np.dot(pose_t[:4], pose_j[:4]))
    np.testing.assert_allclose(pose_t[:4] * sign, pose_j[:4], atol=1e-4)


def test_relocalization_without_database_or_generator(drive):
    _, ts, _, _, _, _ = drive
    _, feats, _ = loop_drive_features(1)
    tf = feats_to_port(feats[0])
    t = ts.tracker
    db, gen = t.kf_db, t.reloc_generator
    try:
        t.kf_db = None                      # no loop-closing plane: fails at once
        lm, n = t._relocalization(tf)
        assert n == 0 and (lm == -1).all()
        t.kf_db, t.reloc_generator = db, None
        with pytest.raises(ValueError, match="Generator"):
            t._relocalization(tf)
    finally:
        t.kf_db, t.reloc_generator = db, gen
    blank = tf._replace(valid=torch.zeros(600, dtype=torch.bool))
    assert t._relocalization(blank)[1] == 0
