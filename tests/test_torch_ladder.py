"""Port vs JAX: the classic ladder's stages (TrackReferenceKeyFrame,
TrackWithMotionModel, TrackLocalMap) on identical state — the JAX
system's map, tracker scalars and features loaded into the port through
``convert``. Helpers and the one-thread fixture: test_torch_system.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from test_torch_system import _drive, _render, _systems, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def ladder_state():
    """A JAX system after 8 frames with a keyframe every 2, the JAX
    features of frame 8, and the port tracker loaded with the same map,
    tracker state and last-frame features."""
    traj = j_syn.straight_trajectory(9, step=0.6, weave=0.4)
    cfg, frames = _render(traj)
    js, ts = _systems(cfg)
    _drive(js, ts, frames[:8], force_kf_every=2)
    jt, tt = js.tracker, ts.tracker
    img, pts = frames[8]
    with jax.enable_x64(False):
        pts_p, mask = js._pad_cloud(pts)
        jf = jt._extract_rgbl(jnp.asarray(img), pts_p, mask)
    jf_np = {k: np.asarray(v) for k, v in jf._asdict().items()}
    tt.map = convert.map_state_from_numpy(jt.map)
    convert.tracker_state_from_numpy(tt, {k: getattr(jt, k) for k in convert.TRACKER_STATE})
    tt.last_feats = convert.frame_features_from_numpy(
        {k: np.asarray(v) for k, v in jt.last_feats._asdict().items()}, device="cpu")
    tf = convert.frame_features_from_numpy(jf_np, device="cpu")
    return jt, tt, jf, tf


def _stage(jt, tt, name, *args):
    """Run one ladder stage on both trackers from the same pose and
    reference keyframe; returns ((bindings, n, pose) JAX, the same port)."""
    out = []
    pose0, ref0 = jt.cur_pose.copy(), jt.ref_kf
    with jax.enable_x64(False):
        for tr, a in ((jt, args[0]), (tt, args[1])):
            tr.cur_pose, tr.ref_kf = pose0.copy(), ref0
            lm_idx, n = getattr(tr, name)(a, *args[2:])
            out.append((np.asarray(lm_idx), int(n), tr.cur_pose.copy(), tr.ref_kf))
    return out


def test_ladder_stages_match_jax_on_identical_state(ladder_state):
    """Same map, tracker state and features on both sides: each stage
    binds the same landmarks and solves the same pose. The projections are
    computed in numpy on one side and XLA on the other, so a landmark on a
    window edge may flip: ≥ 99.8% of feature slots (identical on this
    state), inlier counts within 1%, and poses within 0.1 mm and 1e-4 on
    the quaternion (1e-6 m on this state)."""
    jt, tt, jf, tf = ladder_state
    assert tt.map.n_kf == jt.map.n_kf >= 4
    np.testing.assert_array_equal(tt.map.kf_lm_idx, jt.map.kf_lm_idx)
    results = {}
    for name, extra in (("_track_reference_keyframe", ()), ("_track_with_motion_model", (15.0,))):
        results[name] = _stage(jt, tt, name, jf, tf, *extra)
    mm_lm = results["_track_with_motion_model"][0][0]
    results["_track_local_map"] = _stage(jt, tt, "_track_local_map", jf, tf, mm_lm)
    for name, ((lm_j, n_j, pose_j, ref_j), (lm_t, n_t, pose_t, ref_t)) in results.items():
        assert n_j >= 30, (name, n_j)
        assert np.mean(lm_j == lm_t) >= 0.998, (name, np.mean(lm_j == lm_t))
        assert abs(n_t - n_j) <= 0.01 * n_j, (name, n_j, n_t)
        assert ref_t == ref_j, name
        assert np.abs(t_lie.np_se3_centers(pose_t) - t_lie.np_se3_centers(pose_j)).max() < 1e-4
        np.testing.assert_allclose(pose_t[:4], pose_j[:4], atol=1e-4)
