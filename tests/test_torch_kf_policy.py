"""Port vs JAX: the keyframe decision (``NeedNewKeyFrame``) at the size of
a KITTI frame, which the drives of the other tests (320×192, 600 features)
do not reach.

One numpy map of 6 keyframes with 2000 feature slots each and ~830
landmarks, whose observer counts run from 1 to 6, is copied into the port
through ``convert.map_state_from_numpy``. On it, with the same tracker
state on both sides:

* ``_ref_kf_tracked`` (the reference keyframe's landmarks with enough
  observers) is equal for every reference keyframe, at both observer
  thresholds and after landmarks were removed;
* ``_fast_kf_policy`` (the fused frames' decision) is equal over a grid
  of inlier counts around both ratio thresholds, close-point counts
  around the starvation trigger, frame gaps and map sizes;
* ``_maybe_insert_keyframe`` (the classic ladder's decision, which counts
  the close points itself from 2000 features' depths and bindings) asks
  for a keyframe on the same frames.

Tolerance 0: the decision is integer and boolean arithmetic on the host.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu.slam import map_state as j_ms
from orb_slam3_rgbl_tpu.slam.frame import FrameFeatures as JFeatures
from orb_slam3_rgbl_tpu.slam.tracking import Tracker as JTracker
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.slam.frame import FrameFeatures as TFeatures
from orb_slam3_rgbl_tpu_torch.slam.tracking import Tracker as TTracker

K, N, M = 6, 2000, 830


def _map(seed=0):
    """Keyframe k binds the landmarks [60·k, 60·k + 830 − 100·k) at random
    feature slots: landmark observer counts run from 1 to 6, and about 800
    landmarks are alive."""
    rng = np.random.default_rng(seed)
    m = j_ms.MapState.create(K + 2, 2048, N, map_id=0)
    pose = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    for k in range(K):
        kf = m.add_keyframe(pose, np.zeros((N, 2), np.float32), np.zeros(N, np.int16),
                            np.zeros((N, 8), np.uint32), np.full(N, -1.0, np.float32),
                            np.full(N, -1.0, np.float32), np.ones(N, bool),
                            np.full(N, -1, np.int32), 0.1 * k, k,
                            angle=np.zeros(N, np.float32))
        ids = np.arange(60 * k, 60 * k + M - 100 * k)
        m.kf_lm_idx[kf, rng.permutation(N)[: ids.size]] = ids
    m.lm_valid[:M + 300] = True
    m.n_lm = M + 300
    return m


@pytest.fixture(scope="module")
def trackers():
    jcfg = dataclasses.replace(j_syn.synthetic_rgbl_config(), loop_closing=False)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jm = _map()
    jt = JTracker(jcfg, jm)
    tt = TTracker(tcfg, convert.map_state_from_numpy(jm), device="cpu")
    assert int(jm.lm_valid.sum()) > 800 and jm.n_features == 2000
    return jt, tt


def _set(trackers, **state):
    for t in trackers:
        for name, value in state.items():
            setattr(t, name, value)


@pytest.mark.parametrize("ref_kf", range(K))
def test_ref_kf_tracked_matches_jax(trackers, ref_kf):
    jt, tt = trackers
    _set(trackers, ref_kf=ref_kf)
    got, want = tt._ref_kf_tracked(), jt._ref_kf_tracked()
    assert got == want and 0 < got <= M - 100 * ref_kf
    # ≥ 2 observers while the map has at most two keyframes
    n_kf = jt.map.n_kf
    for m in (jt.map, tt.map):
        m.n_kf = 2
        m.version += 1
    try:
        young = tt._ref_kf_tracked()
        assert young == jt._ref_kf_tracked() and young >= got
    finally:
        for m in (jt.map, tt.map):
            m.n_kf = n_kf
            m.version += 1


def test_ref_kf_tracked_follows_the_map(trackers):
    """The cached count is dropped when the map's version moves."""
    jt, tt = trackers
    _set(trackers, ref_kf=1)
    before = tt._ref_kf_tracked()
    for t in trackers:
        t.map.kf_lm_idx[2, :] = -1        # one observer gone
        t.map.version += 1
    try:
        after = tt._ref_kf_tracked()
        assert after == jt._ref_kf_tracked() and 0 < after < before
    finally:
        fresh = _map()
        for t in trackers:
            t.map.kf_lm_idx[:] = fresh.kf_lm_idx
            t.map.version += 1


@pytest.mark.parametrize("n_kf, gap, reloc_gap", [(1, 1, 9999), (2, 3, 9999), (6, 1, 9999),
                                                  (6, 12, 9999), (12, 5, 3), (12, 5, 10)])
def test_fast_kf_policy_matches_jax(trackers, n_kf, gap, reloc_gap):
    """The fused frames' decision around every threshold: inliers near
    0.25, 0.4 and 0.75 of the tracked count and near 15, close points near
    100 tracked and 70 untracked."""
    jt, tt = trackers
    real_n_kf = jt.map.n_kf
    for t in trackers:
        t.map.n_kf = n_kf
        t.map.version += 1
    _set(trackers, ref_kf=0, frame_id=100, last_kf_frame=100 - gap,
         last_reloc_frame=100 - reloc_gap, force_kf_every=0)
    try:
        ref = tt._ref_kf_tracked()
        assert ref == jt._ref_kf_tracked() and ref > 100
        inliers = sorted({15, 16, ref, 2 * ref} | {int(ref * f) + d for f in (0.25, 0.4, 0.75)
                                                  for d in (-1, 0, 1)})
        n_yes = 0
        for n_inl, tc, ntc in itertools.product(inliers, (99, 100, 450), (70, 71, 600)):
            got = tt._fast_kf_policy(n_inl, tc, ntc)
            assert got == jt._fast_kf_policy(n_inl, tc, ntc), (n_inl, tc, ntc)
            n_yes += got
        # right after a relocalization in an established map: never
        assert (n_yes == 0) == (n_kf > tt.max_frames and reloc_gap < tt.max_frames)
        for every in (4, 6):
            _set(trackers, force_kf_every=every)
            assert tt._fast_kf_policy(2 * ref, 450, 0) == jt._fast_kf_policy(2 * ref, 450, 0)
    finally:
        for t in trackers:
            t.map.n_kf = real_n_kf
            t.map.version += 1
        _set(trackers, force_kf_every=0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_classic_keyframe_decision_matches_jax(trackers, seed):
    """``_maybe_insert_keyframe`` on 2000 features: the close points are
    counted on the host from depths and bindings; keyframe creation is
    replaced by a recorder on both sides."""
    jt, tt = trackers
    rng = np.random.default_rng(seed)
    made = {"jax": 0, "port": 0}
    jt._create_keyframe = lambda feats, ts: made.__setitem__("jax", made["jax"] + 1)
    tt._create_keyframe = lambda feats, ts: made.__setitem__("port", made["port"] + 1)
    _set(trackers, ref_kf=0, frame_id=50, last_kf_frame=47, last_reloc_frame=-9999,
         force_kf_every=0)
    ref = tt._ref_kf_tracked()
    try:
        for n_close, n_bound in ((60, 30), (150, 20), (400, 250), (900, 890), (1200, 300)):
            depth = np.full(N, -1.0, np.float32)
            depth[rng.permutation(N)[:n_close]] = rng.uniform(
                0.5, 0.99 * tt.th_depth_m, n_close).astype(np.float32)
            depth[rng.permutation(N)[:200]] = np.float32(2.0 * tt.th_depth_m)   # far points
            lm_idx = np.full(N, -1, np.int32)
            close = np.nonzero((depth > 0) & (depth < tt.th_depth_m))[0]
            lm_idx[rng.permutation(close)[:n_bound]] = 7
            base = dict(uv=np.zeros((N, 2), np.float32), response=np.zeros(N, np.float32),
                        octave=np.zeros(N, np.int32), angle=np.zeros(N, np.float32),
                        valid=rng.uniform(size=N) < 0.97, depth=depth,
                        u_right=np.full(N, -1.0, np.float32))
            jf = JFeatures(desc=np.zeros((N, 8), np.uint32), **base)
            tf = TFeatures(desc=torch.zeros((N, 8), dtype=torch.int32),
                           **{k: torch.as_tensor(v) for k, v in base.items()})
            _set(trackers, cur_lm_idx=lm_idx)
            for n_inl in (20, int(0.75 * ref) - 1, int(0.75 * ref) + 1, 2 * ref):
                want = jt._maybe_insert_keyframe(jf, 5.0, n_inl)
                got = tt._maybe_insert_keyframe(tf, 5.0, n_inl)
                assert got == want, (n_close, n_bound, n_inl)
                assert made["jax"] == made["port"]
        assert made["port"] >= 6
    finally:
        del jt._create_keyframe, tt._create_keyframe
