"""Port vs JAX: the monocular sensor — ``geometry/two_view.py``,
``optim/pnp.dlt_pnp_ransac`` and ``Tracker._monocular_initialization``.
The monocular drives of both Systems are in test_torch_mono_drive.py.

The solvers are fed JAX's own draws: ``jax.random.randint`` of the same key
and shape on the real (unpadded) rows, which is what the JAX function draws
internally for those inputs. The port's tracker draws two-view minimal sets
over the real match count; to hold ``_monocular_initialization`` to JAX on
the same draws, the JAX tracker's reconstruction is run on its real matches
too (its padded rows are never drawn).

Tolerances:
* ``reconstruct_two_views``: ``success``, ``used_homography`` and
  ``is_good`` exact; T21 1e-3 (quaternion and unit-norm translation: an
  eigenvector of AᵀA in f32, observed 2.6e-4); triangulated points 5e-3
  relative to their distance (the far points of a unit baseline, observed
  1.4e-3);
* ``dlt_pnp_ransac``: the same inlier count and mask, the pose 1e-4;
* ``_monocular_initialization``: the same keyframes and frame ids, KF1's
  pose 1e-4, landmark counts within 1% and bound features within 2% (a
  far point at the 0.99998 parallax gate falls on either side: T21 differs
  by 2e-5, and one of 457 points flipped), the landmarks of the features
  bound on both sides 5e-3 relative; KF0's landmark depths have median 1
  on both sides (the unit-median-depth gauge);

JAX runs with x64 off, as outside the test suite."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu.config import MONOCULAR, kitti_rgbl_config
from orb_slam3_rgbl_tpu.geometry import lie as j_lie
from orb_slam3_rgbl_tpu.geometry import two_view as j_tv
from orb_slam3_rgbl_tpu.optim import pnp as j_pnp
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import two_view as t_tv
from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera
from orb_slam3_rgbl_tpu_torch.optim import pnp as t_pnp
from orb_slam3_rgbl_tpu_torch.slam import tracking as t_trk
from orb_slam3_rgbl_tpu_torch.slam.system import System as TSystem

from synthetic_world import SyntheticWorld
from test_two_view import CAM as J_CAM, synth_pair
from test_torch_system import one_torch_thread  # noqa: F401  (module fixture)

T_CAM = PinholeCamera(**dataclasses.asdict(J_CAM))


def _t(a):
    return torch.from_numpy(np.array(a))


def _two_view_draws(key, P, n_hypotheses=256):
    kF, kH = jax.random.split(key)
    return (np.asarray(jax.random.randint(kF, (n_hypotheses, 8), 0, P)),
            np.asarray(jax.random.randint(kH, (n_hypotheses, 4), 0, P)))


@pytest.mark.parametrize("seed, scene, key, succeeds", [
    (0, {}, 0, True),                                          # test_recovers_motion
    (1, dict(noise=0.1), 1, True),                             # test_triangulated_structure
    (2, dict(outlier_frac=0.2), 2, True),                      # test_robust_to_outliers
    (3, dict(baseline=0.0, yaw=0.03, noise=0.2), 3, False),    # test_rejects_pure_rotation
])
def test_reconstruct_two_views_on_jax_draws(seed, scene, key, succeeds):
    rng = np.random.default_rng(seed)
    with jax.enable_x64(False):
        uv1, uv2, ok, T21_true, _ = synth_pair(rng, **scene)
        res_j = j_tv.reconstruct_two_views(uv1, uv2, ok, J_CAM, jax.random.PRNGKey(key))
        draws = _two_view_draws(jax.random.PRNGKey(key), uv1.shape[0])
    res_t = t_tv.reconstruct_two_views(_t(uv1), _t(uv2), _t(ok), T_CAM,
                                       draws=tuple(_t(d) for d in draws))
    assert bool(res_t.success) == bool(res_j.success) == succeeds
    assert bool(res_t.used_homography) == bool(res_j.used_homography)
    good = np.asarray(res_j.is_good)
    np.testing.assert_array_equal(res_t.is_good.numpy(), good)
    if not succeeds:
        return
    T_j, T_t = np.asarray(res_j.T21), res_t.T21.numpy()
    np.testing.assert_allclose(T_t, T_j, atol=1e-3)
    t_true = T21_true[4:] / np.linalg.norm(T21_true[4:])
    assert np.dot(T_t[4:], t_true) > 0.999
    X_j, X_t = np.asarray(res_j.points)[good], res_t.points.numpy()[good]
    rel = np.linalg.norm(X_t - X_j, axis=1) / np.linalg.norm(X_j, axis=1)
    assert rel.max() < 5e-3, rel.max()


def test_two_view_draws_come_from_the_generator():
    rng = np.random.default_rng(0)
    with jax.enable_x64(False):
        uv1, uv2, ok, _, _ = synth_pair(rng)
    args = (_t(uv1), _t(uv2), _t(ok), T_CAM)
    with pytest.raises(ValueError, match="Generator"):
        t_tv.reconstruct_two_views(*args)
    a = t_tv.reconstruct_two_views(*args, generator=torch.Generator().manual_seed(5))
    b = t_tv.reconstruct_two_views(*args, draws=t_tv.two_view_draws(
        uv1.shape[0], torch.Generator().manual_seed(5)))
    assert bool(a.success) and torch.equal(a.T21, b.T21)


def _pnp_scene(seed, P=160, outlier_frac=0.25):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-12, 12, P), rng.uniform(-4, 4, P), rng.uniform(8, 45, P)],
                 axis=1).astype(np.float32)
    with jax.enable_x64(False):
        Tcw = np.asarray(j_lie.se3_exp(jnp.asarray([0.3, -0.4, 0.8, 0.03, -0.05, 0.02],
                                                   jnp.float32)))
        pc = np.asarray(j_lie.se3_apply(jnp.asarray(Tcw), jnp.asarray(X)))
    uv = np.stack([J_CAM.fx * pc[:, 0] / pc[:, 2] + J_CAM.cx,
                   J_CAM.fy * pc[:, 1] / pc[:, 2] + J_CAM.cy], axis=1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    out = rng.choice(P, int(P * outlier_frac), replace=False)
    uv[out] += rng.uniform(20, 60, (len(out), 2)).astype(np.float32)
    s2 = (1.2 ** (2 * rng.integers(0, 4, P))).astype(np.float32)
    return Tcw, X, uv, s2, np.ones(P, bool)


def test_dlt_pnp_ransac_on_jax_draws():
    Tcw, X, uv, s2, valid = _pnp_scene(11)
    key = jax.random.PRNGKey(21)
    with jax.enable_x64(False):
        res_j = j_pnp.dlt_pnp_ransac(*(jnp.asarray(a) for a in (X, uv, s2, valid)), J_CAM, key)
        draws = np.asarray(jax.random.randint(key, (512, 6), 0, X.shape[0]))
    res_t = t_pnp.dlt_pnp_ransac(*(_t(a) for a in (X, uv, s2, valid)), T_CAM, draws=_t(draws))
    assert int(res_t.n_inliers) == int(res_j.n_inliers) >= 100
    np.testing.assert_array_equal(res_t.inliers.numpy(), np.asarray(res_j.inliers))
    T_t, T_j = res_t.Tcw.numpy(), np.asarray(res_j.Tcw)
    np.testing.assert_allclose(T_t[4:], T_j[4:], atol=1e-4 * max(1.0, np.abs(T_j[4:]).max()))
    assert min(np.abs(T_t[:4] - T_j[:4]).max(), np.abs(T_t[:4] + T_j[:4]).max()) < 1e-4
    assert np.abs(T_t[4:] - Tcw[4:]).max() < 0.5
    # the generator path draws (512, 6) minimal sets itself, repeatably
    a, b = (t_pnp.dlt_pnp_ransac(*(_t(x) for x in (X, uv, s2, valid)), T_CAM,
                                 generator=torch.Generator().manual_seed(1)) for _ in range(2))
    assert torch.equal(a.inliers, b.inliers) and int(a.n_inliers) >= 10
    with pytest.raises(ValueError, match="Generator"):
        t_pnp.dlt_pnp_ransac(*(_t(x) for x in (X, uv, s2, valid)), T_CAM)


def _mono_frames(n_frames, seed=0):
    cfg = kitti_rgbl_config(sensor=MONOCULAR)
    rng = np.random.default_rng(seed)
    with jax.enable_x64(False):
        world = SyntheticWorld(rng, cam=cfg.camera, length=n_frames * 0.8)
        gt = world.trajectory(n_frames, step=0.8)
        feats = [world.render(gt[i], n_feat=600, depth_frac=0.0) for i in range(n_frames)]
    return cfg, feats, gt


def _to_port(f):
    return convert.frame_features_from_numpy({k: np.asarray(v) for k, v in f._asdict().items()},
                                             device="cpu")


def same_two_view_draws(monkeypatch):
    """Both trackers' two-view reconstructions on JAX's draws: the JAX
    tracker's reconstruction runs on its real matches (unpadded) and its
    draws go to the port's tracker."""
    rec = {}
    orig = j_tv.reconstruct_two_views

    def on_real_matches(uv1, uv2, vm, cam, key, n_hypotheses=256):
        m = int(np.asarray(vm).sum())
        assert np.asarray(vm)[:m].all()
        rec["draws"] = _two_view_draws(key, m, n_hypotheses)
        res = orig(uv1[:m], uv2[:m], vm[:m], cam, key, n_hypotheses)
        P = uv1.shape[0]
        return res._replace(points=jnp.zeros((P, 3), jnp.float32).at[:m].set(res.points),
                            is_good=jnp.zeros(P, bool).at[:m].set(res.is_good))

    monkeypatch.setattr(j_tv, "reconstruct_two_views", on_real_matches)
    monkeypatch.setattr(t_trk.Tracker, "_two_view_draws",
                        lambda self, n: tuple(_t(d) for d in rec["draws"]))


def test_monocular_initialization_on_jax_draws(monkeypatch):
    """One reference frame and one frame four steps on: both trackers build
    KF0 + KF1 from the same matches and the same two-view draws."""
    cfg, feats, _ = _mono_frames(5)
    cfg = dataclasses.replace(cfg, loop_closing=False)
    same_two_view_draws(monkeypatch)
    js = JSystem(cfg, enable_mapping=False)
    ts = TSystem(convert.config_from_dict(dataclasses.asdict(cfg)), enable_mapping=False,
                 device="cpu")
    with jax.enable_x64(False):
        for i in (0, 4):
            rj = js.track_features(feats[i], i * 0.1)
            rt = ts.track_features(_to_port(feats[i]), i * 0.1)
    assert rj.state == rt.state == t_trk.OK and rj.created_kf and rt.created_kf
    jm, tm = js.map, ts.map
    assert jm.n_kf == tm.n_kf == 2 and ts.tracker.new_kf_ids == js.tracker.new_kf_ids == [0, 1]
    np.testing.assert_array_equal(tm.kf_frame_id[:2], jm.kf_frame_id[:2])
    np.testing.assert_allclose(tm.kf_pose[:2], jm.kf_pose[:2], atol=1e-4)
    # the same features bound, but for points at a gate's edge (f32)
    bj, bt = jm.kf_lm_idx[:2] >= 0, tm.kf_lm_idx[:2] >= 0
    assert jm.n_lm >= 100 and abs(tm.n_lm - jm.n_lm) <= 0.01 * jm.n_lm
    assert (bj != bt).sum() <= 0.02 * bj.sum(), ((bj != bt).sum(), bj.sum())
    both = np.nonzero(bj[0] & bt[0])[0]
    Xj, Xt = jm.lm_pos[jm.kf_lm_idx[0, both]], tm.lm_pos[tm.kf_lm_idx[0, both]]
    rel = np.linalg.norm(Xt - Xj, axis=1) / np.linalg.norm(Xj, axis=1)
    assert rel.max() < 5e-3, rel.max()
    for m in (tm, jm):
        lm0 = m.kf_lm_idx[0][m.kf_lm_idx[0] >= 0]
        assert np.median(m.lm_pos[lm0, 2]) == pytest.approx(1.0, abs=1e-5)
    assert (tm.kf_ur[:2][tm.kf_valid[:2]] < 0).all()     # no depth anywhere
