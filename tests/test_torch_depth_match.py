"""Port vs JAX: SE3 algebra, LiDAR depth, descriptor matching and the
fused step's collision resolution. Integer outputs are held exactly.

The paper's three densification methods: InverseDilation and the chamfer
distance transform are min/max and one f32 add a tap, so they are held
exactly; AverageFiltering divides two 25-tap window sums whose order of
addition is each library's own, so it is held to 1e-6 relative (observed
equal); NearestNeighborPixel gathers window maxima, exact. One fused step per
method runs through both packages on identical ``FastPath`` state: the
per-slot depths of slots whose keypoint is the same on both sides are
held as above, the pose to 1e-3 as in test_torch_step.py."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu import config as j_config
from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu.geometry import lie as j_lie
from orb_slam3_rgbl_tpu.ops import depth as j_depth
from orb_slam3_rgbl_tpu.ops import matching as j_match
from orb_slam3_rgbl_tpu.ops import fast as j_fast
from orb_slam3_rgbl_tpu.slam import compiled as j_compiled
from orb_slam3_rgbl_tpu.slam.fast_path import FastPath as JFastPath
from orb_slam3_rgbl_tpu.slam.map_state import MapState as JMapState
from orb_slam3_rgbl_tpu.slam.tracking import Tracker as JTracker
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from orb_slam3_rgbl_tpu_torch.ops import depth as t_depth
from orb_slam3_rgbl_tpu_torch.ops import matching as t_match
from orb_slam3_rgbl_tpu_torch.slam import compiled as t_compiled
from orb_slam3_rgbl_tpu_torch.slam.fast_path import FastPath as TFastPath

from test_depth import H as D_H, W as D_W, sparse_map


def _t(a):
    return torch.from_numpy(np.array(a))


def _poses(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([q, rng.normal(size=(n, 3))], 1).astype(np.float32)


def test_se3_ops_match(rng):
    A, B = _poses(rng, 16), _poses(rng, 16)
    X = rng.normal(size=(16, 3)).astype(np.float32)
    tau = (0.3 * rng.normal(size=(16, 6))).astype(np.float32)
    pairs = [
        (t_lie.se3_mul(_t(A), _t(B)), j_lie.se3_mul(jnp.asarray(A), jnp.asarray(B))),
        (t_lie.se3_inv(_t(A)), j_lie.se3_inv(jnp.asarray(A))),
        (t_lie.se3_apply(_t(A), _t(X)), j_lie.se3_apply(jnp.asarray(A), jnp.asarray(X))),
        (t_lie.se3_exp(_t(tau)), j_lie.se3_exp(jnp.asarray(tau))),
        (t_lie.quat_to_matrix(_t(A[:, :4])), j_lie.quat_to_matrix(jnp.asarray(A[:, :4]))),
        (t_lie.so3_hat(_t(X)), j_lie.so3_hat(jnp.asarray(X))),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)   # f32 rounding
    np.testing.assert_allclose(t_lie.np_se3_mul(A, B), j_lie.np_se3_mul(A, B), atol=1e-6)
    np.testing.assert_allclose(t_lie.np_se3_inv(A), j_lie.np_se3_inv(A), atol=1e-6)


def test_config_round_trip():
    for cfg in (j_config.kitti_rgbl_config(), j_syn.synthetic_rgbl_config()):
        port = convert.config_from_dict(dataclasses.asdict(cfg))
        assert dataclasses.asdict(port) == dataclasses.asdict(cfg)


def _cloud(rng, n=20000):
    return np.stack([rng.uniform(2.0, 60.0, n), rng.uniform(-15.0, 15.0, n),
                     rng.uniform(-2.0, 2.0, n), np.ones(n)], 1).astype(np.float32)


def test_projection_and_inverse_dilation_exact(rng):
    cfg = j_syn.synthetic_rgbl_config()
    cam = cfg.camera
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float32)
    P = t_depth.lidar_projection_matrix(K, np.asarray(cfg.lidar.T_velo_cam))
    np.testing.assert_array_equal(P, j_depth.lidar_projection_matrix(K, np.asarray(cfg.lidar.T_velo_cam)))
    pts = _cloud(rng)
    mask = rng.uniform(size=len(pts)) < 0.9
    H, W = cam.height, cam.width
    raw_j = np.asarray(j_depth.project_pointcloud(jnp.asarray(pts), jnp.asarray(P), H, W,
                                                  1.5, 150.0, jnp.asarray(mask)))
    raw_t = t_depth.project_pointcloud(_t(pts), _t(P), H, W, 1.5, 150.0, _t(mask))
    assert (raw_j > 0).sum() > 1000
    np.testing.assert_array_equal(raw_t.numpy(), raw_j)
    for kind, ku, kv in (("Diamond", 5, 7), ("Rectangle", 3, 5), ("Cross", 5, 3)):
        np.testing.assert_array_equal(
            t_depth.upsample_inverse_dilation(raw_t, 150.0, kind, ku, kv).numpy(),
            np.asarray(j_depth.upsample_inverse_dilation(jnp.asarray(raw_j), 150.0, kind, ku, kv)))
    dense = t_depth.upsample_inverse_dilation(raw_t, 150.0)
    uv = np.stack([rng.uniform(0, W, 500), rng.uniform(0, H, 500)], 1).astype(np.float32)
    d_t, ur_t = t_depth.feature_depth(dense, _t(uv), _t(uv), cam.bf)
    d_j, ur_j = j_depth.feature_depth(jnp.asarray(dense.numpy()), jnp.asarray(uv),
                                      jnp.asarray(uv), cam.bf)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_allclose(ur_t.numpy(), np.asarray(ur_j), rtol=1e-6)   # one f32 divide
    # the other two methods through the master function, at their defaults
    for method in ("AverageFiltering", "NearestNeighborPixel"):
        d_t, ur_t, dense_t = t_depth.compute_depth_from_pointcloud(
            _t(pts), _t(P), _t(uv), _t(uv), height=H, width=W, bf=cam.bf, method=method,
            min_dist=1.5, max_dist=150.0)
        with jax.enable_x64(False):
            d_j, ur_j, dense_j = j_depth.compute_depth_from_pointcloud(
                jnp.asarray(pts), jnp.asarray(P), jnp.asarray(uv), jnp.asarray(uv), height=H,
                width=W, bf=cam.bf, method=method, min_dist=1.5, max_dist=150.0)
        assert (np.asarray(d_j) > 0).sum() > 100, method
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6, err_msg=method)
        # u − bf/d: XLA fuses the divide and the subtraction (≤ 2 ulp of u)
        np.testing.assert_allclose(ur_t.numpy(), np.asarray(ur_j), atol=1e-4, err_msg=method)
        np.testing.assert_allclose(dense_t.numpy(), np.asarray(dense_j), rtol=1e-6,
                                   err_msg=method)
    # NearestNeighborPixel densifies nothing: its map is the raw projection
    np.testing.assert_array_equal(dense_t.numpy(),
                                  t_depth.project_pointcloud(_t(pts), _t(P), H, W, 1.5, 150.0).numpy())
    with pytest.raises(ValueError, match="unknown upsampling"):
        t_depth.compute_depth_from_pointcloud(_t(pts), _t(P), _t(uv), _t(uv), height=H,
                                              width=W, bf=cam.bf, method="Bilateral")


@pytest.mark.parametrize("density", [0.02, 0.002])
def test_chamfer_distance_exact(density):
    """On tests/test_depth.py's sparse maps, at the default radius and a small one."""
    raw = sparse_map(np.random.default_rng(0), density=density)
    assert raw.shape == (D_H, D_W)
    for radius in (7, 3):
        with jax.enable_x64(False):
            ref = np.asarray(j_depth.chamfer_distance(jnp.asarray(raw > 0), radius))
        out = t_depth.chamfer_distance(_t(raw > 0), radius)
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), ref)
        assert (ref == 0).any() and (ref > 1).any()


def test_average_filtering_matches_jax(rng):
    raw = sparse_map(rng)
    for kernel, pre in ((5, False), (5, True), (3, True)):
        with jax.enable_x64(False):
            ref = np.asarray(j_depth.upsample_average_filtering(jnp.asarray(raw), kernel_size=kernel,
                                                                pre_dilate=pre))
        out = t_depth.upsample_average_filtering(_t(raw), kernel_size=kernel, pre_dilate=pre)
        assert (ref > 0).mean() > 0.3
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)   # window sums' order
    assert (t_depth.upsample_average_filtering(torch.zeros(D_H, D_W)) == 0).all()


def test_nearest_neighbor_matches_jax(rng):
    raw = sparse_map(rng, density=0.005)
    kp = np.stack([rng.uniform(0, D_W, 500), rng.uniform(0, D_H, 500)], 1).astype(np.float32)
    # tests/test_depth.py's cases: an isolated point passes through, a point
    # 3.6 px away is found, one far away is not
    iso = np.zeros((D_H, D_W), np.float32)
    iso[40, 100], iso[10, 10] = 77.0, 50.0
    cases = [(raw, kp), (iso, np.array([[100.0, 40.0], [103.0, 42.0], [200.0, 80.0]], np.float32))]
    found = []
    for m, pts in cases:
        with jax.enable_x64(False):
            ref = np.asarray(j_depth.nearest_neighbor_depth_at_keypoints(jnp.asarray(m),
                                                                         jnp.asarray(pts)))
        out = t_depth.nearest_neighbor_depth_at_keypoints(_t(m), _t(pts))
        np.testing.assert_array_equal(out.numpy(), ref)
        found.append(out.numpy())
    assert 0.2 < (found[0] > 0).mean() < 1.0
    assert found[1].tolist() == [77.0, 77.0, 0.0]


@pytest.mark.parametrize("method", ["AverageFiltering", "NearestNeighborPixel"])
def test_fused_step_per_method_matches_jax(method):
    """One fused step on frame 1 of the 320×192 canyon, from the same
    ``FastPath`` state (the JAX tracker initialized on frame 0)."""
    cfg = dataclasses.replace(j_syn.synthetic_rgbl_config(), lidar=dataclasses.replace(
        j_syn.synthetic_rgbl_config().lidar, method=method))
    cam = cfg.camera
    n_feat = sum(j_fast.features_per_level(cfg.orb.n_features, cfg.orb.n_levels,
                                           cfg.orb.scale_factor))
    traj = j_syn.straight_trajectory(2, step=0.6, weave=0.4)
    ident = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    with jax.enable_x64(False):
        world = j_syn.make_world(0, tex_size=256)
        frames = []
        for Twc in traj:
            Twc = jnp.asarray(Twc)
            frames.append((np.array(j_syn.render_image(world, Twc, cam.fx, cam.fy, cam.cx, cam.cy,
                                                       cam.height, cam.width)),
                           np.array(j_syn.lidar_scan(world, Twc, n_az=256, n_el=48))))
        jt = JTracker(cfg, JMapState.create(64, 8192, n_feat))
        jt.fast = JFastPath(cfg, n_feat)
        img0, pts0 = frames[0]
        jt.track_image_rgbl(jnp.asarray(img0), jnp.asarray(pts0), jnp.ones(len(pts0), bool), 0.0)
        jfp = jt.fast
        jfp.sync(jt.map, jt.ref_kf, jt.last_feats, jt.last_lm_idx, jt.last_lm_gen)
        state = {k: np.asarray(getattr(jfp, k)) for k in convert.FAST_PATH_STATE}
        img1, pts1 = frames[1]
        mask1 = np.ones(len(pts1), bool)
        out_j = jax.tree_util.tree_map(np.asarray, jfp.run(jnp.asarray(img1), jnp.asarray(pts1),
                                                           jnp.asarray(mask1), ident))
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    assert tcfg.lidar.method == method
    tfp = convert.fast_path_state_from_numpy(TFastPath(tcfg, n_feat, device="cpu"), state)
    out_t = tfp.run(img1, pts1, mask1, ident)
    fj, ft = out_j.feats, out_t.feats
    same = (ft.uv.numpy() == fj.uv).all(1) & ft.valid.numpy() & fj.valid
    assert same.mean() > 0.9 and (fj.depth[same] > 0).mean() > 0.3
    np.testing.assert_allclose(ft.depth.numpy()[same], fj.depth[same], rtol=1e-6)
    np.testing.assert_allclose(ft.u_right.numpy()[same], fj.u_right[same], rtol=1e-6, atol=1e-4)
    assert abs(int(out_t.n_inliers) - int(out_j.n_inliers)) <= 0.05 * int(out_j.n_inliers)
    assert int(out_j.n_inliers) > 100
    np.testing.assert_allclose(out_t.Tcw.numpy(), out_j.Tcw, atol=1e-3)


def _descs(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def test_hamming_and_distance_table_exact(rng):
    a, b = _descs(rng, 60), _descs(rng, 90)
    b[:20] = a[:20] ^ (1 << rng.integers(0, 32, (20, 8))).astype(np.uint32)   # near copies
    va, vb = rng.uniform(size=60) < 0.9, rng.uniform(size=90) < 0.9
    ref = np.asarray(j_match.hamming_distance_packed(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(
        t_match.hamming_distance_packed(_t(a.view(np.int32)), _t(b.view(np.int32))).numpy(), ref)
    d_t = t_match.distance_table(_t(a.view(np.int32)), _t(b.view(np.int32)), _t(va), _t(vb))
    d_j = j_match.distance_table(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va), jnp.asarray(vb))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


def test_mutual_best_match_exact(rng):
    a = _descs(rng, 80)
    b = np.concatenate([a[:50] ^ (1 << rng.integers(0, 32, (50, 8))).astype(np.uint32),
                        _descs(rng, 40)])
    ang_a = rng.uniform(-np.pi, np.pi, 80).astype(np.float32)
    ang_b = np.concatenate([ang_a[:50] + 0.1, rng.uniform(-np.pi, np.pi, 40)]).astype(np.float32)
    d = np.asarray(j_match.distance_table(jnp.asarray(a), jnp.asarray(b)))
    for rot in (False, True):
        i_j, d_j = j_match.mutual_best_match(jnp.asarray(d), jnp.asarray(ang_a), jnp.asarray(ang_b),
                                             th=100, ratio=0.9, check_rotation=rot)
        i_t, d_t = t_match.mutual_best_match(_t(d), _t(ang_a), _t(ang_b), th=100, ratio=0.9,
                                             check_rotation=rot)
        assert (np.asarray(i_j) >= 0).sum() >= 40
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


def _projection_case(rng, P=300, K=400, W=320, H=192):
    kp_uv = np.stack([rng.uniform(0, W, K), rng.uniform(0, H, K)], 1).astype(np.float32)
    kp_desc = _descs(rng, K)
    kp_oct = rng.integers(0, 4, K).astype(np.int32)
    kp_ang = rng.uniform(-np.pi, np.pi, K).astype(np.float32)
    src = rng.integers(0, K, P)
    proj_uv = (kp_uv[src] + rng.normal(0, 3, (P, 2))).astype(np.float32)
    proj_desc = kp_desc[src] ^ (1 << rng.integers(0, 32, (P, 8))).astype(np.uint32)
    proj_desc[::4] = _descs(rng, len(proj_desc[::4]))
    proj_oct = np.clip(kp_oct[src] + rng.integers(-1, 2, P), 0, 3).astype(np.int32)
    proj_ang = (kp_ang[src] + 0.05).astype(np.float32)
    radius = (rng.uniform(4, 15, P)).astype(np.float32)
    return dict(proj_uv=proj_uv, proj_valid=rng.uniform(size=P) < 0.95, proj_desc=proj_desc,
                proj_octave=proj_oct, kp_uv=kp_uv, kp_valid=rng.uniform(size=K) < 0.95,
                kp_desc=kp_desc, kp_octave=kp_oct, radius=radius), proj_ang, kp_ang


def test_windowed_projection_match_and_collisions_exact(rng):
    args, proj_ang, kp_ang = _projection_case(rng)
    j_args = {k: jnp.asarray(v) for k, v in args.items()}
    t_args = {k: _t(v.view(np.int32) if v.dtype == np.uint32 else v) for k, v in args.items()}
    for with_angles in (False, True):
        extra_j = dict(proj_angle=jnp.asarray(proj_ang), kp_angle=jnp.asarray(kp_ang)) if with_angles else {}
        extra_t = dict(proj_angle=_t(proj_ang), kp_angle=_t(kp_ang)) if with_angles else {}
        i_j, d_j = j_match.windowed_projection_match(**j_args, th=100, **extra_j)
        i_t, d_t = t_match.windowed_projection_match(**t_args, th=100, **extra_t)
        assert (np.asarray(i_j) >= 0).sum() > 100
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        # many projections land on the same keypoint: resolve to one each
        n_feat = len(args["kp_uv"])
        b_j = np.asarray(j_compiled._resolve_collisions(i_j, d_j, n_feat))
        b_t = t_compiled._resolve_collisions(i_t, d_t, n_feat).numpy()
        np.testing.assert_array_equal(b_t, b_j)
        assert len(np.unique(np.asarray(i_j)[np.asarray(i_j) >= 0])) < (np.asarray(i_j) >= 0).sum()


def test_resolve_collisions_ties_break_by_slot():
    idx = np.array([3, 3, 1, -1, 3, 1], np.int32)
    dist = np.array([10, 7, 5, 0, 7, 5], np.float32)
    b_t = t_compiled._resolve_collisions(_t(idx), _t(dist), 5).numpy()
    b_j = np.asarray(j_compiled._resolve_collisions(jnp.asarray(idx), jnp.asarray(dist), 5))
    np.testing.assert_array_equal(b_t, b_j)
    np.testing.assert_array_equal(b_t, [-1, 2, -1, 1, -1])
