"""Port vs JAX: SE3 algebra, LiDAR depth, descriptor matching and the
fused step's collision resolution. Integer outputs are held exactly."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu import config as j_config
from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu.geometry import lie as j_lie
from orb_slam3_rgbl_tpu.ops import depth as j_depth
from orb_slam3_rgbl_tpu.ops import matching as j_match
from orb_slam3_rgbl_tpu.slam import compiled as j_compiled
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from orb_slam3_rgbl_tpu_torch.ops import depth as t_depth
from orb_slam3_rgbl_tpu_torch.ops import matching as t_match
from orb_slam3_rgbl_tpu_torch.slam import compiled as t_compiled


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
    with pytest.raises(NotImplementedError):
        t_depth.compute_depth_from_pointcloud(_t(pts), _t(P), _t(uv), _t(uv), height=H,
                                              width=W, bf=cam.bf, method="AverageFiltering")


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
