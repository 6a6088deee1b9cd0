"""Port vs JAX: the sliding-window visual-inertial BA (``optim/inertial_ba``)
on ``tests/test_inertial_ba.py``'s problems, and the 4-DoF essential graph
(``optim/pose_graph.optimize_pose_graph_4dof``) of inertial maps.

Tolerances (observed ≥ 5× below, on the masked problem; the unmasked one
agrees 10–100× closer): VI-BA — state translations within 2e-4 m,
rotations 1e-4 rad, velocities 5e-4 m/s, gyro biases 1e-4, accel biases
1e-3, 99% of the landmarks within 5e-3 of their distance and all within
5e-2 (one weakly held landmark of the masked problem moves 1.2%), the same
inlier classification, the final cost within 1e-4 relative; without any inertial factor (a near
singular system) the biases stay 0 and the cost agrees within 3e-3. 4-DoF graph — node translations within 1e-4 and
rotations 1e-5 rad of JAX's; in the port, each keyframe's gravity direction
(roll and pitch) and scale equal to the input's within 2e-6 (float32
rounding of the right-multiplied yaw). JAX runs with x64 off."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from orb_slam3_rgbl_tpu.geometry import lie as jlie
from orb_slam3_rgbl_tpu.optim import inertial_ba as jviba
from orb_slam3_rgbl_tpu.optim import pose_graph as jpg
from orb_slam3_rgbl_tpu_torch.geometry import lie as tlie
from orb_slam3_rgbl_tpu_torch.optim import inertial_ba as tviba
from orb_slam3_rgbl_tpu_torch.optim import pose_graph as tpg

import test_inertial_ba as tiba
from test_torch_inertial import TCAM, t_meas
from test_torch_system import one_torch_thread  # noqa: F401  (module fixture)


def t_problem(P) -> tviba.VIBAProblem:
    ints = {"obs_kf", "pair_i", "pair_j"}
    out = {}
    for name in tviba.VIBAProblem._fields:
        v = getattr(P, name)
        if name == "pair_meas":
            out[name] = t_meas(v)
            continue
        a = np.array(v)
        t = torch.as_tensor(a)
        out[name] = t.long() if name in ints else (t if a.dtype == bool else t.float())
    return tviba.VIBAProblem(**out)


def _rot_gap(Ta, Tb) -> float:
    d = tlie.np_se3_mul(np.asarray(Ta, np.float32), tlie.np_se3_inv(np.asarray(Tb, np.float32)))
    return float(2 * np.arcsin(min(np.linalg.norm(d[1:4].astype(np.float64)), 1.0)))


def _run(P, iterations, huber_iters, cams=None):
    """Both solves of ``P``; ``cams`` (JAX camera, port camera), by default
    the KITTI pinhole."""
    cam_j, cam_t = cams or (tiba.CAM, TCAM)
    with jax.enable_x64(False):
        rj = jviba.vi_bundle_adjust(P, cam_j, iterations=iterations, huber_iters=huber_iters)
        rj = jax.tree_util.tree_map(np.asarray, rj)
    rt = tviba.vi_bundle_adjust(t_problem(P), cam_t, iterations=iterations,
                                huber_iters=huber_iters)
    return rj, rt


def _compare(P, iterations, huber_iters, cams=None):
    rj, rt = _run(P, iterations, huber_iters, cams)
    K = rj.Twb.shape[0]
    assert np.abs(rt.Twb[:, 4:].numpy() - rj.Twb[:, 4:]).max() < 2e-4
    assert max(_rot_gap(rt.Twb[k].numpy(), rj.Twb[k]) for k in range(K)) < 1e-4
    assert np.abs(rt.vel.numpy() - rj.vel).max() < 5e-4
    assert np.abs(rt.bg.numpy() - rj.bg).max() < 1e-4
    assert np.abs(rt.ba.numpy() - rj.ba).max() < 1e-3
    # landmarks relative to their distance from the first state
    dist = np.linalg.norm(rj.landmarks - rj.Twb[0, 4:7], axis=1)
    rel = np.linalg.norm(rt.landmarks.numpy() - rj.landmarks, axis=1) / dist
    assert np.quantile(rel, 0.99) < 5e-3 and rel.max() < 5e-2, (np.quantile(rel, 0.99), rel.max())
    np.testing.assert_array_equal(rt.obs_inlier.numpy(), rj.obs_inlier)
    assert abs(float(rt.cost) - float(rj.cost)) < 1e-4 * float(rj.cost)
    return rj, rt


def test_vi_bundle_adjust_matches_jax(rng):
    """``TestViBundleAdjust``'s perturbed window with true biases."""
    bg_true = np.array([0.02, -0.01, 0.015], np.float32)
    ba_true = np.array([0.05, -0.10, 0.08], np.float32)
    with jax.enable_x64(False):
        P, Twb_true, vel_true = tiba.build_problem(rng, n_kf=8, bg=bg_true, ba=ba_true,
                                                   pose_noise=0.05, vel_noise=0.2)
    _, rt = _compare(P, 12, 6)
    assert np.linalg.norm(rt.bg.numpy()[1:].mean(0) - bg_true) < 5e-3


def test_vi_bundle_adjust_masks_match_jax(rng):
    """Fixed anchors, an invalid pair, invalid landmarks and the visual-only
    limit (every pair invalid: the biases stay at 0)."""
    with jax.enable_x64(False):
        P, *_ = tiba.build_problem(rng, n_kf=6, bg=np.array([0.02, -0.01, 0.015]),
                                   pose_noise=0.02)
        P = P._replace(state_fixed=jnp.asarray(np.arange(6) < 2),
                       pair_valid=jnp.asarray(np.arange(5) != 3),
                       lm_valid=jnp.asarray(np.arange(P.lm_valid.shape[0]) % 7 != 0))
    rj, rt = _compare(P, 6, 5)
    np.testing.assert_array_equal(rt.Twb[:2].numpy(), np.asarray(P.Twb)[:2])
    # without inertial factors the velocity and bias blocks hold only the
    # 1e-7 floor: the system is near singular and the two libraries' f32
    # solves part at the 1e-3 level; the claim held is the biases' (still 0)
    with jax.enable_x64(False):
        P0 = P._replace(pair_valid=jnp.zeros_like(P.pair_valid))
    rj, rt = _run(P0, 6, 5)
    assert np.abs(rt.bg.numpy()).max() < 1e-6 and np.abs(rj.bg).max() < 1e-6
    assert abs(float(rt.cost) - float(rj.cost)) < 3e-3 * float(rj.cost)


def _graph(seed: int, K: int = 9):
    """A gravity-aligned keyframe chain (yaw and translation drift only),
    chain and loop edges measured on the true poses, the nodes disturbed in
    yaw and translation."""
    rng = np.random.default_rng(seed)
    with jax.enable_x64(False):
        yaw = np.linspace(0, 2.5, K)
        true = []
        for k, a in enumerate(yaw):
            Rwc = jlie.so3_exp(jnp.asarray([0.1, -0.05, a], jnp.float32))    # roll/pitch kept
            Twc = jlie.se3(Rwc, jnp.asarray([3 * np.cos(a), 3 * np.sin(a), 0.2 * k],
                                            jnp.float32))
            true.append(np.concatenate([np.asarray(jlie.se3_inv(Twc)), [1.0]]).astype(np.float32))
        true = np.stack(true)
        nodes = true.copy()
        for k in range(1, K):
            d = np.zeros(7, np.float32)
            d[:3] = rng.normal(0, 0.1, 3)
            d[5] = rng.normal(0, 0.05)
            nodes[k] = np.asarray(jlie.sim3_mul(jnp.asarray(nodes[k]), jlie.sim3_exp(jnp.asarray(d))))
        ei = list(range(K - 1)) + [K - 1, K - 1]
        ej = list(range(1, K)) + [0, 2]
        Sij = [np.asarray(jpg.relative_sim3(jnp.asarray(true), a, b)) for a, b in zip(ei, ej)]
    E = len(ei)
    return {"nodes": nodes, "node_fixed": np.arange(K) == 0, "node_valid": np.ones(K, bool),
            "edge_i": np.asarray(ei, np.int32), "edge_j": np.asarray(ej, np.int32),
            "edge_Sij": np.stack(Sij).astype(np.float32),
            "edge_weight": np.ones(E, np.float32) * 10.0, "edge_valid": np.ones(E, bool)}


def _gravity_in_cam(S: np.ndarray) -> np.ndarray:
    return tlie.np_quat_rotate(S[:, :4], np.tile([0.0, 0.0, -1.0], (len(S), 1)).astype(np.float32))


def test_pose_graph_4dof_matches_jax():
    from orb_slam3_rgbl_tpu_torch import convert

    arrays = _graph(3)
    with jax.enable_x64(False):
        pj = jpg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
        nj = np.asarray(jpg.optimize_pose_graph_4dof(pj, iterations=20))
    pt = convert.pose_graph_problem_from_numpy(arrays, device="cpu")
    nt = tpg.optimize_pose_graph_4dof(pt, iterations=20).numpy()
    assert np.abs(nt[:, 4:7] - nj[:, 4:7]).max() < 1e-4
    assert max(_rot_gap(nt[k, :7], nj[k, :7]) for k in range(len(nt))) < 1e-5
    # only yaw and translation moved: each keyframe's gravity direction
    # (roll, pitch) and the scales are the input's
    g0, g1 = _gravity_in_cam(arrays["nodes"]), _gravity_in_cam(nt)
    assert np.abs(g1 - g0).max() < 2e-6, np.abs(g1 - g0).max()
    assert np.abs(nt[:, 7] - 1.0).max() < 2e-6
    # and the graph's cost fell
    assert float(tpg.pose_graph_cost(pt, torch.as_tensor(nt))) < 0.1 * float(
        tpg.pose_graph_cost(pt, pt.nodes))
    np.testing.assert_array_equal(nt[0], arrays["nodes"][0])     # the fixed node
