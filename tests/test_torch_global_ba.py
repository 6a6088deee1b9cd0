"""Port vs JAX: ``optim/global_ba.py`` on the whole-map problem of a JAX map.

A JAX ``System`` (default configuration) takes 60 frames of the circular
feature drive; ``ba_assembly.build_full_problem`` of its map (padded to the
JAX closer's tiers) is perturbed from a seed (poses 2 cm / 2 mrad, landmarks
5 cm) and goes to both solvers as the same f32 arrays.

* ``PoseSegments.sum`` against ``index_add_`` and against JAX's scatter-add:
  1e-5 relative (the orders of summation differ);
* 2 LM iterations × 24 CG steps: poses and landmarks 2e-4 (observed
  ≤ 3e-5), equal inlier masks on ≥ 99.9% of the observations, costs within
  1e-3 relative;
* 8 × 64: poses 1e-3, landmark median 1e-3 m (observed 2.7e-4 and 2.3e-4),
  inlier masks equal on ≥ 99.5%;
* 16 × 64, the loop closer's budget: the costs agree to 1e-4 relative
  (752.2256 against 752.2135), poses to 1e-2 and the landmark median to
  1e-2 m (observed 4.2e-3 and 3.5e-3). From iteration 9 on the cost is flat
  to its sixth digit, the accept test turns on rounding, and each f32 solver
  wanders along the valley's floor: against the port's own solve in f64
  the port ends 9.9 mm off and JAX 5.7 mm. The fixed pose stays untouched
  to the bit, and so do the padded poses and landmarks;
* two solves of one problem give the same bits.

JAX runs with x64 off, as outside the test suite."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu.optim import global_ba as j_gba
from orb_slam3_rgbl_tpu.slam import ba_assembly as j_asm
from orb_slam3_rgbl_tpu.slam.frame import inv_scale_sigma2 as j_inv_s2
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera
from orb_slam3_rgbl_tpu_torch.optim import global_ba as t_gba
from orb_slam3_rgbl_tpu_torch.slam import ba_assembly as t_asm

from test_torch_loop_closing import jax_state_before_loop


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problems():
    js, *_ = jax_state_before_loop(stop_after_frames=60)
    with jax.enable_x64(False):
        inv_s2 = np.asarray(j_inv_s2(js.cfg.orb.n_levels, js.cfg.orb.scale_factor))
        pj, window, lm_ids, _, _ = j_asm.build_full_problem(js.map, inv_s2, min_pose_tier=32,
                                                            min_lm_tier=1024)
    arrays = {k: np.array(v) for k, v in pj._asdict().items()}
    rng = np.random.default_rng(11)
    K, M = len(window), len(lm_ids)
    free = ~arrays["pose_fixed"][:K]
    arrays["poses"][:K][free, 4:7] += rng.normal(0, 0.02, (int(free.sum()), 3)).astype(np.float32)
    arrays["poses"][:K][free, 1:4] += rng.normal(0, 0.001, (int(free.sum()), 3)).astype(np.float32)
    arrays["poses"][:K, :4] /= np.linalg.norm(arrays["poses"][:K, :4], axis=1, keepdims=True)
    arrays["landmarks"][:M] += rng.normal(0, 0.05, (M, 3)).astype(np.float32)
    with jax.enable_x64(False):
        pj = pj._replace(**{k: jnp.asarray(v) for k, v in arrays.items()})
    pt = convert.ba_problem_from_numpy(arrays, device="cpu")
    cam_t = PinholeCamera(**dataclasses.asdict(js.cfg.camera))
    # the port's own assembly at the real sizes sees the same map
    tm = convert.map_state_from_numpy(js.map)
    real, window_t, lm_ids_t, _, _ = t_asm.build_full_problem(tm, inv_s2, min_pose_tier=1,
                                                              min_lm_tier=1, device="cpu")
    np.testing.assert_array_equal(window_t, window)
    np.testing.assert_array_equal(lm_ids_t, lm_ids)
    assert K >= 9 and M > 800 and arrays["pose_fixed"].sum() >= 1
    return js.cfg.camera, cam_t, pj, pt, arrays, K, M


def _segments(p):
    return t_gba.PoseSegments(p.obs_kf, p.obs_mask, p.poses.shape[0])


def test_pose_segments_sum(problems):
    _, _, pj, pt, arrays, K, M = problems
    Kp = pt.poses.shape[0]
    seg = _segments(pt)
    rng = np.random.default_rng(2)
    vals = rng.normal(0, 1, pt.obs_kf.shape + (6,)).astype(np.float32)
    vals *= arrays["obs_mask"][..., None]
    got = seg.sum(torch.from_numpy(vals))
    want = torch.zeros(Kp, 6).index_add_(0, pt.obs_kf.reshape(-1),
                                         torch.from_numpy(vals).reshape(-1, 6))
    with jax.enable_x64(False):
        want_j = np.asarray(j_gba._segment_pose_sum(jnp.asarray(vals), pj.obs_kf, Kp))
    scale = np.abs(want_j).max()
    assert got.shape == (Kp, 6) and scale > 10
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5 * scale)
    np.testing.assert_allclose(got.numpy(), want_j, atol=1e-5 * scale)
    # the table holds every unmasked observation once, under its own pose
    tab = seg.table.numpy()
    held = tab[tab < seg.n_obs]
    assert held.size == int(arrays["obs_mask"].sum()) == np.unique(held).size
    rows = np.repeat(np.arange(Kp), tab.shape[1]).reshape(tab.shape)[tab < seg.n_obs]
    np.testing.assert_array_equal(arrays["obs_kf"].reshape(-1)[held], rows)
    assert tab.shape == (Kp, np.bincount(arrays["obs_kf"][arrays["obs_mask"]]).max())


def _compare(res_t, res_j, arrays, K, M, tol, lm_tol, mask_share):
    pose_t, pose_j = res_t.poses.numpy(), np.asarray(res_j.poses)
    np.testing.assert_allclose(pose_t[:K], pose_j[:K], atol=tol)
    d_lm = np.abs(res_t.landmarks.numpy()[:M] - np.asarray(res_j.landmarks)[:M]).max(axis=1)
    assert np.median(d_lm) < lm_tol and np.quantile(d_lm, 0.99) < 20 * lm_tol, \
        (np.median(d_lm), d_lm.max())
    same = res_t.obs_inlier.numpy() == np.asarray(res_j.obs_inlier)
    assert same[arrays["obs_mask"]].mean() >= mask_share, same[arrays["obs_mask"]].mean()
    assert not res_t.obs_inlier.numpy()[~arrays["obs_mask"]].any()
    np.testing.assert_allclose(float(res_t.cost), float(res_j.cost), rtol=5e-3)
    # fixed and padded entries stay as they were, to the bit
    fixed = arrays["pose_fixed"] | ~arrays["pose_valid"]
    np.testing.assert_array_equal(pose_t[fixed], arrays["poses"][fixed])
    np.testing.assert_array_equal(res_t.landmarks.numpy()[~arrays["lm_valid"]],
                                  arrays["landmarks"][~arrays["lm_valid"]])


def test_two_iterations_match_jax(problems):
    cam_j, cam_t, pj, pt, arrays, K, M = problems
    with jax.enable_x64(False):
        res_j = j_gba.global_bundle_adjust(pj, cam_j, iterations=2, cg_iters=24)
    res_t = t_gba.global_bundle_adjust(pt, cam_t, _segments(pt), iterations=2, cg_iters=24)
    assert res_t.poses.dtype == torch.float32 and res_t.obs_inlier.dtype == torch.bool
    _compare(res_t, res_j, arrays, K, M, tol=2e-4, lm_tol=2e-4, mask_share=0.999)
    cost0 = float(t_gba.ba_cost(pt, cam_t))
    assert float(res_t.cost) < 0.5 * cost0, (float(res_t.cost), cost0)


def test_eight_by_sixty_four_match_jax(problems):
    cam_j, cam_t, pj, pt, arrays, K, M = problems
    with jax.enable_x64(False):
        res_j = j_gba.global_bundle_adjust(pj, cam_j, iterations=8, cg_iters=64)
    res_t = t_gba.global_bundle_adjust(pt, cam_t, _segments(pt), iterations=8, cg_iters=64)
    _compare(res_t, res_j, arrays, K, M, tol=1e-3, lm_tol=1e-3, mask_share=0.995)


def test_sixteen_by_sixty_four_match_jax_and_repeat_to_the_bit(problems):
    cam_j, cam_t, pj, pt, arrays, K, M = problems
    with jax.enable_x64(False):
        res_j = j_gba.global_bundle_adjust(pj, cam_j, iterations=16, cg_iters=64)
    res_t = t_gba.global_bundle_adjust(pt, cam_t, _segments(pt), iterations=16, cg_iters=64)
    _compare(res_t, res_j, arrays, K, M, tol=1e-2, lm_tol=1e-2, mask_share=0.995)
    np.testing.assert_allclose(float(res_t.cost), float(res_j.cost), rtol=1e-4)
    assert float(res_t.cost) < 0.2 * float(t_gba.ba_cost(pt, cam_t))
    again = t_gba.global_bundle_adjust(pt, cam_t, _segments(pt), iterations=16, cg_iters=64)
    assert torch.equal(again.poses, res_t.poses) and torch.equal(again.landmarks, res_t.landmarks)
    assert torch.equal(again.cost, res_t.cost)
