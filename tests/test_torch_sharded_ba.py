"""Port vs JAX: ``parallel/sharded_ba.py`` and ``parallel/mesh.py``.

The port shards the landmarks over the ranks of a ``torch.distributed`` gloo
group on the CPU (each rank a spawned process with one torch thread; world
sizes 2 and 4 spawned once each for the module), JAX over its 8-device
virtual CPU mesh (``tests/conftest.py``), on ``tests/test_sharded_ba.py``'s
problems (``synth_ba`` K 6 / M 300 for the dense-Schur oracle, K 8 / M 400
for the PCG path; JAX pads them to 320 and 416 landmarks, the port takes the
real counts). JAX runs with x64 off, as outside the test suite.

* ``synth_gba_problem`` equals ``__graft_entry__._synth_gba_problem`` bit
  for bit;
* ``shard_problem``'s slices hold the real counts (near-equal) and
  concatenate back to the input exactly;
* against JAX: poses within ``POSE_TOL`` = 2e-4 for the dense solve and 2
  LM iterations × 25 CG steps of the PCG path (observed ≤ 3.1e-6), as
  ``tests/test_torch_global_ba.py`` holds 2 × 24, and the final cost within
  ``COST_RTOL`` = 1e-3 relative (observed ≤ 6e-6). Over the JAX test's 8 ×
  25 the cost is flat to its sixth digit from iteration 7 on (190.2670 →
  190.2656 in JAX): JAX's single-device and sharded solves accept the 8th
  step, the port's single-device solve and world 2 reject it and world 4
  takes it: a decision that turns on rounding, so there the poses are held
  to ``VALLEY_TOL`` = 1e-2 (observed 3.1e-3), ``test_torch_global_ba.py``'s
  bar for 16 × 64;
* against the port in one process: world 1 of the PCG path equals
  ``global_bundle_adjust`` bit for bit, and worlds 2 and 4 agree with world
  1 within rounding (the same bars: observed ≤ 3.8e-6 on poses where no
  accept decision differs);
* JAX's own bars (``tests/test_sharded_ba.py``) on the port: the dense
  solve's pose error to the ground truth < 0.02, the PCG solve's < 0.05 and
  within 0.02 of the single-device solve's;
* the replicated poses come back bit-equal on every rank, and a second
  solve of the same problem gives the same bits.
"""

import os
import shutil
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu.config import kitti_rgbl_config as j_kitti_config
from orb_slam3_rgbl_tpu.optim import global_ba as j_gba
from orb_slam3_rgbl_tpu.parallel import mesh as j_mesh
from orb_slam3_rgbl_tpu.parallel import sharded_ba as j_sba
from orb_slam3_rgbl_tpu_torch import convert, synthetic
from orb_slam3_rgbl_tpu_torch.config import kitti_rgbl_config
from orb_slam3_rgbl_tpu_torch.optim import global_ba as t_gba
from orb_slam3_rgbl_tpu_torch.parallel import mesh as t_mesh
from orb_slam3_rgbl_tpu_torch.parallel import sharded_ba as t_sba

from test_local_ba import CAM as CAM_J, pose_rmse, synth_ba
from test_sharded_ba import pad_problem_to

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import __graft_entry__  # noqa: E402

POSE_TOL = 2e-4
VALLEY_TOL = 1e-2
COST_RTOL = 1e-3
CAM = kitti_rgbl_config().camera
DENSE = dict(iterations=12)
PCG = dict(iterations=8, cg_iters=25)
PCG_SHORT = dict(iterations=2, cg_iters=25)
JOBS = ("dense", "pcg", "pcg_short")
WORLDS = (2, 4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(problem):
    return {k: np.array(v) for k, v in problem._asdict().items()}


@pytest.fixture(scope="module")
def problems():
    """(dense problem, PCG problem), each as (f32 numpy arrays, ground-truth
    poses), drawn as ``tests/test_sharded_ba.py`` draws them."""
    with jax.enable_x64(False):
        dense, gt_d, _, _ = synth_ba(np.random.default_rng(0), K=6, M=300, noise=0.2)
        pcg, gt_p, _, _ = synth_ba(np.random.default_rng(0), K=8, M=400, noise=0.2)
    return (_arrays(dense), gt_d), (_arrays(pcg), gt_p)


@pytest.fixture(scope="module")
def jax_results(problems):
    """JAX's distributed solves on its 8-device mesh (padded problems)."""
    (dense, _), (pcg, _) = problems
    mesh = j_mesh.make_mesh(8)
    with jax.enable_x64(False):
        pd = pad_problem_to(j_sba.local_ba.BAProblem(**{k: jnp.asarray(v) for k, v in dense.items()}), 320)
        pp = pad_problem_to(j_sba.local_ba.BAProblem(**{k: jnp.asarray(v) for k, v in pcg.items()}), 416)
        poses_d, lms_d = j_sba.make_distributed_ba(mesh, CAM_J, **DENSE)(j_sba.shard_problem(pd, mesh))
        out = {"dense": (np.asarray(poses_d), np.asarray(lms_d)[:300])}
        for job, kw in (("pcg", PCG), ("pcg_short", PCG_SHORT)):
            poses_p, lms_p = j_sba.make_distributed_pcg_ba(mesh, CAM_J, **kw)(
                j_sba.shard_problem(pp, mesh))
            out[job] = (np.asarray(poses_p), np.asarray(lms_p)[:400])
        out["pcg_single"] = np.asarray(j_gba.global_bundle_adjust(pp, CAM_J, **PCG).poses)
    return out


def _jobs(problems):
    (dense, _), (pcg, _) = problems
    pcg = convert.ba_problem_from_numpy(pcg, device="cpu")
    return [(convert.ba_problem_from_numpy(dense, device="cpu"), CAM, "dense", DENSE),
            (pcg, CAM, "pcg", PCG), (pcg, CAM, "pcg", PCG_SHORT)]


@pytest.fixture(scope="module")
def port_results(problems):
    """``out[world][job]``: world 1 in this process (a one-rank gloo group),
    worlds 2 and 4 each spawned once, every job solved twice."""
    jobs = _jobs(problems)
    init, store = t_mesh.file_store()
    mesh = t_mesh.make_mesh(0, 1, "gloo", init, device="cpu")
    try:
        sent = [(t_sba.problem_arrays(p), c, s, kw) for p, c, s, kw in jobs]
        out = {1: [[rec] for rec in t_sba._solve_jobs(mesh, sent, 2)]}
    finally:
        mesh.close()
        shutil.rmtree(store, ignore_errors=True)
    for world in WORLDS:
        out[world] = t_sba.solve_on_ranks(jobs, world, "cpu", repeats=2, timeout_s=300)
    return out


def _gathered(ranks, repeat=0):
    """(poses of rank 0, every rank's landmarks concatenated)."""
    return ranks[0]["poses"][repeat], np.concatenate([r["landmarks"][repeat] for r in ranks])


def _cost(arrays, poses, lms):
    p = convert.ba_problem_from_numpy(arrays, device="cpu")
    return float(t_gba.ba_cost(p._replace(poses=torch.tensor(poses), landmarks=torch.tensor(lms)),
                               CAM))


def test_synth_gba_problem_equals_the_jax_harness():
    with jax.enable_x64(False):
        pj, gt_j, centers_j = __graft_entry__._synth_gba_problem(24, 500, 4, j_kitti_config().camera)
    pt, gt_t, centers_t = synthetic.synth_gba_problem(24, 500, 4, CAM, device="cpu")
    for f in pj._fields:
        a, b = np.asarray(getattr(pj, f)), getattr(pt, f).numpy()
        assert a.shape == b.shape, f
        if f == "obs_kf":
            assert a.dtype == np.int32 and b.dtype == np.int64
            b = b.astype(np.int32)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert gt_j.tobytes() == gt_t.tobytes() and centers_j.tobytes() == centers_t.tobytes()


@pytest.mark.parametrize("n,world", [(300, 2), (300, 4), (401, 4), (5, 8), (320, 8)])
def test_shard_problem_slices_the_real_counts(problems, n, world):
    arrays = dict(problems[0][0])
    M = arrays["landmarks"].shape[0]
    for f in t_sba.LANDMARK_FIELDS:        # grow or cut the landmark axis to n
        reps = -(-n // M)
        arrays[f] = np.concatenate([arrays[f]] * reps)[:n]
    full = convert.ba_problem_from_numpy(arrays, device="cpu")
    shards = [t_sba.shard_problem(full, r, world, "cpu") for r in range(world)]
    counts = [s.landmarks.shape[0] for s in shards]
    assert sum(counts) == n and max(counts) - min(counts) <= 1 and counts == sorted(counts, reverse=True)
    for f in full._fields:
        parts = [getattr(s, f) for s in shards]
        if f in t_sba.LANDMARK_FIELDS:
            assert torch.equal(torch.cat(parts), getattr(full, f)), f
        else:
            assert all(torch.equal(p, getattr(full, f)) for p in parts), f
    sl = t_mesh.landmark_sharding(n, world - 1, world)
    assert sl.stop == n and t_mesh.replicated(n) == slice(0, n)


def test_make_mesh_refuses_a_backend_it_cannot_start():
    with pytest.raises(ValueError, match="backend"):
        t_mesh.make_mesh(0, 1, "mpi", "file:///nonexistent", device="cpu")
    with pytest.raises(RuntimeError, match="nccl"):
        t_mesh.make_mesh(0, 1, "nccl", "file:///nonexistent", device="cpu")


@pytest.mark.parametrize("world", (1,) + WORLDS)
@pytest.mark.parametrize("job", JOBS)
def test_replicated_poses_are_bit_equal_and_repeat(port_results, world, job):
    ranks = port_results[world][JOBS.index(job)]
    assert len(ranks) == world
    first = ranks[0]["poses"][0]
    for r in ranks:
        for rep in range(2):
            assert r["poses"][rep].tobytes() == first.tobytes(), (r, rep)
        assert r["landmarks"][1].tobytes() == r["landmarks"][0].tobytes()
    counts = [r["n_landmarks"] for r in ranks]
    assert sum(counts) == (300 if job == "dense" else 400) and max(counts) - min(counts) <= 1


def test_pcg_world_1_is_the_single_device_solve(problems, port_results):
    arrays = problems[1][0]
    p = convert.ba_problem_from_numpy(arrays, device="cpu")
    res = t_gba.global_bundle_adjust(p, CAM, t_gba.PoseSegments(p.obs_kf, p.obs_mask, 8), **PCG)
    poses, lms = _gathered(port_results[1][1])
    assert poses.tobytes() == res.poses.numpy().tobytes()
    assert lms.tobytes() == res.landmarks.numpy().tobytes()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("job", JOBS)
def test_matches_jax_and_the_one_rank_solve(problems, jax_results, port_results, world, job):
    j = JOBS.index(job)
    arrays, gt = problems[min(j, 1)]
    poses, lms = _gathered(port_results[world][j])
    poses_1, lms_1 = _gathered(port_results[1][j])
    poses_j, lms_j = jax_results[job]
    tol = VALLEY_TOL if job == "pcg" else POSE_TOL
    np.testing.assert_allclose(poses, poses_j, atol=tol)
    np.testing.assert_allclose(poses, poses_1, atol=tol)
    cost, cost_1, cost_j = (_cost(arrays, p, l) for p, l in
                            ((poses, lms), (poses_1, lms_1), (poses_j, lms_j)))
    assert abs(cost - cost_j) <= COST_RTOL * cost_j, (cost, cost_j)
    assert abs(cost - cost_1) <= COST_RTOL * cost_1, (cost, cost_1)
    err = pose_rmse(poses, gt)
    if job == "dense":
        assert err < 0.02, err
        assert err < max(3 * pose_rmse(poses_1, gt), 5e-3)
    elif job == "pcg":
        err_single = pose_rmse(jax_results["pcg_single"], gt)
        assert err < 0.05 and abs(err - err_single) < 0.02, (err, err_single)


def test_collectives_per_lm_iteration(port_results):
    """Per LM iteration of the PCG path: one collective at assembly, two a
    CG step, one for the first dot product and one at acceptance; the final
    cost adds one. Bytes: ``comm_bytes`` (the JAX tool's formula plus the CG
    steps' scalars)."""
    K, it, cg = 8, PCG["iterations"], PCG["cg_iters"]
    for world in (1,) + WORLDS:
        r = port_results[world][1][0]
        assert r["collectives"] == [it * (2 * cg + 3) + 1] * 2
        assert r["bytes"] == [it * t_sba.comm_bytes(K, cg) + 4] * 2
