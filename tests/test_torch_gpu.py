"""The CUDA kernels K1, K2 and K3 against their plain versions, the loop-closing
plane's solvers, the atlas weld and the tree vocabulary against their CPU runs,
on the card. Marked
``gpu``; without a card each test skips from its fixture.

The machine with the card has no JAX, so run this file without the
suite's conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from orb_slam3_rgbl_tpu_torch import cuda_build
from orb_slam3_rgbl_tpu_torch.ops import brief_cuda, frontend_cuda, orb as orb_ops
from orb_slam3_rgbl_tpu_torch.ops import pyramid as pyr_ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("h, w", [(4, 4), (93, 171), (128, 256), (105, 346), (376, 1241)])
def test_k1_matches_plain_version(cuda, h, w):
    rng = np.random.default_rng(h * w)
    for img in (np.round(rng.uniform(0, 255, (h, w))), rng.uniform(0, 255, (h, w))):
        x = torch.tensor(img, dtype=torch.float32, device=cuda)
        before = cuda_build.launch_counts["fast_and_blur"]
        score, blur = frontend_cuda.fast_and_blur(x)
        score_p, blur_p = frontend_cuda.fast_and_blur_plain(x)
        torch.cuda.synchronize()
        assert cuda_build.launch_counts["fast_and_blur"] == before + 1
        assert torch.equal(score.view(torch.int32), score_p.view(torch.int32))
        assert float((blur - blur_p).abs().max()) <= 1e-3


LEVEL_LISTS = {
    "kitti8": pyr_ops.level_sizes(376, 1241, 8, 1.2),
    "one": ((93, 171),),
    "tiny": ((4, 4), (5, 7)),
    "three": ((128, 256), (107, 213), (89, 178)),
    "most": tuple((20 + i, 40 + 3 * i) for i in range(frontend_cuda.MAX_LEVELS)),
}


@pytest.mark.parametrize("which", sorted(LEVEL_LISTS))
def test_k1_levels_match_plain_version(cuda, which):
    """One launch over a list of levels: scores and composite bit-identical
    to the plain version (the composite's zero padding too, written into
    an uninitialised tensor), unrounded blurs within 1e-3, for every
    combination of outputs."""
    shapes = LEVEL_LISTS[which]
    rng = np.random.default_rng(len(shapes))
    levels = [torch.tensor(rng.uniform(0, 255, hw), dtype=torch.float32, device=cuda)
              for hw in shapes]
    scores_p, blurs_p, comp_p, offs_p = frontend_cuda.fast_and_blur_levels_plain(
        levels, want_blur=True)
    # leave non-zero bytes where the next composite is likely to be allocated
    Hc, W0, _ = brief_cuda.composite_layout(shapes)
    junk = torch.full((Hc, W0), 7.0, device=cuda)
    del junk
    for want_blur, want_comp in ((False, True), (True, False), (True, True), (False, False)):
        before = cuda_build.launch_counts["fast_and_blur"]
        scores, blurs, comp, offs = frontend_cuda.fast_and_blur_levels(
            levels, want_blur=want_blur, want_comp=want_comp)
        torch.cuda.synchronize()
        assert cuda_build.launch_counts["fast_and_blur"] == before + 1
        for s, s_p in zip(scores, scores_p):
            assert torch.equal(s.view(torch.int32), s_p.view(torch.int32))
        if want_blur:
            assert max(float((b - b_p).abs().max()) for b, b_p in zip(blurs, blurs_p)) <= 1e-3
        else:
            assert blurs is None
        if want_comp:
            assert offs == offs_p and torch.equal(comp, comp_p)
        else:
            assert comp is None and offs is None


def test_k2_matches_plain_versions(cuda):
    rng = np.random.default_rng(7)
    Hc, Wc, N = 600, 1408, 2000
    comp = torch.tensor(np.round(rng.uniform(0, 255, (Hc, Wc))), dtype=torch.float32, device=cuda)
    uv = torch.tensor(np.stack([rng.integers(19, Wc - 160, N), rng.integers(19, Hc - 28, N)], 1),
                      dtype=torch.int32, device=cuda)
    ang = torch.tensor(rng.uniform(-np.pi, np.pi, N), dtype=torch.float32, device=cuda)
    corners = (uv - brief_cuda.HALF).contiguous()
    idx = brief_cuda.continuous_index_tables(ang)
    before = cuda_build.launch_counts["brief_continuous"]
    d = brief_cuda.brief_continuous(comp, corners, ang)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["brief_continuous"] == before + 1
    assert torch.equal(d, brief_cuda.brief_continuous_plain(comp, corners, idx))
    assert torch.equal(d, orb_ops.brief_descriptors(comp, uv, ang))
    # counts that leave the last block partly filled, and a single keypoint
    for n in (5, 3, 1):
        part = brief_cuda.brief_continuous(comp, corners[:n].contiguous(), ang[:n].contiguous())
        assert torch.equal(part, d[:n])
    # corners outside the composite are clamped as the plain version clamps them
    wild = corners.clone()
    wild[::7] = torch.tensor([-50, 10 ** 6], dtype=torch.int32, device=cuda)
    assert torch.equal(brief_cuda.brief_continuous(comp, wild, ang),
                       brief_cuda.brief_continuous_plain(comp, wild, idx))


def test_k2_rotation_equals_index_tables(cuda):
    """Every rotated position the kernel computes, against
    ``continuous_index_tables``: random angles, multiples of 12 degrees
    (many .5 ties before rounding) and the ends of the range."""
    rng = np.random.default_rng(11)
    ang = np.concatenate([rng.uniform(-np.pi, np.pi, 4000),
                          np.arange(-15, 16) * (np.pi / 15), [np.pi, -np.pi, 0.0]])
    ang = torch.tensor(ang, dtype=torch.float32, device=cuda)
    assert torch.equal(brief_cuda.rotation_tables(ang), brief_cuda.continuous_index_tables(ang))


@pytest.mark.parametrize("n", [5, 70, 2000])
def test_k3_matches_plain_version(cuda, n):
    """K3 on random composites: all slots of the JAX layout (every block's
    last slots are padding at corner (1, 1)), and a slot count that leaves
    the last block partly filled."""
    rng = np.random.default_rng(n)
    Hc, Wc = 1752, 1408
    comp = torch.tensor(np.round(rng.uniform(0, 255, (Hc, Wc))), dtype=torch.float32, device=cuda)
    uv = torch.tensor(np.stack([rng.integers(19, Wc - 160, n), rng.integers(19, Hc - 28, n)], 1),
                      dtype=torch.int32, device=cuda)
    ang = torch.tensor(rng.uniform(-np.pi, np.pi, n), dtype=torch.float32, device=cuda)
    corners, block_bins, slots = brief_cuda.binned_inputs((uv - brief_cuda.HALF).contiguous(), ang)
    before = cuda_build.launch_counts["brief_blocks"]
    d = brief_cuda.brief_blocks(comp, corners, block_bins)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["brief_blocks"] == before + 1
    assert torch.equal(d, brief_cuda.brief_blocks_plain(comp, corners, block_bins))
    assert torch.equal(d[slots.long()], brief_cuda.brief_binned_plain(comp, uv, ang))
    S = corners.shape[0] - 37          # last block partly filled
    part = brief_cuda.brief_blocks(comp, corners[:S].contiguous(),
                                   block_bins[:(S + brief_cuda.BLK - 1) // brief_cuda.BLK])
    assert torch.equal(part, d[:S])


@pytest.mark.parametrize("S", [64, 1, 3, 61, 64 * 5 - 37, 64 * 7 + 13])
def test_k3_slot_counts(cuda, S):
    """K3 at one whole block of 64 slots and at slot counts its 8 slots a
    block do not divide, with wild corners and bins: the plain version's
    words on every slot, and one launch counted."""
    rng = np.random.default_rng(S)
    Hc, Wc = 600, 1408
    comp = torch.tensor(np.round(rng.uniform(0, 255, (Hc, Wc))), dtype=torch.float32, device=cuda)
    corners = torch.tensor(np.stack([rng.integers(-30, Wc + 30, S), rng.integers(-30, Hc + 30, S)], 1),
                           dtype=torch.int32, device=cuda)
    n_blocks = (S + brief_cuda.BLK - 1) // brief_cuda.BLK
    block_bins = torch.tensor(rng.integers(-1, brief_cuda.NB + 1, (n_blocks, 1)),
                              dtype=torch.int32, device=cuda)
    want = brief_cuda.brief_blocks_plain(comp, corners, block_bins)
    before = cuda_build.launch_counts["brief_blocks"]
    assert torch.equal(brief_cuda.brief_blocks(comp, corners, block_bins), want)
    assert cuda_build.launch_counts["brief_blocks"] == before + 1


def test_wrappers_reject_bad_inputs(cuda):
    with pytest.raises(ValueError):
        frontend_cuda.fast_and_blur(torch.zeros((3, 64), device=cuda))
    with pytest.raises(ValueError):
        frontend_cuda.fast_and_blur(torch.zeros((64, 64), dtype=torch.float64, device=cuda))
    ok = torch.zeros((64, 64), device=cuda)
    for bad in ([], [ok] * (frontend_cuda.MAX_LEVELS + 1), [ok, torch.zeros((3, 64), device=cuda)],
                [ok, ok.double()], [ok, ok.t()[:, :32]], [ok, ok.cpu()]):
        with pytest.raises(ValueError):
            frontend_cuda.fast_and_blur_levels(bad)
    comp = torch.zeros((64, 64), device=cuda)
    ang = torch.zeros((2,), device=cuda)
    with pytest.raises(ValueError):
        brief_cuda.brief_continuous(comp, torch.zeros((2, 2), dtype=torch.int64, device=cuda), ang)
    corners2 = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    for bad_ang in (ang.double(), torch.zeros((3,), device=cuda), ang.cpu(),
                    torch.zeros((2, 512), dtype=torch.int32, device=cuda)):
        with pytest.raises(ValueError):
            brief_cuda.brief_continuous(comp, corners2, bad_ang)
    with pytest.raises(ValueError):
        brief_cuda.brief_continuous(torch.zeros((30, 64), device=cuda), corners2, ang)
    corners = torch.ones((128, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):     # one bin per block: (2, 1), not (1, 1)
        brief_cuda.brief_blocks(comp, corners, torch.zeros((1, 1), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        brief_cuda.brief_blocks(comp, corners, torch.zeros((2, 1), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        brief_cuda.brief_blocks(comp, corners.cpu(), torch.zeros((2, 1), dtype=torch.int32, device=cuda))


# ---------------------------------------------------------------------------
# The loop-closing plane's solvers: plain PyTorch, no kernel of their own. On
# the card each must agree with its CPU run, wait for nothing, and the global
# BA must repeat to the bit.
# ---------------------------------------------------------------------------

def _loop_cam():
    from orb_slam3_rgbl_tpu_torch.config import kitti_rgbl_config
    return kitti_rgbl_config().camera


def _sim3_scene(seed=4, P=300, outlier_frac=0.2):
    from orb_slam3_rgbl_tpu_torch.geometry import lie
    cam = _loop_cam()
    rng = np.random.default_rng(seed)
    p2 = np.stack([rng.uniform(-10, 10, P), rng.uniform(-4, 4, P), rng.uniform(8, 50, P)],
                  axis=1).astype(np.float32)
    S12 = lie.sim3_exp(torch.tensor([0.4, -0.2, 0.3, 0.04, 0.02, -0.05, 0.0]))
    clean = lie.sim3_apply(S12, torch.from_numpy(p2)).numpy()
    p1 = clean.copy()
    out_idx = rng.choice(P, int(P * outlier_frac), replace=False)
    p1[out_idx] += rng.uniform(2, 5, (len(out_idx), 3)).astype(np.float32)

    def proj(p):
        return np.stack([cam.fx * p[:, 0] / p[:, 2] + cam.cx,
                         cam.fy * p[:, 1] / p[:, 2] + cam.cy], axis=1).astype(np.float32)

    uv1 = proj(clean) + rng.normal(0, 0.5, (P, 2)).astype(np.float32)
    uv2 = proj(p2) + rng.normal(0, 0.5, (P, 2)).astype(np.float32)
    s2 = np.ones(P, np.float32)
    draws = rng.integers(0, P, (512, 3))
    arrays = [torch.from_numpy(a) for a in (p1, p2, uv1, uv2, s2, s2, np.ones(P, bool))]
    return cam, S12, arrays, torch.from_numpy(draws)


def _no_sync(fn):
    """Run ``fn`` with every wait for the device made an error."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out


def test_sim3_and_pnp_solvers_match_their_cpu_runs(cuda):
    """Same draws on both devices: the same winner and inlier mask; the
    refined Sim3 within 1e-4. ``optimize_sim3`` waits for nothing (the
    RANSACs' batched SVD may: the host reads their result anyway)."""
    from orb_slam3_rgbl_tpu_torch.optim import pnp, sim3
    cam, S12, arrays, draws = _sim3_scene()
    on_card = [a.to(cuda) for a in arrays]
    d_card = draws.to(cuda)
    res_c = sim3.sim3_ransac(*arrays, cam, n_hypotheses=512, draws=draws)
    res_g = sim3.sim3_ransac(*on_card, cam, n_hypotheses=512, draws=d_card)
    assert int(res_g.n_inliers) == int(res_c.n_inliers) >= 200
    assert torch.equal(res_g.inliers.cpu(), res_c.inliers)
    assert (res_g.S12.cpu() - res_c.S12).abs().max() < 1e-4
    p1, p2, uv1, uv2, s1, s2, valid = arrays
    opt_c = sim3.optimize_sim3(res_c.S12, p1, p2, uv1, uv2, 1 / s1, 1 / s2, res_c.inliers, cam)
    g1, g2, gu1, gu2, gs1, gs2, gvalid = on_card
    opt_g = _no_sync(lambda: sim3.optimize_sim3(res_g.S12, g1, g2, gu1, gu2, 1 / gs1, 1 / gs2,
                                                res_g.inliers, cam))
    assert (opt_g[0].cpu() - opt_c[0]).abs().max() < 1e-4
    assert torch.equal(opt_g[1].cpu(), opt_c[1]) and int(opt_g[2]) == int(opt_c[2])
    assert (opt_g[0].cpu() - S12).abs().max() < 0.02
    # rigid PnP: p1 are the camera-frame points, p2 stand in for world landmarks
    pnp_c = pnp.rigid_pnp_ransac(p1, p2, uv1, s1, valid, cam, draws=draws[:256])
    pnp_g = pnp.rigid_pnp_ransac(g1, g2, gu1, gs1, gvalid, cam, draws=d_card[:256])
    assert int(pnp_g.n_inliers) == int(pnp_c.n_inliers) >= 200
    assert torch.equal(pnp_g.inliers.cpu(), pnp_c.inliers)
    assert (pnp_g.Tcw.cpu() - pnp_c.Tcw).abs().max() < 1e-4
    # a tie among hypotheses goes to the first, on the card too
    counts = torch.tensor([3, 9, 9, 2, 9], device=cuda)
    assert int(sim3.first_argmax(counts)) == 1


def test_pose_graph_matches_its_cpu_run(cuda):
    """A 40-node drift ring with a loop edge: 20 iterations on the card
    within 1e-4 of the CPU's, cost lowered, nothing waited for."""
    from orb_slam3_rgbl_tpu_torch.geometry import lie
    from orb_slam3_rgbl_tpu_torch.optim import pose_graph as pg
    K = 40
    step = lie.sim3_exp(torch.tensor([0.0, 0.0, 1.0, 0.0, 0.15, 0.0, 0.0]))
    meas = lie.sim3_mul(step, lie.sim3_exp(torch.tensor([0.02, 0.0, 0.0, 0.0, 0.004, 0.0, 0.0])))
    gt, nodes = [lie.sim3_identity(device="cpu")], [lie.sim3_identity(device="cpu")]
    for _ in range(K - 1):
        gt.append(lie.sim3_mul(step, gt[-1]))
        nodes.append(lie.sim3_mul(meas, nodes[-1]))
    gt, nodes = torch.stack(gt), torch.stack(nodes)
    ei = torch.arange(1, K).tolist() + [K - 1]
    ej = torch.arange(0, K - 1).tolist() + [0]
    Sij = torch.cat([meas.expand(K - 1, 8), pg.relative_sim3(gt, K - 1, 0)[None]])
    problem = pg.PoseGraphProblem(
        nodes=nodes, node_fixed=torch.arange(K) == 0, node_valid=torch.ones(K, dtype=torch.bool),
        edge_i=torch.tensor(ei), edge_j=torch.tensor(ej), edge_Sij=Sij,
        edge_weight=torch.tensor([1.0] * (K - 1) + [10.0]),
        edge_valid=torch.ones(K, dtype=torch.bool))
    on_card = pg.PoseGraphProblem(*(t.to(cuda) for t in problem))
    out_c = pg.optimize_pose_graph(problem, iterations=20, fix_scale=True)
    out_g = _no_sync(lambda: pg.optimize_pose_graph(on_card, iterations=20, fix_scale=True))
    assert (out_g.cpu() - out_c).abs().max() < 1e-4
    assert torch.equal(out_g[0].cpu(), nodes[0])
    assert float(pg.pose_graph_cost(on_card, out_g)) < 0.1 * float(pg.pose_graph_cost(on_card, on_card.nodes))


def _ba_problem(seed=0, K=24, M=4000, D=8):
    """A ring of K cameras looking outwards at M points, each seen by up to
    D cameras with stereo observations; poses and points perturbed."""
    from orb_slam3_rgbl_tpu_torch.geometry import lie
    from orb_slam3_rgbl_tpu_torch.optim.local_ba import BAProblem
    cam = _loop_cam()
    rng = np.random.default_rng(seed)
    th = 2 * np.pi * np.arange(K) / K
    Twc = np.stack([np.cos(th / 2), 0 * th, np.sin(th / 2), 0 * th,
                    6 * (1 - np.cos(th)), 0 * th, 6 * np.sin(th)], axis=1).astype(np.float32)
    Tcw = lie.np_se3_inv(Twc)
    ang = rng.uniform(0, 2 * np.pi, M)
    r = rng.uniform(12, 30, M)
    X = np.stack([6 + r * np.cos(ang), rng.uniform(-3, 1.5, M), r * np.sin(ang)], 1).astype(np.float32)
    obs_kf = np.zeros((M, D), np.int64)
    obs_uv = np.zeros((M, D, 2), np.float32)
    obs_ur = np.full((M, D), -1.0, np.float32)
    obs_mask = np.zeros((M, D), bool)
    for k in range(K):
        pc = lie.np_se3_apply(Tcw[k], X)
        u = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
        v = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
        vis = (pc[:, 2] > 1) & (u > 0) & (u < cam.width) & (v > 0) & (v < cam.height)
        slot = obs_mask.sum(axis=1)
        take = np.nonzero(vis & (slot < D))[0]
        obs_kf[take, slot[take]] = k
        obs_uv[take, slot[take]] = np.stack([u[take], v[take]], 1) + rng.normal(0, 0.5, (len(take), 2))
        obs_ur[take, slot[take]] = u[take] - cam.bf / pc[take, 2]
        obs_mask[take, slot[take]] = True
    poses = Tcw.copy()
    poses[1:, 4:7] += rng.normal(0, 0.05, (K - 1, 3)).astype(np.float32)
    arrays = dict(poses=poses, pose_fixed=np.arange(K) == 0, pose_valid=np.ones(K, bool),
                  landmarks=X + rng.normal(0, 0.1, X.shape).astype(np.float32),
                  lm_valid=obs_mask.sum(axis=1) >= 2, obs_kf=obs_kf, obs_uv=obs_uv, obs_ur=obs_ur,
                  obs_inv_sigma2=np.ones((M, D), np.float32), obs_mask=obs_mask)
    from orb_slam3_rgbl_tpu_torch import convert
    return cam, arrays, convert


def test_global_ba_repeats_to_the_bit_and_matches_its_cpu_run(cuda):
    from orb_slam3_rgbl_tpu_torch.optim import global_ba as gba
    cam, arrays, convert = _ba_problem()
    p_c = convert.ba_problem_from_numpy(arrays, device="cpu")
    p_g = convert.ba_problem_from_numpy(arrays)
    assert p_g.poses.device.type == "cuda" and int(p_c.obs_mask.sum()) > 8000
    seg = gba.PoseSegments(p_g.obs_kf, p_g.obs_mask, p_g.poses.shape[0])
    first = _no_sync(lambda: gba.global_bundle_adjust(p_g, cam, seg, iterations=4, cg_iters=64))
    again = gba.global_bundle_adjust(p_g, cam, seg, iterations=4, cg_iters=64)
    assert torch.equal(first.poses, again.poses) and torch.equal(first.landmarks, again.landmarks)
    assert torch.equal(first.cost, again.cost)
    seg_c = gba.PoseSegments(p_c.obs_kf, p_c.obs_mask, p_c.poses.shape[0])
    on_cpu = gba.global_bundle_adjust(p_c, cam, seg_c, iterations=4, cg_iters=64)
    assert (first.poses.cpu() - on_cpu.poses).abs().max() < 1e-3
    assert (first.landmarks.cpu() - on_cpu.landmarks).abs().median() < 1e-3
    assert float(first.cost) < 0.2 * float(gba.ba_cost(p_g, cam))
    np.testing.assert_allclose(float(first.cost), float(on_cpu.cost), rtol=1e-3)
    assert torch.equal(first.poses[0].cpu(), p_c.poses[0])
    # the segment sums against index_add_, which adds with atomics on the card
    vals = torch.randn(p_g.obs_kf.shape + (6,), device=cuda) * p_g.obs_mask[..., None]
    want = torch.zeros(p_g.poses.shape[0], 6, device=cuda).index_add_(
        0, p_g.obs_kf.reshape(-1), vals.reshape(-1, 6))
    assert (seg.sum(vals) - want).abs().max() < 1e-3
    assert torch.equal(seg.sum(vals), seg.sum(vals))


def test_keyframe_database_lives_on_the_card(cuda):
    from orb_slam3_rgbl_tpu_torch.retrieval.keyframe_db import KeyFrameDatabase
    rng = np.random.default_rng(1)
    desc = rng.integers(0, 2**32, (6, 2000, 8), dtype=np.uint32)
    valid = np.ones(2000, bool)
    db_g, db_c = KeyFrameDatabase(16), KeyFrameDatabase(16, device="cpu")
    for k in range(6):
        db_g.add(k, desc[k], valid)
        db_c.add(k, desc[k], valid)
    assert db_g.vectors.device.type == "cuda"
    ptr = db_g.vectors.data_ptr()
    assert torch.equal(db_g.vectors.cpu(), db_c.vectors)       # integer counts: exact
    s_g, c_g = db_g.query(db_g.vectors[2], np.array([0]))
    s_c, c_c = db_c.query(db_c.vectors[2], np.array([0]))
    np.testing.assert_allclose(s_g, s_c, atol=1e-6)
    np.testing.assert_array_equal(c_g, c_c)
    assert db_g.vectors.data_ptr() == ptr and s_g[2] > 0.999 and s_g[0] == 0
    np.testing.assert_array_equal(
        db_g.detect_relocalization_candidates(desc[3], valid, 5),
        db_c.detect_relocalization_candidates(desc[3], valid, 5))


def _weld_scene(n=300):
    """An archived map and an active map that hold the same ``n`` landmarks
    in two world frames a rigid transform apart, each with one keyframe at
    the same camera; the transform (archived ← active)."""
    from orb_slam3_rgbl_tpu_torch.config import kitti_rgbl_config
    from orb_slam3_rgbl_tpu_torch.geometry import lie
    from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState
    cfg = kitti_rgbl_config()
    cam = cfg.camera
    rng = np.random.default_rng(3)
    X_w2 = np.stack([rng.uniform(-10, 10, n), rng.uniform(-3, 3, n), rng.uniform(8, 40, n)],
                    1).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    a = 0.4
    S_w2_w1 = np.array([np.cos(a / 2), 0, np.sin(a / 2), 0, 1.5, 0.2, -3.0, 1.0], np.float32)
    X_w1 = lie.np_sim3_apply(lie.np_sim3_inv(S_w2_w1), X_w2).astype(np.float32)
    T_c_w2 = lie.np_se3_identity()
    T_c_w1 = lie.np_sim3_to_se3(lie.np_sim3_mul(lie.np_sim3_from_se3(T_c_w2), S_w2_w1))

    def keyframe(m, T, X):
        pc = lie.np_se3_apply(T, X)
        uv = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                       cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], 1).astype(np.float32)
        k = m.add_keyframe(T, uv, np.zeros(n, np.int16), desc, pc[:, 2].astype(np.float32),
                           (uv[:, 0] - cam.bf / pc[:, 2]).astype(np.float32), np.ones(n, bool),
                           np.full(n, -1, np.int32), 0.0, 0)
        m.add_landmarks(X, desc, k, np.arange(n), np.tile([0, 0, 1.0], (n, 1)).astype(np.float32),
                        np.full(n, 80.0, np.float32), np.full(n, 1.0, np.float32))
        return m

    old = keyframe(MapState.create(2, 512, n), T_c_w2, X_w2)
    active = keyframe(MapState.create(2, 512, n, map_id=1), T_c_w1, X_w1)
    return cfg, old, active, S_w2_w1


def test_weld_on_device_backed_state(cuda):
    """``verify_cross_map`` on the card and on the CPU from the same draws,
    then the weld: the archived map grows, the database on the card grows
    and indexes the transported keyframe, the mapping plane's device mirror
    grows on ``reset`` and backfills the welded rows."""
    import copy
    from orb_slam3_rgbl_tpu_torch.geometry import lie
    from orb_slam3_rgbl_tpu_torch.retrieval.keyframe_db import KeyFrameDatabase
    from orb_slam3_rgbl_tpu_torch.slam import map_state as ms, merging
    from orb_slam3_rgbl_tpu_torch.slam.local_mapping import DeviceKfCache
    cfg, old, active, S_true = _weld_scene()
    draws = torch.randint(0, 300, (512, 3), generator=torch.Generator().manual_seed(0))
    out_c = merging.verify_cross_map(cfg, active, 0, old, 0, True, draws=draws, device="cpu")
    out_g = merging.verify_cross_map(cfg, active, 0, old, 0, True, draws=draws.to(cuda),
                                     device=cuda)
    (S_c, n_c, (a_c, b_c)), (S_g, n_g, (a_g, b_g)) = out_c, out_g
    assert n_g == n_c >= 290 and (S_g[7], S_c[7]) == (1.0, 1.0)
    np.testing.assert_allclose(S_g, S_c, atol=1e-4)
    np.testing.assert_array_equal(a_g, a_c)
    np.testing.assert_array_equal(b_g, b_c)
    S_w2_w1 = merging.world_alignment(S_g, active.kf_pose[0], old.kf_pose[0])
    np.testing.assert_allclose(lie.np_sim3_apply(S_w2_w1, np.eye(3, dtype=np.float32)),
                               lie.np_sim3_apply(S_true, np.eye(3, dtype=np.float32)), atol=1e-3)
    db_g, db_c = KeyFrameDatabase(1, device=cuda), KeyFrameDatabase(1, device="cpu")
    for db in (db_g, db_c):
        db.add(0, old.kf_desc[0], old.kf_feat_valid[0])
    cache = DeviceKfCache(old.n_features, cap=1, device=cuda)
    cache.ensure(old, [0])
    old_c = copy.deepcopy({f: getattr(old, f) for f in ("kf_lm_idx", "lm_pos")})
    res = merging.merge_maps(old, active, 0, S_w2_w1)
    fuse = merging.apply_fusion(res.map, res.lm_remap[a_g], b_g)
    assert res.map.capacity_kf == 2 and res.map.n_kf == 2 and res.kf_cur_new == 1
    np.testing.assert_array_equal(res.map.kf_lm_idx[0], old_c["kf_lm_idx"][0])
    assert (res.map.kf_lm_idx[1] == res.map.kf_lm_idx[0]).mean() >= 290 / 300
    assert not res.map.lm_valid[res.lm_remap[a_g]].any() and (fuse[res.lm_remap[a_g]] == b_g).all()
    assert ms.check_binding_consistency(res.map) == []
    np.testing.assert_allclose(res.map.kf_pose[1, 4:7], old.kf_pose[0, 4:7], atol=1e-3)
    for db in (db_g, db_c):
        db.grow(res.map.capacity_kf)
        for k in res.appended_kfs:
            db.add(int(k), res.map.kf_desc[k], res.map.kf_feat_valid[k])
    assert db_g.vectors.device.type == "cuda" and db_g.vectors.shape[0] == 2
    assert torch.equal(db_g.vectors.cpu(), db_c.vectors) and db_g.present.all()
    s_g, _ = db_g.query(db_g.vectors[1], np.array([1]))
    assert s_g[0] > 0.999                        # the same place, the same words
    cache.reset(res.map.capacity_kf)
    assert cache.cap >= 2 and not cache.have and cache.d_uv.device.type == "cuda"
    cache.ensure(res.map, res.map.valid_kf_ids())
    np.testing.assert_array_equal(cache.d_uv[1].cpu().numpy(), res.map.kf_uv[1])
    np.testing.assert_array_equal(cache.d_desc[1].cpu().numpy().view(np.uint32), res.map.kf_desc[1])


def test_tree_vocabulary_on_the_card(cuda):
    """``words`` exact and ``bow`` within 1e-6 of the CPU's; a database
    with the vocabulary grows on the card."""
    from orb_slam3_rgbl_tpu_torch.retrieval import tree_vocab
    from orb_slam3_rgbl_tpu_torch.retrieval.keyframe_db import KeyFrameDatabase
    rng = np.random.default_rng(2)
    train = rng.integers(0, 2 ** 32, (3000, 8), dtype=np.uint32)
    docs = [train[i::4] for i in range(4)]
    voc_c = tree_vocab.train_vocabulary(train, k=8, depth=3, seed=0, idf_docs=docs, device="cpu")
    voc_g = tree_vocab.train_vocabulary(train, k=8, depth=3, seed=0, idf_docs=docs)
    assert voc_g.device.type == "cuda" and voc_g.checksum() == voc_c.checksum()
    assert torch.equal(voc_g.idf.cpu(), voc_c.idf)
    desc = torch.from_numpy(rng.integers(0, 2 ** 32, (2000, 8), dtype=np.uint32).view(np.int32))
    valid = torch.from_numpy(rng.random(2000) < 0.9)
    d_g, v_g = desc.to(cuda), valid.to(cuda)
    w_g = _no_sync(lambda: voc_g.words(d_g))
    assert torch.equal(w_g.cpu(), voc_c.words(desc))
    b_g = _no_sync(lambda: voc_g.bow(d_g, v_g))
    assert (b_g.cpu() - voc_c.bow(desc, valid)).abs().max() <= 1e-6
    db = KeyFrameDatabase(2, vocabulary=voc_g)
    db.add(1, desc.numpy(), valid.numpy())
    db.grow(5)
    assert db.vectors.shape == (5, 512) and db.vectors.device.type == "cuda"
    assert torch.equal(db.vectors[1], b_g) and db.present.tolist() == [False, True] + [False] * 3


def test_async_drive_runs_each_plane_on_its_own_stream(cuda):
    """``async_mapping = True`` on the card (the 320×192 canyon, mapping and
    loop closing on): mapping jobs and detections run on their threads and
    on streams other than the tracking thread's, every frame is OK, and what
    the workers wrote on their streams is what the tracking thread reads: the
    database rows against a recomputation, the keyframe mirror against the
    host map."""
    import threading
    from orb_slam3_rgbl_tpu_torch import synthetic as syn
    from orb_slam3_rgbl_tpu_torch.slam import map_state as map_mod, tracking as trk
    from orb_slam3_rgbl_tpu_torch.slam.local_mapping import LocalMapper
    from orb_slam3_rgbl_tpu_torch.slam.loop_closing import LoopCloser
    from orb_slam3_rgbl_tpu_torch.slam.system import System

    cfg = syn.synthetic_rgbl_config()
    cam = cfg.camera
    world = syn.make_world(0, tex_size=256, device=cuda)
    traj = syn.straight_trajectory(16, step=0.6, weave=0.4)
    seen = {"mapping": [], "loop": []}
    process, detect = LocalMapper.process_keyframe, LoopCloser.detect_only

    def on_mapping(self, *a, **k):
        seen["mapping"].append((threading.current_thread().name, torch.cuda.current_stream()))
        return process(self, *a, **k)

    def on_loop(self, *a, **k):
        seen["loop"].append((threading.current_thread().name, torch.cuda.current_stream()))
        return detect(self, *a, **k)

    sysm = System(cfg)
    sysm.CLOUD_CAP = 16384
    sysm.async_mapping = True
    tracker_stream = torch.cuda.current_stream()
    LocalMapper.process_keyframe, LoopCloser.detect_only = on_mapping, on_loop
    try:
        states = []
        for i, Twc in enumerate(traj):
            img = syn.render_image(world, Twc, cam.fx, cam.fy, cam.cx, cam.cy, cam.height,
                                   cam.width)
            pts = syn.lidar_scan(world, Twc, n_az=256, n_el=48)
            states.append(sysm.track_rgbl(img, pts, i * 0.1).state)
        sysm.shutdown()
    finally:
        LocalMapper.process_keyframe, LoopCloser.detect_only = process, detect
    assert all(s == trk.OK for s in states), states
    assert sysm.worker_errors == [] and map_mod.check_binding_consistency(sysm.map) == []
    assert seen["mapping"] and seen["loop"]
    for plane, calls in seen.items():
        assert {name for name, _ in calls} == {f"{plane}_0"}, calls
        assert all(s != tracker_stream for _, s in calls), plane
    assert seen["mapping"][0][1] != seen["loop"][0][1]
    m, db = sysm.map, sysm.loop_closer.db
    live = m.valid_kf_ids()
    assert db.present[live].all()
    for k in live:
        fresh = db._bow(m.kf_desc[k], m.kf_feat_valid[k])
        assert (db.vectors[k] - fresh).abs().max().item() <= 1e-6, k
    rows = sysm.mapper.dev_cache.ensure(m, live)
    for k in live:
        np.testing.assert_array_equal(rows.d_uv[k].cpu().numpy(), m.kf_uv[k])
        np.testing.assert_array_equal(rows.d_desc[k].cpu().numpy().view(np.uint32), m.kf_desc[k])


def test_kf_cache_grows_while_a_worker_gathers(cuda):
    """``DeviceKfCache`` grows (2 → 128 rows) on the tracking thread while a
    worker gathers rows on its own stream, and freed blocks are handed out
    again at once: no gathered row and no final row differs from the CPU
    copy."""
    import threading
    from orb_slam3_rgbl_tpu_torch.slam.local_mapping import DeviceKfCache

    rng = np.random.default_rng(7)
    n, N = 128, 512
    uv = rng.uniform(0, 1000, (n, N, 2)).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (n, N, 8), dtype=np.uint32)
    feats = [type("F", (), dict(uv=uv[k], desc=desc[k], octave=np.full(N, k % 8, np.int32),
                                angle=np.zeros(N, np.float32), valid=np.ones(N, bool),
                                u_right=np.full(N, -1.0, np.float32))) for k in range(n)]
    expect = torch.as_tensor(desc.view(np.int32), device=cuda)
    cache = DeviceKfCache(N, cap=2, device=cuda)
    for k in range(2):
        cache.add(k, feats[k])
    added, stop = [2], threading.Event()
    bad = torch.zeros((), dtype=torch.int64, device=cuda)
    gathers = [0]

    def worker():
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            while not stop.is_set():
                ids = torch.arange(max(0, added[0] - 8), added[0], device=cuda)
                rows = cache.ensure(None, ids.tolist())
                bad.add_((rows.d_desc[ids] != expect[ids]).sum())
                gathers[0] += 1
            stream.synchronize()

    thread = threading.Thread(target=worker)
    thread.start()
    try:
        for k in range(2, n):
            cache.add(k, feats[k])
            added[0] = k + 1
            # recycle whatever the growth freed, with garbage
            torch.full((cache.cap, N, 8), -1, dtype=torch.int32, device=cuda)
    finally:
        stop.set()
        thread.join(60.0)
    assert not thread.is_alive()
    torch.cuda.synchronize()
    assert cache.cap == n and gathers[0] > 0
    assert int(bad) == 0
    assert torch.equal(cache.d_desc.cpu(), torch.from_numpy(desc.view(np.int32)))
    assert torch.equal(cache.d_uv.cpu(), torch.from_numpy(uv))
