"""The CUDA kernels K1, K2 and K3 against their plain versions, the loop-closing
plane's solvers, the atlas weld, the tree vocabulary, the RGB-D fused step,
keypoint undistortion, stereo matching and refinement, the two-view solve and
the monocular fused step, K1 and K2 at the EuRoC camera's 752×480 and at
TUM-VI's 512×512, the IMU preintegration, the visual-inertial solvers and
the KannalaBrandt8 pose solve and local BA against their CPU runs, and the
landmark-sharded global BA over NCCL (one rank) and gloo (two ranks sharing
the card), and the global BA's CG-step kernels (``csrc/gba.cu``) against their
plain versions, on the card. Marked ``gpu``; without a card each test skips
from its fixture.

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


@pytest.mark.parametrize("h, w", [(4, 4), (93, 171), (128, 256), (105, 346), (376, 1241),
                                  (480, 752)])
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
    "euroc8": pyr_ops.level_sizes(480, 752, 8, 1.2),
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


def _hv_operands(device, M, D, live, K=48, seed=0):
    """Operands of one linearization at a given share of live slots (w > 0),
    beside slots in the pose table with w = 0 and slots masked out of it. Every
    slot with w = 0 carries large finite Jacobians (1e30): they must add
    nothing. Every 7th landmark is not free."""
    g = torch.Generator().manual_seed(seed)
    live_s = torch.rand(M, D, generator=g) < live
    held = live_s | (torch.rand(M, D, generator=g) < 0.1)
    w = torch.where(live_s, torch.rand(M, D, generator=g) * 4 + 0.1, 0.0)
    Jp = torch.randn(M, D, 3, 6, generator=g) * 50
    Jl = torch.randn(M, D, 3, 3, generator=g) * 50
    Jp[~live_s], Jl[~live_s] = 1e30, -1e30
    obs_kf = torch.randint(0, K, (M, D), generator=g)
    lam_l = torch.rand(M, 3, generator=g)
    lm_free = (torch.arange(M) % 7 != 3)[:, None]
    v_p = torch.randn(K, 6, generator=g)
    v_l = torch.randn(M, 3, generator=g)
    on = [t.to(device) for t in (Jp, Jl, w, obs_kf, lam_l, lm_free, v_p, v_l, held)]
    return on, live_s.to(device)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("M, D, live", [(131_101, 8, 0.32), (32_771, 8, 0.72), (10_001, 5, 0.5),
                                        (3_001, 65, 0.5), (20_000, 1, 0.9)],
                         ids=["kitti_like", "euroc_like", "d5", "d65_unaligned", "d1"])
def test_gba_cg_kernels_match_plain_versions(cuda, M, D, live):
    """H·v (this rank's pose sums, the landmark half, its dot share) and the
    block-Jacobi apply against the plain versions on the card: 1e-5 of the
    largest value; masked slots' Jacobians not read; two calls the same bits;
    each call one launch of each kernel."""
    from orb_slam3_rgbl_tpu_torch.ops import gba_cuda
    from orb_slam3_rgbl_tpu_torch.optim import global_ba as gba

    (Jp, Jl, w, obs_kf, lam_l, lm_free, v_p, v_l, held), live_s = _hv_operands(cuda, M, D, live)
    K = v_p.shape[0]
    seg = gba.PoseSegments(obs_kf, held, K)
    hv = gba_cuda.HessianProduct(Jp, Jl, w, obs_kf, seg, lam_l, lm_free)
    counts = cuda_build.launch_counts
    before = (counts["gba_hv"], counts["gba_pose_sum"])
    got = hv(v_p, v_l)
    torch.cuda.synchronize()
    assert (counts["gba_hv"], counts["gba_pose_sum"]) == (before[0] + 1, before[1] + 1)
    want = gba_cuda.hv_plain(Jp, Jl, w, obs_kf, seg, v_p, v_l, lam_l, lm_free)
    assert all(torch.isfinite(t).all() for t in want)
    for a, b in zip(got[:2], want[:2]):
        assert a.shape == b.shape and _rel(a, b) <= 1e-5, _rel(a, b)
    # the dot share, a sum of 3M terms of both signs: against the sum of their sizes
    scale = float((v_l * want[1]).abs().sum())
    assert got[2].shape == () and abs(float(got[2]) - float(want[2])) <= 1e-5 * scale
    assert not got[1][~lm_free[:, 0]].any()
    again = hv(v_p, v_l)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the masked slots' Jacobians are never read: zeroing them changes no bit
    Jp0 = torch.where(live_s[..., None, None], Jp, 0.0)
    Jl0 = torch.where(live_s[..., None, None], Jl, 0.0)
    zeroed = gba_cuda.HessianProduct(Jp0, Jl0, w, obs_kf, seg, lam_l, lm_free)(v_p, v_l)
    assert all(torch.equal(a, b) for a, b in zip(got, zeroed))

    g = torch.Generator().manual_seed(M)
    Minv_p = torch.randn(K, 6, 6, generator=g).to(cuda)
    Minv_l = torch.randn(M, 3, 3, generator=g).to(cuda)
    pose_free = (torch.arange(K, device=cuda) % 5 != 0)[:, None]
    bj = gba_cuda.BlockJacobi(Minv_p, Minv_l, pose_free, lm_free)
    before = counts["gba_cg_update"]
    z = bj(v_p, v_l)
    torch.cuda.synchronize()
    assert counts["gba_cg_update"] == before + 1
    for a, b in zip(z, gba_cuda.precond_plain(Minv_p, Minv_l, v_p, v_l, pose_free, lm_free)):
        assert _rel(a, b) <= 1e-5, _rel(a, b)
    assert all(torch.equal(a, b) for a, b in zip(z, bj(v_p, v_l)))

    # the step's fused updates: the separate PyTorch operations' bits
    rz, pAp, rz_new = (torch.rand((), generator=g).to(cuda) + 0.5 for _ in range(3))
    x, rr, p, Ap = ((torch.randn(K, 6, generator=g).to(cuda),
                     torch.randn(M, 3, generator=g).to(cuda)) for _ in range(4))
    before = (counts["gba_cg_update"], counts["gba_cg_direction"])
    xo, ro, zo = bj.update(rz, pAp, x, rr, p, Ap)
    po = gba_cuda.cg_direction(rz_new, rz, zo, p)
    torch.cuda.synchronize()
    assert (counts["gba_cg_update"], counts["gba_cg_direction"]) == (before[0] + 1, before[1] + 1)
    xw, rw, zw = gba_cuda.cg_update_plain(bj, rz, pAp, x, rr, p, Ap)
    pw = gba_cuda.cg_direction_plain(rz_new, rz, zo, p)
    for got_, want_ in ((xo, xw), (ro, rw), (zo, zw), (po, pw)):
        assert all(torch.equal(a, b) for a, b in zip(got_, want_))
    # a pAp below the clamp and a NaN take PyTorch's clamp_min
    for odd in (torch.zeros((), device=cuda), torch.full((), float("nan"), device=cuda)):
        got_ = bj.update(rz, odd, x, rr, p, Ap)
        want_ = gba_cuda.cg_update_plain(bj, rz, odd, x, rr, p, Ap)
        assert all(torch.equal(a, b) or (a.isnan() == b.isnan()).all()
                   for pair_g, pair_w in zip(got_, want_) for a, b in zip(pair_g, pair_w))


def test_gba_cg_wrappers_reject_bad_inputs(cuda):
    from orb_slam3_rgbl_tpu_torch.ops import gba_cuda
    from orb_slam3_rgbl_tpu_torch.optim import global_ba as gba

    (Jp, Jl, w, obs_kf, lam_l, lm_free, v_p, v_l, held), _ = _hv_operands(cuda, 100, 8, 0.5)
    seg = gba.PoseSegments(obs_kf, held, v_p.shape[0])
    args = [Jp, Jl, w, obs_kf, seg, lam_l, lm_free]
    for i, bad in ((0, Jp.double()), (1, Jl.transpose(-1, -2)), (2, w[:50]), (3, obs_kf.int()),
                   (5, lam_l.cpu()), (6, lm_free.float())):
        with pytest.raises(ValueError):
            gba_cuda.HessianProduct(*args[:i], bad, *args[i + 1:])
    seg_other = gba.PoseSegments(obs_kf[:50], held[:50], v_p.shape[0])
    with pytest.raises(ValueError):
        gba_cuda.HessianProduct(Jp, Jl, w, obs_kf, seg_other, lam_l, lm_free)
    hv = gba_cuda.HessianProduct(*args)
    for bad_p, bad_l in ((v_p.cpu(), v_l), (v_p, v_l.double()), (v_p[:, :3], v_l)):
        with pytest.raises(ValueError):
            hv(bad_p, bad_l)
    Minv_l = torch.linalg.inv_ex(torch.eye(3, device=cuda).expand(100, 3, 3) * 2)[0]
    eye6 = torch.eye(6, device=cuda).repeat(48, 1, 1)
    pose_free = torch.ones(48, 1, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):         # inv_ex's column-major blocks
        gba_cuda.BlockJacobi(eye6, Minv_l.mT.contiguous().mT, pose_free, lm_free)
    bj = gba_cuda.BlockJacobi(eye6, Minv_l.contiguous(), pose_free, lm_free)
    one = torch.ones((), device=cuda)
    pair = (v_p, v_l)
    for bad in ((v_p, v_l[:99]), (v_p.double(), v_l), (v_p.t().contiguous().t(), v_l)):
        with pytest.raises(ValueError):
            bj.update(one, one, pair, bad, pair, pair)
        with pytest.raises(ValueError):
            gba_cuda.cg_direction(one, one, pair, bad)
    with pytest.raises(ValueError):
        bj.update(one, torch.ones(2, device=cuda), pair, pair, pair, pair)
    with pytest.raises(ValueError):
        gba_cuda.cg_direction(one.cpu(), one, pair, pair)


def test_global_ba_launches_each_cg_kernel_once_a_cg_step(cuda):
    """A whole solve on the card: one launch each of ``gba_hv``,
    ``gba_pose_sum``, ``gba_cg_update`` and ``gba_cg_direction`` a CG step,
    one more ``gba_cg_update`` a linearization (the PCG set-up's apply), no
    wait for the device, and the same bits twice."""
    from orb_slam3_rgbl_tpu_torch.optim import global_ba as gba
    cam, arrays, convert = _ba_problem(seed=3)
    p_g = convert.ba_problem_from_numpy(arrays)
    seg = gba.PoseSegments(p_g.obs_kf, p_g.obs_mask, p_g.poses.shape[0])
    its, cg = 3, 20
    counts = cuda_build.launch_counts
    names = ("gba_hv", "gba_pose_sum", "gba_cg_update", "gba_cg_direction")
    before = {k: counts[k] for k in names}
    first = _no_sync(lambda: gba.global_bundle_adjust(p_g, cam, seg, iterations=its, cg_iters=cg))
    torch.cuda.synchronize()
    assert {k: counts[k] - before[k] for k in names} == dict(
        gba_hv=its * cg, gba_pose_sum=its * cg, gba_cg_update=its * (cg + 1),
        gba_cg_direction=its * cg)
    again = gba.global_bundle_adjust(p_g, cam, seg, iterations=its, cg_iters=cg)
    for f in ("poses", "landmarks", "obs_inlier", "cost"):
        assert torch.equal(getattr(first, f), getattr(again, f)), f
    assert float(first.cost) < 0.5 * float(gba.ba_cost(p_g, cam))


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


def _rgbd_frames(n=2):
    """The 320×192 canyon's first frames and their dense depth images
    (InverseDilation of the LiDAR sweep), made on the CPU."""
    from orb_slam3_rgbl_tpu_torch import synthetic as syn
    from orb_slam3_rgbl_tpu_torch.ops import depth as depth_ops
    from orb_slam3_rgbl_tpu_torch.slam.compiled import lidar_projection

    cfg = syn.synthetic_rgbl_config()
    cam, lc = cfg.camera, cfg.lidar
    cpu = torch.device("cpu")
    world = syn.make_world(0, tex_size=256, device=cpu)
    P = lidar_projection(cfg, cpu)
    out = []
    for Twc in syn.straight_trajectory(n, step=0.6, weave=0.4):
        img = syn.render_image(world, Twc, cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width)
        pts = syn.lidar_scan(world, Twc, n_az=256, n_el=48)
        kp = torch.zeros((1, 2))
        _, _, dense = depth_ops.compute_depth_from_pointcloud(
            pts, P, kp, kp, height=cam.height, width=cam.width, bf=cam.bf,
            min_dist=lc.min_dist, max_dist=lc.max_dist)
        out.append((img.numpy(), dense.numpy()))
    return cfg, out


def test_rgbd_fused_step_matches_its_cpu_run(cuda):
    """The fused step in 'rgbd' mode (K1 and K2 on the card) against the
    same step on the CPU, from the same tracker state: keypoints where both
    put them get the same depth; inliers within 5%, pose within 1e-3."""
    import dataclasses
    from orb_slam3_rgbl_tpu_torch.config import RGBD
    from orb_slam3_rgbl_tpu_torch.slam.fast_path import FastPath
    from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState
    from orb_slam3_rgbl_tpu_torch.slam.tracking import Tracker

    cfg, frames = _rgbd_frames()
    cfg = dataclasses.replace(cfg, sensor=RGBD)
    n_feat = 600
    cuda_build.reset_launch_counts()
    outs = {}
    for dev in (torch.device("cpu"), cuda):
        t = Tracker(cfg, MapState.create(16, 8192, n_feat), device=dev)
        t.fast = FastPath(cfg, n_feat, mode="rgbd", device=dev)
        t.track_image_rgbd(frames[0][0], frames[0][1], 0.0)
        t.fast.sync(t.map, t.ref_kf, t.last_feats, t.last_lm_idx, t.last_lm_gen)
        outs[dev.type] = t.fast.run(frames[1][0], frames[1][1], None,
                                    np.array([1, 0, 0, 0, 0, 0, 0], np.float32))
    assert cuda_build.launch_counts["fast_and_blur"] == 2       # frame 0 and the step
    c, g = outs["cpu"], outs["cuda"]
    same = (g.feats.uv.cpu() == c.feats.uv).all(1)
    assert same.float().mean() >= 0.99
    assert torch.equal(g.feats.depth.cpu()[same], c.feats.depth[same])
    assert abs(int(g.n_inliers) - int(c.n_inliers)) <= 0.05 * int(c.n_inliers)
    assert (g.Tcw.cpu() - c.Tcw).abs().max() < 1e-3


def test_undistort_points_on_the_card(cuda):
    from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera, undistort_points

    cam = PinholeCamera(fx=458.654, fy=457.296, cx=367.215, cy=248.375, k1=-0.28340811,
                        k2=0.07395907, p1=0.00019359, p2=1.76187114e-05, k3=0.01,
                        width=752, height=480)
    rng = np.random.default_rng(0)
    uv = np.stack([rng.uniform(0, 752, 4000), rng.uniform(0, 480, 4000)], 1).astype(np.float32)
    g = undistort_points(cam, torch.from_numpy(uv).to(cuda))
    assert g.device.type == "cuda"
    # the card may contract multiply-adds the CPU rounds apart: the CPU
    # tests' bar against JAX (tests/test_torch_config.py)
    assert (g.cpu() - undistort_points(cam, torch.from_numpy(uv))).abs().max() < 3e-4


def _stereo_pair():
    """The 320×192 canyon's first frame and its right image (the left pose
    moved by bf / fx along the camera's x axis), rounded as an 8-bit camera
    gives them, made on the CPU."""
    from orb_slam3_rgbl_tpu_torch import synthetic as syn
    from orb_slam3_rgbl_tpu_torch.geometry import lie

    cfg = syn.synthetic_rgbl_config()
    cam = cfg.camera
    world = syn.make_world(0, tex_size=256, device=torch.device("cpu"))
    Twc = syn.straight_trajectory(1, step=0.6, weave=0.4)[0].astype(np.float32)
    Twc_r = Twc.copy()
    Twc_r[4:7] += lie.np_quat_rotate(Twc[:4], np.array([cam.bf / cam.fx, 0, 0], np.float32))
    return cfg, [torch.round(syn.render_image(world, T, cam.fx, cam.fy, cam.cx, cam.cy,
                                              cam.height, cam.width)) for T in (Twc, Twc_r)]


def test_stereo_matching_and_refinement_match_their_cpu_run(cuda):
    """Row matching, stereo depth and the SAD refinement of the same
    features on the card and on the CPU: matches, SAD tables and accepted
    refinements equal (integer distances and sums), columns within 1e-4."""
    from orb_slam3_rgbl_tpu_torch.slam import compiled, frame

    cfg, (left, right) = _stereo_pair()
    o, bf = cfg.orb, cfg.camera.bf
    fl, fr = (compiled.extract(cfg, im, torch.device("cpu")) for im in (left, right))
    out = {}
    for dev in (torch.device("cpu"), cuda):
        to = [type(fl)(*(x.to(dev) for x in f)) for f in (fl, fr)]
        f = frame.attach_stereo_depth(*to, bf, max_disp=bf / 0.5, n_levels=o.n_levels,
                                      scale_factor=o.scale_factor)
        table, _ = frame.stereo_sad_table(f, left.to(dev), right.to(dev))
        r = frame.refine_stereo_subpixel(f, left.to(dev), right.to(dev), bf)
        out[dev.type] = (f, table, r)
    (fc, tc, rc), (fg, tg, rg) = out["cpu"], out["cuda"]
    assert fg.depth.device.type == "cuda" and int((fc.u_right >= 0).sum()) > 100
    assert torch.equal(fg.u_right.cpu(), fc.u_right)
    has = fc.u_right >= 0
    assert torch.equal(tg.cpu()[has], tc[has])
    assert torch.equal(rg.u_right.cpu() != fc.u_right, rc.u_right != fc.u_right)
    assert (rg.u_right.cpu() - rc.u_right).abs().max() < 1e-4


def test_two_view_solve_matches_its_cpu_run(cuda):
    """``reconstruct_two_views`` on the same matches and draws on the card
    and on the CPU: the same decision, T21 within 1e-3, ≥ 99% of is_good."""
    from orb_slam3_rgbl_tpu_torch.config import kitti_rgbl_config
    from orb_slam3_rgbl_tpu_torch.geometry import lie, two_view

    cam = kitti_rgbl_config().camera
    rng = np.random.default_rng(0)
    n = 300
    X = np.stack([rng.uniform(-20, 20, n), rng.uniform(-6, 6, n), rng.uniform(10, 60, n)],
                 1).astype(np.float32)
    T21 = torch.cat([lie.so3_exp(torch.tensor([0.0, 0.02, 0.0])), torch.tensor([-0.9, 0.0, 0.0])])
    X2 = lie.se3_apply(T21, torch.from_numpy(X)).numpy()

    def proj(p):
        return np.stack([cam.fx * p[:, 0] / p[:, 2] + cam.cx,
                         cam.fy * p[:, 1] / p[:, 2] + cam.cy], 1) + rng.normal(0, 0.3, (n, 2))

    uv1, uv2 = (torch.from_numpy(proj(p).astype(np.float32)) for p in (X, X2))
    draws = two_view.two_view_draws(n, torch.Generator().manual_seed(3))
    res = {dev.type: two_view.reconstruct_two_views(
        uv1.to(dev), uv2.to(dev), torch.ones(n, dtype=torch.bool, device=dev), cam, draws=draws)
        for dev in (torch.device("cpu"), cuda)}
    c, g = res["cpu"], res["cuda"]
    assert bool(c.success) and bool(g.success) and g.T21.device.type == "cuda"
    assert (g.T21.cpu() - c.T21).abs().max() < 1e-3
    assert (g.is_good.cpu() == c.is_good).float().mean() >= 0.99


def test_mono_fused_step_matches_its_cpu_run(cuda):
    """The fused step in 'mono' mode (K1 and K2 on the card, no depth) against
    the same step on the CPU, from one tracker state initialized on the CPU:
    ≥ 99% of keypoints where both put them, no depth, inliers within 5%,
    pose within 1e-3 (map units of unit median depth)."""
    import dataclasses
    from orb_slam3_rgbl_tpu_torch import synthetic as syn
    from orb_slam3_rgbl_tpu_torch.config import MONOCULAR
    from orb_slam3_rgbl_tpu_torch.slam.fast_path import FastPath
    from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState
    from orb_slam3_rgbl_tpu_torch.slam.tracking import OK, Tracker

    cfg = dataclasses.replace(syn.synthetic_rgbl_config(), sensor=MONOCULAR)
    cam = cfg.camera
    cpu = torch.device("cpu")
    world = syn.make_world(0, tex_size=256, device=cpu)
    imgs = [syn.render_image(world, T, cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width)
            for T in syn.straight_trajectory(12, step=0.5, weave=1.2)]
    t = Tracker(cfg, MapState.create(16, 8192, 600), device=cpu)
    t.init_generator = torch.Generator().manual_seed(21)
    i = 0
    while t.state != OK:
        assert i < 10, "no monocular initialization on the CPU"
        t.track_image_mono(imgs[i], i * 0.1)
        i += 1
    pred = t._predict_pose()
    cuda_build.reset_launch_counts()
    outs = {}
    for dev in (cpu, cuda):
        fp = FastPath(cfg, 600, mode="mono", device=dev)
        fp.sync(t.map, t.ref_kf, t.last_feats, t.last_lm_idx, t.last_lm_gen)
        outs[dev.type] = fp.run(imgs[i], imgs[i], None, pred)
    assert cuda_build.launch_counts["fast_and_blur"] == 1
    c, g = outs["cpu"], outs["cuda"]
    assert g.Tcw.device.type == "cuda" and int(c.n_inliers) >= 30
    same = (g.feats.uv.cpu() == c.feats.uv).all(1)
    assert same.float().mean() >= 0.99
    assert (g.feats.depth == -1).all() and (g.feats.u_right == -1).all()
    assert abs(int(g.n_inliers) - int(c.n_inliers)) <= 0.05 * int(c.n_inliers)
    assert (g.Tcw.cpu() - c.Tcw).abs().max() < 1e-3


def _k1_k2_at(cuda, h: int, w: int, n: int):
    """K1's one launch over the 8 levels of scale 1.2 of an (h, w) frame
    (scores and composite) and K2 on n keypoints of its composite, equal to
    their plain versions."""
    rng = np.random.default_rng(w)
    img = torch.tensor(np.round(rng.uniform(0, 255, (h, w))), dtype=torch.float32, device=cuda)
    levels = [lv.contiguous() for lv in pyr_ops.build_pyramid(img, h, w, 8, 1.2)]
    scores, _, comp, offs = frontend_cuda.fast_and_blur_levels(levels)
    scores_p, _, comp_p, offs_p = frontend_cuda.fast_and_blur_levels_plain(levels)
    torch.cuda.synchronize()
    assert offs == offs_p and torch.equal(comp, comp_p)
    for a, b in zip(scores, scores_p):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    Hc, Wc = comp.shape
    uv = torch.tensor(np.stack([rng.integers(19, Wc - 160, n), rng.integers(19, Hc - 28, n)], 1),
                      dtype=torch.int32, device=cuda)
    ang = torch.tensor(rng.uniform(-np.pi, np.pi, n), dtype=torch.float32, device=cuda)
    corners = (uv - brief_cuda.HALF).contiguous()
    d = brief_cuda.brief_continuous(comp, corners, ang)
    assert torch.equal(d, brief_cuda.brief_continuous_plain(
        comp, corners, brief_cuda.continuous_index_tables(ang)))


def test_k1_k2_at_euroc_width(cuda):
    """The EuRoC camera's 752×480 and 1,200 keypoints."""
    _k1_k2_at(cuda, 480, 752, 1200)


def test_k1_k2_at_tum_vi_width(cuda):
    """TUM-VI's square 512×512 fisheye (levels 512 … 143) and 1,000
    keypoints."""
    _k1_k2_at(cuda, 512, 512, 1000)


def test_kb8_pose_solve_and_local_ba_on_the_card_without_a_wait(cuda):
    """``pose_optimize`` and ``bundle_adjust`` with a KannalaBrandt8 camera
    on the card, every wait for the device an error, within 1e-4 of their
    CPU runs with the same inlier masks."""
    from orb_slam3_rgbl_tpu_torch.geometry import camera as cam_mod, lie
    from orb_slam3_rgbl_tpu_torch.optim import local_ba, pose_opt

    cam = cam_mod.KannalaBrandt8Camera(fx=190.978, fy=190.973, cx=254.932, cy=256.897,
                                       k0=0.00348, k1=0.000715, k2=-0.0020532, k3=0.000202,
                                       width=512, height=512, bf=19.29)
    rng = np.random.default_rng(8)
    K, M = 6, 200
    X = np.stack([rng.uniform(-3, 3, M), rng.uniform(-2, 1.5, M), rng.uniform(1, 6, M)], 1)
    poses = np.zeros((K, 7), np.float32)
    poses[:, 0] = 1.0
    poses[:, 4] = -0.2 * np.arange(K)
    obs_kf = np.tile(np.arange(K), (M, 1))
    pc = lie.np_se3_apply(poses[obs_kf], X[:, None, :].astype(np.float32))
    uv = cam_mod.np_geo_project(cam, pc) + rng.normal(0, 0.5, (M, K, 2))
    start = poses.copy()
    start[2:, 4:] += rng.normal(0, 0.03, (K - 2, 3))
    f = np.float32
    arrays = dict(poses=start, pose_fixed=np.arange(K) < 2, pose_valid=np.ones(K, bool),
                  landmarks=(X + rng.normal(0, 0.05, X.shape)).astype(f),
                  lm_valid=np.ones(M, bool), obs_kf=obs_kf, obs_uv=uv.astype(f),
                  obs_ur=np.full((M, K), 5.0, f), obs_inv_sigma2=np.ones((M, K), f),
                  obs_mask=np.ones((M, K), bool))
    out = {}
    for dev in (torch.device("cpu"), cuda):
        t = lambda a, dt=None: torch.tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
        obs = pose_opt.PoseObs(t(X, torch.float32), t(uv[:, 3], torch.float32),
                               t(np.full(M, 5.0), torch.float32), t(np.ones(M), torch.float32),
                               t(np.ones(M, bool)))
        problem = local_ba.BAProblem(**{k: t(v, torch.int64 if k == "obs_kf" else None)
                                        for k, v in arrays.items()})
        T0 = t(start[3])
        run = lambda: (  # noqa: E731
            pose_opt.pose_optimize(T0, obs, cam),
            local_ba.bundle_adjust(problem, cam, iterations=10))
        out[dev.type] = _no_sync(run) if dev.type == "cuda" else run()
    (pose_c, ba_c), (pose_g, ba_g) = out["cpu"], out["cuda"]
    assert float((pose_c.Tcw - pose_g.Tcw.cpu()).abs().max()) < 1e-4
    assert torch.equal(pose_c.inliers, pose_g.inliers.cpu())
    assert float((pose_c.Tcw[4:] - torch.tensor(poses[3, 4:])).abs().max()) < 0.02
    assert float((ba_c.poses - ba_g.poses.cpu()).abs().max()) < 1e-4
    assert float((ba_c.landmarks - ba_g.landmarks.cpu()).abs().max()) < 1e-3
    assert torch.equal(ba_c.obs_inlier, ba_g.obs_inlier.cpu())


def _vi_problem(device):
    """Keyframe body states of a body turning and accelerating at constant
    body rates, their preintegrations (60 samples at 200 Hz a pair) and 300
    landmarks seen from every state, on ``device``."""
    from orb_slam3_rgbl_tpu_torch.geometry import lie
    from orb_slam3_rgbl_tpu_torch.imu import preintegration as pre

    rng = np.random.default_rng(3)
    omega, acc_b, dt = np.array([0.05, -0.1, 0.15]), np.array([0.6, 0.2, -0.3]), 0.005
    g = np.array([0.0, 0.0, -pre.GRAVITY])
    R, v, p = np.eye(3), np.array([1.0, 0.0, 0.2]), np.zeros(3)
    states, meas = [(R, v, p)], []
    for _ in range(7):
        acc, gyr = [], []
        for _ in range(60):
            a_w = R @ acc_b
            acc.append(R.T @ (a_w - g))
            gyr.append(omega + np.array([0.02, -0.01, 0.015]))
            p, v = p + v * dt + 0.5 * a_w * dt * dt, v + a_w * dt
            th = omega * dt
            K = np.array([[0, -th[2], th[1]], [th[2], 0, -th[0]], [-th[1], th[0], 0]])
            n = np.linalg.norm(th)
            R = R @ (np.eye(3) + np.sin(n) / n * K + (1 - np.cos(n)) / n ** 2 * K @ K)
        f = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        meas.append(pre.preintegrate(f(acc), f(gyr), torch.full((60,), dt, device=device),
                                     pre.ImuBias.zero(device=device)))
        states.append((R, v, p))
    Twb = torch.stack([torch.cat([lie.matrix_to_quat(torch.tensor(R, dtype=torch.float32)),
                                  torch.tensor(p, dtype=torch.float32)]) for R, _, p in states])
    vel = torch.tensor(np.stack([v for _, v, _ in states]), dtype=torch.float32)
    X = torch.tensor(rng.uniform([-10, -10, 15], [10, 10, 35], (300, 3)), dtype=torch.float32)
    return Twb.to(device), vel.to(device), meas, X.to(device)


def test_preintegration_on_the_card_matches_cpu(cuda):
    from orb_slam3_rgbl_tpu_torch.imu import preintegration as pre

    rng = np.random.default_rng(11)
    acc = rng.normal(0, 0.5, (150, 3)).astype(np.float32) + np.float32([0, 0, 9.81])
    gyr = rng.normal(0, 0.2, (150, 3)).astype(np.float32)
    dts = rng.uniform(0.0045, 0.0055, 150).astype(np.float32)
    bias = (np.float32([0.01, -0.02, 0.005]), np.float32([0.05, 0.0, -0.03]))
    out = {}
    for dev in (torch.device("cpu"), cuda):
        t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
        out[dev.type] = pre.preintegrate(t(acc), t(gyr), t(dts), pre.ImuBias(t(bias[0]),
                                                                            t(bias[1])))
    for name, a, b in zip(pre.Preintegrated._fields[:10], out["cpu"][:10], out["cuda"][:10]):
        a, b = a.double(), b.cpu().double()
        assert float((a - b).abs().max()) <= 1e-5 * max(float(a.abs().max()), 1e-30), name


def test_vi_solvers_on_the_card_without_a_wait(cuda):
    """``inertial_pose_optimize_prior``, ``imu_initialization`` and
    ``vi_bundle_adjust`` on the card with every wait for the device an
    error, within 1e-4 (poses, velocities) of their CPU runs."""
    from orb_slam3_rgbl_tpu_torch.geometry import lie
    from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam3_rgbl_tpu_torch.imu import preintegration as pre
    from orb_slam3_rgbl_tpu_torch.optim import inertial, inertial_ba
    from orb_slam3_rgbl_tpu_torch.optim.pose_opt import PoseObs
    from orb_slam3_rgbl_tpu_torch.slam import imu_frontend

    cam = PinholeCamera(fx=458.654, fy=457.296, cx=367.215, cy=248.375, width=752, height=480,
                        bf=50.0, th_depth=60.0)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        Twb, vel, meas, X = _vi_problem(dev)
        K, M = Twb.shape[0], X.shape[0]
        T_cb = lie.se3_identity(device=dev)
        pc = lie.se3_apply(lie.se3_inv(Twb[1]), X)
        uv = torch.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                          cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
        obs = PoseObs(X, uv, torch.full((M,), -1.0, device=dev), torch.ones(M, device=dev),
                      torch.ones(M, dtype=torch.bool, device=dev))
        zero = pre.ImuBias.zero(device=dev)
        prev = inertial.VIState(Twb[0], vel[0], zero)
        cur = inertial.VIState(lie.se3_mul(lie.se3_exp(torch.full((6,), 0.01, device=dev)),
                                           Twb[1]), vel[1], zero)
        L = torch.eye(15, device=dev) * 10.0
        stacked = imu_frontend.stack_preints([imu_frontend.preint_to_numpy(m) for m in meas], dev)
        obs_kf = torch.arange(K, device=dev).expand(M, K).contiguous()
        pcs = lie.se3_apply(lie.se3_inv(Twb)[None], X[:, None])
        problem = inertial_ba.VIBAProblem(
            Twb=Twb, vel=vel, bg=torch.zeros(K, 3, device=dev), ba=torch.zeros(K, 3, device=dev),
            state_fixed=torch.arange(K, device=dev) == 0,
            state_valid=torch.ones(K, dtype=torch.bool, device=dev), T_cb=T_cb, landmarks=X,
            lm_valid=torch.ones(M, dtype=torch.bool, device=dev), obs_kf=obs_kf,
            obs_uv=torch.stack([cam.fx * pcs[..., 0] / pcs[..., 2] + cam.cx,
                                cam.fy * pcs[..., 1] / pcs[..., 2] + cam.cy], -1),
            obs_ur=torch.full((M, K), -1.0, device=dev),
            obs_inv_sigma2=torch.ones(M, K, device=dev),
            obs_mask=torch.ones(M, K, dtype=torch.bool, device=dev),
            pair_i=torch.arange(K - 1, device=dev), pair_j=torch.arange(1, K, device=dev),
            pair_meas=stacked, pair_valid=torch.ones(K - 1, dtype=torch.bool, device=dev),
            info_bg=torch.full((K - 1,), 1e6, device=dev),
            info_ba=torch.full((K - 1,), 1e4, device=dev))
        run = lambda: (  # noqa: E731
            inertial.inertial_pose_optimize_prior(cur, prev, L, meas[0], obs, T_cb, cam),
            inertial.imu_initialization(Twb, stacked, torch.ones(K - 1, dtype=torch.bool,
                                                                 device=dev)),
            inertial_ba.vi_bundle_adjust(problem, cam, iterations=6))
        out[dev.type] = _no_sync(run) if dev.type == "cuda" else run()
    (pc_, init_c, ba_c), (pg_, init_g, ba_g) = out["cpu"], out["cuda"]
    close = lambda a, b, tol: float((a.cpu() - b.cpu()).abs().max()) < tol  # noqa: E731
    assert close(pc_[0].Twb, pg_[0].Twb, 1e-4) and close(pc_[0].vw, pg_[0].vw, 1e-4)
    assert int(pc_[2]) == int(pg_[2])
    assert close(init_c["velocities"], init_g["velocities"], 1e-3)
    assert close(init_c["bias"].bg, init_g["bias"].bg, 1e-5)
    assert close(ba_c.Twb, ba_g.Twb, 1e-4) and close(ba_c.vel, ba_g.vel, 1e-3)
    assert torch.equal(ba_c.obs_inlier, ba_g.obs_inlier.cpu())


def _sharded_problem(device):
    from orb_slam3_rgbl_tpu_torch import synthetic
    from orb_slam3_rgbl_tpu_torch.config import kitti_rgbl_config

    cam = kitti_rgbl_config().camera
    return (cam,) + synthetic.synth_gba_problem(64, 8192, 4, cam, device=device)


def test_sharded_pcg_over_nccl_one_rank_is_the_single_device_solve(cuda):
    """NCCL at world 1: no wait for the device inside the solve, and the
    same bits as ``global_bundle_adjust`` (a one-rank sum is the identity)."""
    import shutil

    from orb_slam3_rgbl_tpu_torch.optim import global_ba as gba
    from orb_slam3_rgbl_tpu_torch.parallel import mesh as mesh_mod, sharded_ba

    cam, problem, _, _ = _sharded_problem(cuda)
    init, store = mesh_mod.file_store()
    m = mesh_mod.make_mesh(0, 1, "nccl", init, device=cuda)
    try:
        shard = sharded_ba.shard_problem(problem, 0, 1, m.device)
        seg = gba.PoseSegments(shard.obs_kf, shard.obs_mask, shard.poses.shape[0])
        run = sharded_ba.make_distributed_pcg_ba(m, cam, iterations=3, cg_iters=40)
        run(shard, seg)                                  # NCCL's first collective sets it up
        res = _no_sync(lambda: run(shard, seg))
        torch.cuda.synchronize()
    finally:
        m.close()
        shutil.rmtree(store, ignore_errors=True)
    single = gba.global_bundle_adjust(problem, cam, seg, iterations=3, cg_iters=40)
    assert torch.equal(res.poses, single.poses) and torch.equal(res.landmarks, single.landmarks)
    assert float(res.cost) < 0.2 * float(gba.ba_cost(problem, cam))


def test_sharded_pcg_over_gloo_two_ranks_on_one_card(cuda):
    """Two gloo ranks on the one card: poses bit-equal on both ranks and in
    both solves, within 2e-4 of the single-device solve (2 × 25)."""
    from orb_slam3_rgbl_tpu_torch.optim import global_ba as gba
    from orb_slam3_rgbl_tpu_torch.parallel import mesh as mesh_mod, sharded_ba

    if mesh_mod.rank_layout(2, cuda) != ("gloo", ["cuda:0", "cuda:0"]):
        pytest.skip("two ranks share a card only on a host with one card")
    cam, problem, _, _ = _sharded_problem("cpu")
    kw = dict(iterations=2, cg_iters=25)
    (ranks,) = sharded_ba.solve_on_ranks([(problem, cam, "pcg", kw)], 2, cuda, repeats=2,
                                         timeout_s=600)
    first = ranks[0]["poses"][0]
    for r in ranks:
        for rep in range(2):
            assert r["poses"][rep].tobytes() == first.tobytes()
    p = problem._replace(**{f: getattr(problem, f).to(cuda) for f in problem._fields})
    seg = gba.PoseSegments(p.obs_kf, p.obs_mask, p.poses.shape[0])
    single = gba.global_bundle_adjust(p, cam, seg, **kw)
    assert np.abs(first - single.poses.cpu().numpy()).max() < 2e-4


def test_live_viewer_copies_after_the_tracking_streams_writes(cuda, tmp_path):
    """The frame image and keypoints written on a tracking stream of their
    own, behind a long product: the viewer's copies (on its own stream,
    from this thread) read them only after those writes, exactly."""
    import types

    from orb_slam3_rgbl_tpu_torch.viz.live import LiveViewer

    viewer = LiveViewer(types.SimpleNamespace(), out_dir=str(tmp_path))
    big = torch.rand(4096, 4096, device=cuda) / 4096
    torch.cuda.synchronize()
    tracking = torch.cuda.Stream()
    with torch.cuda.stream(tracking):
        x = big
        for _ in range(30):
            x = x @ big
        gray = x[:376, :1241] * 1e6
        uv = x[:2000, :2] * 1e6 + 1.0
        valid = x[:2000, 2] > x[:2000, 3]
        viewer.latest_img = gray
        viewer.update(types.SimpleNamespace(last_feats=types.SimpleNamespace(uv=uv, valid=valid)))
    gray_h, uv_h, valid_h = viewer._host_frame()
    tracking.synchronize()
    np.testing.assert_array_equal(gray_h, gray.cpu().numpy())
    np.testing.assert_array_equal(uv_h, uv.cpu().numpy())
    np.testing.assert_array_equal(valid_h, valid.cpu().numpy())
