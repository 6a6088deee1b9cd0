"""The CUDA kernels K1, K2 and K3 against their plain versions, on the card. Marked
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
