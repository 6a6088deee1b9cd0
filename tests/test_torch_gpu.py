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
    d = brief_cuda.brief_continuous(comp, corners, idx)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["brief_continuous"] == before + 1
    assert torch.equal(d, brief_cuda.brief_continuous_plain(comp, corners, idx))
    assert torch.equal(d, orb_ops.brief_descriptors(comp, uv, ang))
    # odd counts leave a partly filled last block
    assert torch.equal(brief_cuda.brief_continuous(comp, corners[:5], idx[:5]), d[:5])


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


def test_wrappers_reject_bad_inputs(cuda):
    with pytest.raises(ValueError):
        frontend_cuda.fast_and_blur(torch.zeros((3, 64), device=cuda))
    with pytest.raises(ValueError):
        frontend_cuda.fast_and_blur(torch.zeros((64, 64), dtype=torch.float64, device=cuda))
    comp = torch.zeros((64, 64), device=cuda)
    with pytest.raises(ValueError):
        brief_cuda.brief_continuous(comp, torch.zeros((2, 2), dtype=torch.int64, device=cuda),
                                    torch.zeros((2, 512), dtype=torch.int32, device=cuda))
    corners = torch.ones((128, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):     # one bin per block: (2, 1), not (1, 1)
        brief_cuda.brief_blocks(comp, corners, torch.zeros((1, 1), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        brief_cuda.brief_blocks(comp, corners, torch.zeros((2, 1), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        brief_cuda.brief_blocks(comp, corners.cpu(), torch.zeros((2, 1), dtype=torch.int32, device=cuda))
