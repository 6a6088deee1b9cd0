"""Binary bag-of-words via multi-band bit-sampling LSH (counterpart of
``orb_slam3_rgbl_tpu.retrieval.vocab``; stands in for DBoW2's
``TemplatedVocabulary<FORB>``).

A word is the integer formed by ``BITS_PER_BAND`` fixed random bit
positions of the 256-bit descriptor; ``N_BANDS`` independent bands give
robustness to bit noise. The positions come from numpy's
``default_rng(42)``, so the tables equal the JAX package's. The score is
DBoW2's L1 similarity, 1 − ½·Σ|a−b| on L1-normalized vectors.
"""

from __future__ import annotations

import numpy as np
import torch

N_BANDS = 8
BITS_PER_BAND = 10           # 1024 words per band
WORDS_PER_BAND = 1 << BITS_PER_BAND
VOCAB_SIZE = N_BANDS * WORDS_PER_BAND


def make_bit_tables(seed: int = 42) -> np.ndarray:
    """(N_BANDS, BITS_PER_BAND) bit positions in [0, 256)."""
    rng = np.random.default_rng(seed)
    return np.stack(
        [rng.choice(256, BITS_PER_BAND, replace=False) for _ in range(N_BANDS)]
    ).astype(np.int32)


BIT_TABLES = make_bit_tables()


def descriptor_words(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 packed descriptors → (N, N_BANDS) int64 global word ids."""
    tables = torch.as_tensor(BIT_TABLES, dtype=torch.int64, device=desc.device)   # (B, b)
    gathered = desc[:, tables // 32]                                  # (N, B, b) int32 words
    # an arithmetic shift still brings bit k down to bit 0
    bits = ((gathered >> (tables % 32).to(torch.int32)[None]) & 1).to(torch.int64)
    weights = 1 << torch.arange(BITS_PER_BAND, dtype=torch.int64, device=desc.device)
    words = torch.sum(bits * weights, dim=-1)
    offsets = torch.arange(N_BANDS, dtype=torch.int64, device=desc.device) * WORDS_PER_BAND
    return words + offsets[None, :]


def bow_vector(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Frame descriptors → (VOCAB_SIZE,) L1-normalized tf vector. The
    histogram adds ones: integer counts, exact in f32 in any order."""
    words = descriptor_words(desc)                                    # (N, B)
    w = valid[:, None].to(torch.float32).expand(words.shape)
    hist = torch.zeros(VOCAB_SIZE, dtype=torch.float32, device=desc.device)
    hist = hist.index_add(0, words.reshape(-1), w.reshape(-1))
    return hist / hist.sum().clamp_min(1e-9)


def l1_score(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity ∈ [0, 1]: 1 − ½·Σ|a − b| (both L1-normalized).
    a (W,) against b (..., W) → (...,), at least one-dimensional."""
    return 1.0 - 0.5 * torch.sum((a[None, :] - torch.atleast_2d(b)).abs(), dim=-1)


def shared_word_counts(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Count of vocabulary words present in both a (W,) and b (..., W):
    the ``minCommonWords`` gate of DetectNBestCandidates."""
    return torch.sum((a[None, :] > 0) & (torch.atleast_2d(b) > 0), dim=-1).to(torch.int32)
