"""Trainable hierarchical binary vocabulary, the DBoW2 equivalent
(counterpart of ``orb_slam3_rgbl_tpu.retrieval.tree_vocab``; reference
``Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h``).

A complete k-ary tree of binary centroids built by hierarchical k-medians
over ORB descriptors (``create``), descriptor → word by tree descent with a
Hamming argmin per level (``transform``), and tf-idf weighted, L1-normalized
frame vectors (``TemplatedVocabulary.h:135-162``). Each level is one flat
(k^(l+1), 8) tensor of centres, so the descent is a fixed ``depth``-step
loop of a gather of the k children, XOR, popcount and an argmin on the
device, where the first of equal distances wins (as ``jnp.argmin``).

The levels hold the uint32 centre words as int32 tensors with the same
bits (the port's descriptor layout); ``save`` writes them as uint32, so an
``.npz`` of either package loads in the other and ``checksum`` gives the
same digest. The trainer is the JAX package's numpy seeded by
``np.random.default_rng``: the same descriptors and seed build the same
levels, bit for bit.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch.device import resolve
from orb_slam3_rgbl_tpu_torch.ops.matching import popcount32


def _popcount_u32(x: np.ndarray) -> np.ndarray:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 8) u32 vs (M, 8) u32 → (N, M) int32 Hamming distances."""
    x = a[:, None, :] ^ b[None, :, :]
    return _popcount_u32(x).sum(-1).astype(np.int32)


def _binary_median(desc: np.ndarray) -> np.ndarray:
    """Bitwise majority vote over (N, 8) u32 → (8,) u32 (DBoW2's
    ``meanValue`` for binary descriptors)."""
    bits = np.unpackbits(desc.view(np.uint8), bitorder="little").reshape(len(desc), 256)
    maj = (bits.sum(0) * 2 >= len(desc)).astype(np.uint8)
    return np.packbits(maj, bitorder="little").view(np.uint32)


def _kmedians(desc: np.ndarray, k: int, rng: np.random.Generator, iters: int = 8) -> tuple:
    """Binary k-medians with k-means++ seeding (Hamming metric). Returns
    (centers (k, 8) u32, assignment (N,))."""
    n = len(desc)
    if n == 0:
        # an empty node: all-zero children that no descriptor reaches
        return np.zeros((k, 8), np.uint32), np.zeros(0, np.int64)
    if n <= k:
        centers = np.zeros((k, 8), np.uint32)
        centers[:n] = desc
        if n < k:  # pad with perturbed copies so every child is distinct
            centers[n:] = desc[rng.integers(0, n, k - n)] ^ np.uint32(1)
        return centers, np.arange(n) % k
    centers = [desc[rng.integers(n)]]
    for _ in range(k - 1):
        d = _hamming_np(desc, np.stack(centers)).min(1).astype(np.float64)
        p = d / max(d.sum(), 1e-9)
        centers.append(desc[rng.choice(n, p=p)])
    centers = np.stack(centers)
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        assign_new = _hamming_np(desc, centers).argmin(1)
        if np.array_equal(assign_new, assign):
            break
        assign = assign_new
        for c in range(k):
            members = desc[assign == c]
            if len(members):
                centers[c] = _binary_median(members)
            else:  # re-seed an empty cluster with the farthest point
                far = _hamming_np(desc, centers).min(1).argmax()
                centers[c] = desc[far]
    return centers, assign


@dataclasses.dataclass
class TreeVocabulary:
    """Complete k-ary binary vocabulary on one device.

    levels: list of (k^(l+1), 8) int32 centre tensors, l = 0..depth-1.
    idf:    (k^depth,) float32 inverse-document-frequency weights.
    """

    k: int
    depth: int
    levels: list
    idf: torch.Tensor

    @property
    def n_words(self) -> int:
        return self.k ** self.depth

    @property
    def device(self) -> torch.device:
        return self.idf.device

    def levels_u32(self) -> list:
        """The levels as (k^(l+1), 8) uint32 numpy arrays (the JAX package's layout)."""
        return [lv.cpu().numpy().view(np.uint32) for lv in self.levels]

    def save(self, path: str):
        np.savez_compressed(path, k=self.k, depth=self.depth, idf=self.idf.cpu().numpy(),
                            **{f"level_{i}": lv for i, lv in enumerate(self.levels_u32())})

    @staticmethod
    def load(path: str, device=None) -> "TreeVocabulary":
        """A saved vocabulary on ``device`` (default ``cuda``)."""
        with np.load(path) as z:
            depth = int(z["depth"])
            return TreeVocabulary.from_numpy(int(z["k"]), [z[f"level_{i}"] for i in range(depth)],
                                             z["idf"], device=device)

    @staticmethod
    def from_numpy(k: int, levels, idf, device=None) -> "TreeVocabulary":
        """uint32 (or int32) level arrays and f32 idf weights → a vocabulary
        on ``device`` (default ``cuda``)."""
        dev = resolve(device)
        levels = [torch.as_tensor(np.ascontiguousarray(lv).view(np.int32), device=dev)
                  for lv in levels]
        return TreeVocabulary(k=int(k), depth=len(levels), levels=levels,
                              idf=torch.as_tensor(np.asarray(idf, np.float32), device=dev))

    def checksum(self) -> str:
        """MD5 of the packed tree (the vocabulary-compatibility guard of
        ``System::CalculateCheckSum``, reference ``System.cc:1650-1689``)."""
        h = hashlib.md5()
        for lv in self.levels_u32():
            h.update(np.ascontiguousarray(lv).tobytes())
        return h.hexdigest()

    def words(self, desc: torch.Tensor) -> torch.Tensor:
        """(N, 8) int32 descriptor words → (N,) int32 word ids."""
        return _descend(self.levels, self.k, desc)

    def bow(self, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """(N, 8), (N,) → (n_words,) L1-normalized tf-idf vector. The
        histogram adds ones: integer counts, exact in f32 in any order."""
        w = self.words(desc)
        hist = torch.zeros(self.n_words, dtype=torch.float32, device=desc.device)
        hist = hist.index_add(0, w.long(), valid.to(torch.float32)) * self.idf
        return hist / hist.sum().clamp_min(1e-9)


def _descend(levels: list, k: int, desc: torch.Tensor) -> torch.Tensor:
    """Tree descent: at each level the nearest of the current node's k
    children (the first of equal distances)."""
    n = desc.shape[0]
    children = torch.arange(k, device=desc.device)
    idx = torch.zeros(n, dtype=torch.int64, device=desc.device)   # node within level l-1
    for lv in levels:
        base = idx * k
        cand = lv[base[:, None] + children[None, :]]                  # (N, k, 8)
        d = popcount32(cand ^ desc[:, None, :]).sum(-1)               # (N, k) ≤ 256
        # distance·k + child index is unique: its argmin is the first minimum
        idx = base + torch.argmin(d * k + children[None, :], dim=1)
    return idx.to(torch.int32)


def train_vocabulary(desc: np.ndarray, k: int = 10, depth: int = 4, seed: int = 0,
                     iters: int = 8, idf_docs: Optional[list] = None,
                     device=None) -> TreeVocabulary:
    """Hierarchical k-medians over (N, 8) uint32 descriptors (DBoW2
    ``create``), on the host; the vocabulary lands on ``device`` (default
    ``cuda``). ``idf_docs``: per-image descriptor arrays for the idf
    weights (uniform without)."""
    rng = np.random.default_rng(seed)
    desc = np.asarray(desc, np.uint32).reshape(-1, 8)
    levels = []
    # groups[i] = descriptor indices currently in node i of this level
    groups = [np.arange(len(desc))]
    for _ in range(depth):
        centers_lv = np.zeros((len(groups) * k, 8), np.uint32)
        next_groups = []
        for gi, g in enumerate(groups):
            c, a = _kmedians(desc[g], k, rng, iters=iters)
            centers_lv[gi * k:(gi + 1) * k] = c
            for ci in range(k):
                next_groups.append(g[a == ci] if len(g) else g)
        levels.append(centers_lv)
        groups = next_groups

    idf = np.ones(k ** depth, np.float32)
    voc = TreeVocabulary.from_numpy(k, levels, idf, device=device)
    if idf_docs:
        df = np.zeros(voc.n_words, np.float64)
        for d in idf_docs:
            d = np.ascontiguousarray(np.asarray(d, np.uint32)).view(np.int32)
            df[np.unique(voc.words(torch.as_tensor(d, device=voc.device)).cpu().numpy())] += 1.0
        n_docs = len(idf_docs)
        idf = np.log(n_docs / np.maximum(df, 1.0)).astype(np.float32)
        idf[df == 0] = float(np.log(n_docs))
        voc.idf = torch.as_tensor(idf, device=voc.device)
    return voc
