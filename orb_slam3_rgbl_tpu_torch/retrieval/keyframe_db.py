"""Keyframe database: loop and relocalization candidate retrieval
(counterpart of ``orb_slam3_rgbl_tpu.retrieval.keyframe_db``; reference
``KeyFrameDatabase.cc``: ``DetectNBestCandidates`` and
``DetectRelocalizationCandidates``).

Selection follows the reference — shared-word gate at 0.8·max, L1 scores
accumulated over each candidate's top-10 covisible group, best-N groups —
computed densely over the whole database. Signatures come from the LSH
words of ``retrieval.vocab`` or from a trained ``TreeVocabulary``. The
``(capacity_kf, n_words)`` table of signatures lives on the device: ``add``
writes one row in place, ``grow`` extends it by one concatenation (an
atlas weld), and ``query`` brings back two vectors of ``capacity_kf``
numbers. With the asynchronous planes the loop worker writes rows on its
CUDA stream while the tracking thread queries (relocalization, merge
detection): writes, growth and the enqueue of a query go under one lock,
and a query's stream waits for every stream's last write
(``device.StreamOrder``).
"""

from __future__ import annotations

import threading
from typing import Tuple

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch.device import StreamOrder, resolve
from orb_slam3_rgbl_tpu_torch.retrieval import vocab
from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState


class KeyFrameDatabase:
    def __init__(self, capacity_kf: int, vocabulary=None, device=None):
        """``vocabulary``: a trained :class:`~orb_slam3_rgbl_tpu_torch.
        retrieval.tree_vocab.TreeVocabulary` on ``device`` (the DBoW2
        equivalent); the LSH words of ``retrieval.vocab`` without one."""
        self.device = resolve(device)
        self.vocabulary = vocabulary
        n_words = vocab.VOCAB_SIZE if vocabulary is None else vocabulary.n_words
        self.vectors = torch.zeros((capacity_kf, n_words), dtype=torch.float32,
                                   device=self.device)
        self.present = np.zeros(capacity_kf, bool)
        self._lock = threading.Lock()
        self._order = StreamOrder(self.device)

    @classmethod
    def from_numpy(cls, vectors: np.ndarray, present: np.ndarray, vocabulary=None,
                   device=None) -> "KeyFrameDatabase":
        """A database holding saved signature rows (uploaded to ``device``,
        default ``cuda``) and presence flags."""
        db = cls(vectors.shape[0], vocabulary=vocabulary, device=device)
        if tuple(vectors.shape) != tuple(db.vectors.shape):
            raise ValueError(f"database rows {tuple(vectors.shape)}, the vocabulary gives "
                             f"{tuple(db.vectors.shape)}")
        with db._lock:
            db.vectors.copy_(torch.as_tensor(np.asarray(vectors, np.float32)))
            db._order.wrote([db.vectors])
            db.present = np.array(present, bool)
        return db

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        """(signature rows, presence flags) on the host, after every
        stream's last write."""
        with self._lock:
            self._order.before_read([self.vectors])
            vectors, present = self.vectors, self.present.copy()
        return vectors.cpu().numpy(), present

    def _bow(self, desc, valid) -> torch.Tensor:
        """Signature of one frame; ``desc`` (N, 8) as uint32 numpy words or
        an int32 tensor with the same bits."""
        if isinstance(desc, np.ndarray):
            desc = np.ascontiguousarray(desc).view(np.int32)
        desc = torch.as_tensor(desc, dtype=torch.int32, device=self.device)
        valid = torch.as_tensor(valid, dtype=torch.bool, device=self.device)
        if self.vocabulary is not None:
            return self.vocabulary.bow(desc, valid)
        return vocab.bow_vector(desc, valid)

    def grow(self, capacity_kf: int):
        """Extend the table and ``present`` to ``capacity_kf`` rows (empty
        rows); a no-op when they are that long already."""
        with self._lock:
            extra = capacity_kf - self.vectors.shape[0]
            if extra <= 0:
                return
            self._order.before_read([self.vectors])
            self.vectors = torch.cat([self.vectors,
                                      self.vectors.new_zeros((extra, self.vectors.shape[1]))])
            self._order.wrote([self.vectors])
            self.present = np.concatenate([self.present, np.zeros(extra, bool)])

    def add(self, kf_id: int, desc, valid):
        bow = self._bow(desc, valid)
        with self._lock:
            self.vectors[kf_id] = bow
            self._order.wrote([self.vectors])
            self.present[kf_id] = True

    def erase(self, kf_id: int):
        with self._lock:
            self.present[kf_id] = False

    def query(self, query_vec, exclude: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """L1 scores + shared-word counts against all stored keyframes
        (excluded / absent → 0), downloaded in one transfer."""
        q = torch.as_tensor(query_vec, dtype=torch.float32, device=self.device)
        with self._lock:
            self._order.before_read([self.vectors])
            both = torch.stack([vocab.l1_score(q, self.vectors),
                                vocab.shared_word_counts(q, self.vectors).to(torch.float32)])
            ok = self.present.copy()
        both = both.cpu().numpy()
        scores, shared = both[0], both[1].astype(np.int32)
        ok[exclude] = False
        return np.where(ok, scores, np.float32(0.0)), np.where(ok, shared, 0)

    def detect_candidates(self, map_state: MapState, kf_id: int, n_candidates: int = 3,
                          min_covis_exclude: int = 15) -> np.ndarray:
        """Loop candidates for keyframe ``kf_id`` following
        ``DetectNBestCandidates``: exclude the covisible neighbourhood,
        gate on shared words ≥ 0.8·max, accumulate scores over each
        candidate's covisible group, return the best-scoring group
        representatives."""
        covis_w = map_state.covisibility_weights(kf_id)
        exclude = np.nonzero(covis_w >= min_covis_exclude)[0]
        exclude = np.concatenate([exclude, [kf_id]])
        scores, shared = self.query(self.vectors[kf_id], exclude)

        if shared.max() == 0:
            return np.zeros(0, np.int64)
        min_shared = int(0.8 * shared.max())
        cand = np.nonzero((shared >= max(min_shared, 1)) & (scores > 0))[0]
        if cand.size == 0:
            return np.zeros(0, np.int64)

        acc_scores = np.zeros(cand.size, np.float32)
        best_in_group = np.zeros(cand.size, np.int64)
        for i, c in enumerate(cand):
            group = np.concatenate([[c], map_state.best_covisible(int(c), 10, min_weight=1)])
            g_scores = scores[group]
            acc_scores[i] = g_scores.sum()
            best_in_group[i] = group[np.argmax(g_scores)]

        order = np.argsort(-acc_scores)
        out, seen = [], set()
        for i in order:
            b = int(best_in_group[i])
            if b not in seen:
                seen.add(b)
                out.append(b)
            if len(out) >= n_candidates:
                break
        return np.array(out, np.int64)

    def detect_relocalization_candidates(self, desc, valid, n_candidates: int = 5) -> np.ndarray:
        """Frame-level query, no covisibility exclusion
        (``DetectRelocalizationCandidates``)."""
        scores, shared = self.query(self._bow(desc, valid), np.zeros(0, np.int64))
        if shared.max() == 0:
            return np.zeros(0, np.int64)
        cand = np.nonzero(shared >= max(int(0.8 * shared.max()), 1))[0]
        order = cand[np.argsort(-scores[cand])]
        return order[:n_candidates]
