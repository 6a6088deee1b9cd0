"""Port vs JAX: ``retrieval/vocab.py`` and ``retrieval/keyframe_db.py``.

Words and the histogram are integers and must be exact; the L1 scores are
held to 1e-6 (observed ≤ 1.2e-7: two sums of 8192 f32 terms in different
orders). The candidate queries run on a JAX map after 60 frames of the
circular feature drive (10+ keyframes, the database filled by the JAX
``LoopCloser``), carried across with ``convert``: the same candidates in the
same order."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu.retrieval import vocab as j_vocab
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.retrieval import vocab as t_vocab
from orb_slam3_rgbl_tpu_torch.retrieval.keyframe_db import KeyFrameDatabase
from orb_slam3_rgbl_tpu_torch.retrieval.tree_vocab import train_vocabulary

from test_torch_loop_closing import (feats_to_port, jax_state_before_loop, loop_drive_features,
                                     port_closer)


def _i32(desc):
    return torch.from_numpy(np.ascontiguousarray(desc).view(np.int32))


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(3)
    desc = rng.integers(0, 2**32, (5, 600, 8), dtype=np.uint32)
    desc[1] = desc[0]
    flip = rng.integers(0, 8, 600), rng.integers(0, 32, 600)
    desc[1, np.arange(600), flip[0]] ^= (np.uint32(1) << flip[1].astype(np.uint32))
    valid = rng.uniform(size=(5, 600)) < 0.9
    return desc, valid


def test_bit_tables_and_words_exact(frames):
    desc, _ = frames
    np.testing.assert_array_equal(t_vocab.BIT_TABLES, j_vocab.BIT_TABLES)
    np.testing.assert_array_equal(t_vocab.make_bit_tables(5), j_vocab.make_bit_tables(5))
    assert t_vocab.VOCAB_SIZE == j_vocab.VOCAB_SIZE == 8192
    w_t = t_vocab.descriptor_words(_i32(desc[0]))
    w_j = np.asarray(j_vocab.descriptor_words(jnp.asarray(desc[0])))
    assert w_t.dtype == torch.int64 and w_t.shape == (600, 8)
    np.testing.assert_array_equal(w_t.numpy(), w_j)
    # words with the descriptor's top bit set: the port's words are signed
    top = np.full((4, 8), 0xFFFFFFFF, np.uint32)
    np.testing.assert_array_equal(t_vocab.descriptor_words(_i32(top)).numpy(),
                                  np.asarray(j_vocab.descriptor_words(jnp.asarray(top))))


def test_bow_vector_and_scores(frames):
    desc, valid = frames
    with jax.enable_x64(False):
        v_j = np.stack([np.asarray(j_vocab.bow_vector(jnp.asarray(d), jnp.asarray(v)))
                        for d, v in zip(desc, valid)])
        s_j = np.asarray(j_vocab.l1_score(jnp.asarray(v_j[0]), jnp.asarray(v_j)))
        c_j = np.asarray(j_vocab.shared_word_counts(jnp.asarray(v_j[0]), jnp.asarray(v_j)))
    v_t = torch.stack([t_vocab.bow_vector(_i32(d), torch.from_numpy(v))
                       for d, v in zip(desc, valid)])
    # integer counts over one total: the same division on both sides
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    s_t = t_vocab.l1_score(v_t[0], v_t)
    np.testing.assert_allclose(s_t.numpy(), s_j, atol=1e-6)
    c_t = t_vocab.shared_word_counts(v_t[0], v_t)
    assert c_t.dtype == torch.int32
    np.testing.assert_array_equal(c_t.numpy(), c_j)
    assert s_t[1] > 2 * s_t[2] + 0.1 and s_t[0] > 0.999
    # one vector against one vector still comes back one-dimensional
    assert t_vocab.l1_score(v_t[0], v_t[1]).shape == (1,)
    empty = t_vocab.bow_vector(_i32(desc[0]), torch.zeros(600, dtype=torch.bool))
    assert float(empty.sum()) == 0.0


@pytest.fixture(scope="module")
def jax_map():
    js, ev, *_ = jax_state_before_loop(stop_after_frames=60)
    assert ev is None and js.map.n_kf >= 9
    return js, convert.config_from_dict(dataclasses.asdict(js.cfg))


def test_database_add_query_erase_match_jax(jax_map):
    js, tcfg = jax_map
    jdb, jm = js.loop_closer.db, js.map
    db = KeyFrameDatabase(jm.capacity_kf, device="cpu")
    for k in range(jm.n_kf):
        db.add(k, jm.kf_desc[k], jm.kf_feat_valid[k])
    np.testing.assert_array_equal(db.present, jdb.present)
    np.testing.assert_array_equal(db.vectors.numpy(), jdb.vectors)
    # int32 device words give the same signature as the map's uint32 words
    row = db.vectors[3].clone()
    db.add(3, _i32(jm.kf_desc[3]), torch.from_numpy(jm.kf_feat_valid[3]))
    np.testing.assert_array_equal(db.vectors[3].numpy(), row.numpy())
    exclude = np.array([1, 2], np.int64)
    with jax.enable_x64(False):
        s_j, c_j = jdb.query(jdb.vectors[5], exclude)
    s_t, c_t = db.query(db.vectors[5], exclude)
    assert s_t.dtype == np.float32 and s_t.shape == (jm.capacity_kf,)
    np.testing.assert_allclose(s_t, s_j, atol=1e-6)
    np.testing.assert_array_equal(c_t, c_j)
    assert (s_t[exclude] == 0).all() and (s_t[jm.n_kf:] == 0).all() and s_t[5] > 0.999
    db.erase(5)
    jdb_present = jdb.present.copy()
    jdb_present[5] = False
    np.testing.assert_array_equal(db.present, jdb_present)
    assert db.query(db.vectors[5], exclude)[0][5] == 0
    # a trained tree vocabulary sets the table's width (tests/test_torch_tree_vocab.py)
    voc = train_vocabulary(jm.kf_desc[0][jm.kf_feat_valid[0]], k=4, depth=2, device="cpu")
    assert KeyFrameDatabase(4, vocabulary=voc, device="cpu").vectors.shape == (4, 16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            KeyFrameDatabase(4)


def test_detect_candidates_match_jax(jax_map):
    js, tcfg = jax_map
    closer = port_closer(js, tcfg)
    jdb, jm = js.loop_closer.db, js.map
    n_found = 0
    for kf in range(jm.n_kf):
        for min_covis in (15, 10**6):      # the loop query, and one that excludes nobody
            with jax.enable_x64(False):
                c_j = jdb.detect_candidates(jm, kf, n_candidates=3, min_covis_exclude=min_covis)
            c_t = closer.db.detect_candidates(closer.map, kf, n_candidates=3,
                                              min_covis_exclude=min_covis)
            assert c_t.dtype == np.int64
            np.testing.assert_array_equal(c_t, c_j)
            n_found += c_t.size
    assert n_found > jm.n_kf


def test_detect_relocalization_candidates_match_jax(jax_map):
    js, tcfg = jax_map
    closer = port_closer(js, tcfg)
    _, feats, _ = loop_drive_features(60)
    for i in (0, 20, 45, 59):
        f = feats[i]
        with jax.enable_x64(False):
            c_j = js.loop_closer.db.detect_relocalization_candidates(
                np.asarray(f.desc), np.asarray(f.valid), 5)
        tf = feats_to_port(f)
        c_t = closer.db.detect_relocalization_candidates(tf.desc, tf.valid, 5)
        np.testing.assert_array_equal(c_t, c_j)
        assert 1 <= c_t.size <= 5
    blank = torch.zeros(600, dtype=torch.bool)
    assert closer.db.detect_relocalization_candidates(tf.desc, blank, 5).size == 0
