"""Port vs JAX: the trained tree vocabulary (``retrieval/tree_vocab.py``)
and the keyframe database that scores with it.

* the trainer (numpy seeded by ``np.random.default_rng``): bit-identical
  levels, idf weights and ``checksum`` from the same descriptors and seed;
* ``words``: exact; ``bow``: 1e-6 (absolute, on L1-normalized vectors;
  observed ≤ 6e-8), on random descriptors and on descriptors extracted from
  rendered 320×192 frames;
* an ``.npz`` saved by either package loads in the other;
* ``KeyFrameDatabase(vocabulary=)``: rows 1e-6, scores 1e-6, shared-word
  counts and relocalization candidates exact;
* a 16-frame feature-level ``System`` drive of both packages with
  ``cfg.vocab_path`` set: the same keyframes, database rows within 1e-6.

JAX runs with x64 off, as outside the test suite."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu.retrieval import tree_vocab as j_tv
from orb_slam3_rgbl_tpu.retrieval.keyframe_db import KeyFrameDatabase as JDatabase
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu_torch import convert, synthetic as t_syn
from orb_slam3_rgbl_tpu_torch.retrieval import tree_vocab as t_tv
from orb_slam3_rgbl_tpu_torch.retrieval.keyframe_db import KeyFrameDatabase as TDatabase
from orb_slam3_rgbl_tpu_torch.slam import frame as t_frame
from orb_slam3_rgbl_tpu_torch.slam.system import System as TSystem

from test_torch_loop_closing import feats_to_port, loop_drive_features

TOL = 1e-6
N_DRIVE = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _i32(desc_u32):
    return torch.from_numpy(np.ascontiguousarray(desc_u32, np.uint32).view(np.int32))


@pytest.fixture(scope="module")
def rendered():
    """Per-frame (descriptors (N, 8) uint32, valid (N,)) of 4 rendered
    320×192 frames of the box room, extracted by the port on the CPU."""
    cfg = t_syn.synthetic_rgbl_config()
    cam, o = cfg.camera, cfg.orb
    world = t_syn.make_box_world(0, tex_size=256, device="cpu")
    traj = t_syn.multi_loop_trajectory(4, radius=6.0, period=84)
    traj[:, 4] -= 6.0
    out = []
    for Twc in traj:
        img = t_syn.render_image(world, Twc, cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width)
        f = t_frame.extract_features(img, cam.height, cam.width, n_features=o.n_features,
                                     n_levels=o.n_levels, scale_factor=o.scale_factor,
                                     device="cpu")
        out.append((f.desc.numpy().view(np.uint32), f.valid.numpy()))
    return out


def _random_desc(seed, n):
    return np.random.default_rng(seed).integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def _train_both(desc, docs, **kw):
    with jax.enable_x64(False):
        jv = j_tv.train_vocabulary(desc, idf_docs=docs, **kw)
    tv = t_tv.train_vocabulary(desc, idf_docs=docs, device="cpu", **kw)
    return jv, tv


@pytest.mark.parametrize("source, k, depth", [
    ("rendered", 8, 3),       # the size the chip check trains
    ("random", 4, 4),         # nodes of ≤ k descriptors and empty ones
])
def test_trainer_is_bit_identical(rendered, source, k, depth):
    if source == "rendered":
        docs = [d[v] for d, v in rendered]
    else:
        docs = [_random_desc(s, 40) for s in range(3)]
    jv, tv = _train_both(np.concatenate(docs), docs, k=k, depth=depth, seed=0)
    assert tv.n_words == jv.n_words == k ** depth and len(tv.levels) == depth
    for lj, lt in zip(jv.levels, tv.levels):
        assert lt.dtype == torch.int32
        np.testing.assert_array_equal(lt.numpy().view(np.uint32), lj)
    np.testing.assert_array_equal(tv.idf.numpy(), jv.idf)
    assert tv.checksum() == jv.checksum()
    # the idf weights came from the documents: a word no document holds
    # weighs log(n_docs), a word every document holds 0
    assert np.isclose(tv.idf.numpy().max(), np.log(len(docs)))


@pytest.mark.parametrize("source", ["random", "rendered"])
def test_words_and_bow_match_jax(rendered, source):
    if source == "random":
        train = _random_desc(1, 600)
        queries = [(_random_desc(2, 500), np.random.default_rng(3).random(500) < 0.8)]
    else:
        train = np.concatenate([d[v] for d, v in rendered[:2]])
        queries = rendered[2:]
    jv, tv = _train_both(train, None, k=6, depth=3, seed=4)
    for desc, valid in queries:
        with jax.enable_x64(False):
            w_j = np.asarray(jv.words(jnp.asarray(desc)))
            b_j = np.asarray(jv.bow(jnp.asarray(desc), jnp.asarray(valid)))
        w_t = tv.words(_i32(desc))
        b_t = tv.bow(_i32(desc), torch.from_numpy(valid))
        assert w_t.dtype == torch.int32 and b_t.dtype == torch.float32
        np.testing.assert_array_equal(w_t.numpy(), w_j)
        np.testing.assert_allclose(b_t.numpy(), b_j, atol=TOL)
        assert abs(float(b_t.sum()) - 1.0) < 1e-5 and len(np.unique(w_j)) > 20


def test_save_and_load_across_packages(tmp_path):
    desc = _random_desc(5, 300)
    docs = [desc[:100], desc[100:]]
    jv, tv = _train_both(desc, docs, k=5, depth=2, seed=1)
    tv.save(str(tmp_path / "port.npz"))
    jv.save(str(tmp_path / "jax.npz"))
    from_port = j_tv.TreeVocabulary.load(str(tmp_path / "port.npz"))
    from_jax = t_tv.TreeVocabulary.load(str(tmp_path / "jax.npz"), device="cpu")
    assert from_port.checksum() == from_jax.checksum() == jv.checksum()
    assert (from_port.k, from_port.depth) == (from_jax.k, from_jax.depth) == (5, 2)
    for a, b in zip(from_port.levels, from_jax.levels):
        assert a.dtype == np.uint32
        np.testing.assert_array_equal(b.numpy().view(np.uint32), a)
    np.testing.assert_array_equal(from_port.idf, from_jax.idf.numpy())
    converted = convert.tree_vocabulary_from_numpy(jv, device="cpu")
    assert converted.checksum() == jv.checksum() and converted.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_tv.TreeVocabulary.load(str(tmp_path / "jax.npz"))


def test_database_with_vocabulary_matches_jax(rendered):
    docs = [d[v] for d, v in rendered]
    jv, tv = _train_both(np.concatenate(docs), docs, k=8, depth=3, seed=0)
    jdb, tdb = JDatabase(8, vocabulary=jv), TDatabase(8, vocabulary=tv, device="cpu")
    assert tdb.vectors.shape == (8, 512)
    with jax.enable_x64(False):
        for k, (d, v) in enumerate(rendered):
            jdb.add(k, d, v)
            tdb.add(k, d, v)
    np.testing.assert_allclose(tdb.vectors.numpy(), jdb.vectors, atol=TOL)
    np.testing.assert_array_equal(tdb.present, jdb.present)
    for k in range(len(rendered)):
        with jax.enable_x64(False):
            s_j, sh_j = jdb.query(jdb.vectors[k], np.array([k]))
        s_t, sh_t = tdb.query(tdb.vectors[k], np.array([k]))
        np.testing.assert_allclose(s_t, s_j, atol=TOL)
        np.testing.assert_array_equal(sh_t, sh_j)
        assert s_t[k] == 0 and (s_t[:len(rendered)] > 0).sum() == len(rendered) - 1
    d, v = rendered[1]
    with jax.enable_x64(False):
        c_j = jdb.detect_relocalization_candidates(d, v)
    np.testing.assert_array_equal(tdb.detect_relocalization_candidates(d, v), c_j)
    assert c_j[0] == 1
    # the database's growth by an atlas weld keeps the vocabulary's width
    tdb.grow(12)
    assert tdb.vectors.shape == (12, 512) and tdb.present.shape == (12,)
    assert not tdb.present[8:].any() and not tdb.vectors[8:].any()


def test_system_with_vocab_path_matches_jax(tmp_path):
    """Both Systems with the default configuration and ``vocab_path`` set
    to a vocabulary trained on the drive's own descriptors."""
    cfg, feats, _ = loop_drive_features(N_DRIVE)
    docs = [np.asarray(f.desc)[np.asarray(f.valid)] for f in feats]
    voc = t_tv.train_vocabulary(np.concatenate(docs), k=8, depth=3, seed=0, idf_docs=docs,
                                device="cpu")
    path = str(tmp_path / "vocab.npz")
    voc.save(path)
    cfg = dataclasses.replace(cfg, vocab_path=path)
    js, ts = JSystem(cfg), TSystem(convert.config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    with jax.enable_x64(False):
        for i, f in enumerate(feats):
            rj = js.track_features(f, i * 0.1)
            rt = ts.track_features(feats_to_port(f), i * 0.1)
            assert (rt.state, rt.created_kf) == (rj.state, rj.created_kf), i
    jdb, tdb = js.loop_closer.db, ts.loop_closer.db
    assert tdb.vocabulary is not None and tdb.vocabulary.checksum() == voc.checksum()
    assert tdb.vectors.shape == jdb.vectors.shape == (ts.map.capacity_kf, 512)
    assert ts.map.n_kf == js.map.n_kf >= 3
    np.testing.assert_array_equal(tdb.present, jdb.present)
    np.testing.assert_allclose(tdb.vectors.numpy(), jdb.vectors, atol=TOL)
