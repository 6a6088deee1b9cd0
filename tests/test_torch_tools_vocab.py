"""Port vs JAX: ``tools/train_vocabulary`` against the root
``tools/train_vocabulary.py`` on the same 5 PNG images (320×192, 1000
features, k = 8, depth = 2).

What is held, and why not the words themselves:
- The extractions: on each image both packages keep the same number of
  valid descriptors in the same order, at least 99% of them identical
  (``orb.ic_angle``'s prefix sums add in another order: the bar of
  tests/test_torch_brief.py; 99.3–99.9% seen).
- The composition of the tool (file order, idf documents, k, depth, seed):
  the port's trainer fed the JAX extraction's descriptors gives the JAX
  tool's vocabulary, checksum exact.
- The two tools' vocabularies quantize image 0's descriptors equally well:
  the mean Hamming distance to the assigned leaf within 5% (~72 of 256 bits
  on both, 1% apart seen).
The share of image 0's descriptors that the two tools' vocabularies give
the same word is not held: hierarchical k-medians is not continuous in its
input, and the ~0.5% of descriptors that differ move every centre (50–180
of 256 bits apart at the first level), so the word ids of the two trees do
not correspond (3.6% agreement seen). Both are valid trees of the same
quality; a vocabulary is used with the extractor that trained it."""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from orb_slam3_rgbl_tpu.slam import frame as j_frame  # noqa: E402
from orb_slam3_rgbl_tpu_torch import synthetic as t_syn  # noqa: E402
from orb_slam3_rgbl_tpu_torch.io import png  # noqa: E402
from orb_slam3_rgbl_tpu_torch.retrieval import tree_vocab  # noqa: E402
from orb_slam3_rgbl_tpu_torch.tools import train_vocabulary as t_tool  # noqa: E402

from test_torch_system import one_torch_thread  # noqa: E402,F401  (autouse)

N_IMAGES = 5
K, DEPTH = 8, 2
SAME_DESC_MIN = 0.99
QUANT_REL_TOL = 0.05


def _popcount(words: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8), axis=-1).sum(-1)


def test_train_vocabulary_matches_jax_tool(tmp_path, monkeypatch):
    from tools import train_vocabulary as j_tool

    cfg = t_syn.synthetic_rgbl_config()
    cam = cfg.camera
    world = t_syn.make_world(0, tex_size=256, device="cpu")
    images = tmp_path / "images"
    images.mkdir()
    for i, Twc in enumerate(t_syn.straight_trajectory(N_IMAGES, step=0.6, weave=0.4)):
        img = t_syn.render_image(world, Twc, cam.fx, cam.fy, cam.cx, cam.cy, cam.height,
                                 cam.width).numpy()
        png.write_png(str(images / f"{i:06d}.png"), np.clip(np.round(img), 0, 255)
                      .astype(np.uint8), (i % 5,))
    out_j, out_t = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    monkeypatch.setattr(sys, "argv", ["train_vocabulary.py", str(images), "--out", out_j,
                                      "--k", str(K), "--depth", str(DEPTH)])
    with jax.enable_x64(False):        # as outside the test suite (see test_torch_frame)
        j_tool.main()
        paths = sorted(str(p) for p in images.iterdir())
        docs_j = []
        for p in paths:
            f = j_frame.extract_features(jnp.asarray(png.load_gray(p), jnp.float32),
                                         cam.height, cam.width, n_features=1000)
            docs_j.append(np.asarray(f.desc)[np.asarray(f.valid)])
    voc_t = t_tool.run(t_tool.parse_args([str(images), "--out", out_t, "--k", str(K),
                                          "--depth", str(DEPTH), "--device", "cpu"]))
    docs_t = t_tool.image_descriptors(paths, 1000, torch.device("cpu"))

    for dj, dt in zip(docs_j, docs_t):
        assert dj.shape == dt.shape and dt.dtype == np.uint32
        assert (dj == dt).all(1).mean() >= SAME_DESC_MIN
    voc_j = tree_vocab.TreeVocabulary.load(out_j, device="cpu")
    same_input = tree_vocab.train_vocabulary(np.concatenate(docs_j), k=K, depth=DEPTH,
                                             idf_docs=docs_j, device="cpu")
    assert same_input.checksum() == voc_j.checksum()
    assert voc_t.checksum() == tree_vocab.TreeVocabulary.load(out_t, device="cpu").checksum()

    d0 = docs_t[0]
    err = []
    for voc in (voc_j, voc_t):
        words = voc.words(torch.as_tensor(d0.view(np.int32))).numpy()
        err.append(_popcount(d0 ^ voc.levels_u32()[-1][words]).mean())
    assert abs(err[0] - err[1]) <= QUANT_REL_TOL * err[0], err
