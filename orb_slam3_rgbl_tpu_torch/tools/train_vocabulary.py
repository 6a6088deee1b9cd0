"""Train a hierarchical binary vocabulary from an image folder (counterpart of
the root ``tools/train_vocabulary.py``): the replacement for the reference's
``Vocabulary/ORBvoc.txt`` (DBoW2 ``TemplatedVocabulary::create``), which no
machine here holds.

The descriptors come from the port's own extractor
(``slam/frame.extract_features``: K1 and K2 on the card), so that the
vocabulary sees what tracking sees; then hierarchical k-medians
(``retrieval/tree_vocab.train_vocabulary``) and ``.save``.

    python -m orb_slam3_rgbl_tpu_torch.tools.train_vocabulary <image_dir> \\
        [--out vocab.npz] [--k 10] [--depth 4] [--max-images 300] [--stride 1] \\
        [--n-features 1000] [--device cuda|cpu]

PNG only: the port decodes PNG itself (``io/png.py``) and the machine with
the card has no JPEG decoder. A folder without PNG images exits with a
message that says so.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("image_dir")
    ap.add_argument("--out", default="vocab.npz")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--max-images", type=int, default=300)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--n-features", type=int, default=1000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def image_descriptors(paths, n_features: int, device) -> list:
    """Per image (of the first image's size; others are skipped): its valid
    (N, 8) descriptors as uint32 words (the JAX package's layout)."""
    from orb_slam3_rgbl_tpu_torch.io import png
    from orb_slam3_rgbl_tpu_torch.slam import frame as frame_mod

    height, width = png.image_size(paths[0])
    docs = []
    for i, p in enumerate(paths):
        img = png.load_gray(p)
        if img.shape != (height, width):
            continue
        feats = frame_mod.extract_features(
            torch.as_tensor(img, dtype=torch.float32, device=device), height, width,
            n_features=n_features, device=device)
        valid = feats.valid.cpu().numpy()
        docs.append(feats.desc.cpu().numpy()[valid].view(np.uint32))
        if i % 25 == 0:
            print(f"[{i}/{len(paths)}] {int(valid.sum())} descriptors", file=sys.stderr)
    return docs


def run(args: argparse.Namespace):
    """Train and save the vocabulary; returns it."""
    from orb_slam3_rgbl_tpu_torch.device import resolve
    from orb_slam3_rgbl_tpu_torch.retrieval import tree_vocab

    device = resolve(args.device)
    paths = sorted(os.path.join(args.image_dir, f) for f in os.listdir(args.image_dir)
                   if f.lower().endswith(".png"))[::args.stride][: args.max_images]
    if not paths:
        raise SystemExit(f"no PNG images in {args.image_dir} (the port reads PNG only: "
                         "convert JPEG images to PNG first)")
    docs = image_descriptors(paths, args.n_features, device)
    all_desc = np.concatenate(docs)
    print(f"training on {len(all_desc)} descriptors from {len(docs)} images "
          f"(k={args.k}, depth={args.depth} -> {args.k ** args.depth} words)", file=sys.stderr)
    voc = tree_vocab.train_vocabulary(all_desc, k=args.k, depth=args.depth, idf_docs=docs,
                                      device=device)
    voc.save(args.out)
    print(f"saved {args.out} (md5 {voc.checksum()})", file=sys.stderr)
    return voc


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
