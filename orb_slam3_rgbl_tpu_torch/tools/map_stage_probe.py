"""Mapping-plane stage timing on an idle device (counterpart of the root
``tools/map_stage_probe.py``): load a map saved by
``utils/serialization.save_map``, build the mapping plane on it, run one
whole job on the keyframe before the last ``n_reps`` (warm-up), then time
triangulation, fusion and local BA of each of the last ``n_reps`` keyframes
alone, each clock read after ``torch.cuda.synchronize()``: what each stage
costs with nothing else queued, the floor under the engine's per-stage
times.

    python -m orb_slam3_rgbl_tpu_torch.tools.map_stage_probe <map.npz> [n_reps] \\
        [--device cuda|cpu]

Prints the stage table (``idle_tri``, ``idle_fuse``, ``idle_lba`` and the
warm-up job's stages) to stderr; the map is taken as made with the KITTI
RGB-L settings (``kitti_rgbl_config``), as the JAX tool takes it.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("map", help="a map saved by save_map")
    ap.add_argument("n_reps", nargs="?", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from orb_slam3_rgbl_tpu_torch.config import kitti_rgbl_config
    from orb_slam3_rgbl_tpu_torch.device import resolve
    from orb_slam3_rgbl_tpu_torch.slam.local_mapping import LocalMapper
    from orb_slam3_rgbl_tpu_torch.utils import serialization
    from orb_slam3_rgbl_tpu_torch.utils.profiling import StageTimer

    device = resolve(args.device)

    def clock() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    cfg = kitti_rgbl_config()
    m = serialization.load_map(args.map)
    mapper = LocalMapper(cfg, m, device=device)
    timer = StageTimer()
    mapper.timer = timer
    kfs = m.valid_kf_ids()
    print(f"map: {len(kfs)} KFs, {int(m.lm_valid.sum())} landmarks, device {device}",
          file=sys.stderr)

    # one whole job first: the device cache filled, cuSOLVER started
    tail = [int(k) for k in kfs[-args.n_reps - 1:]]
    mapper.process_keyframe(tail[0])
    for kf in tail[1:]:
        t0 = clock()
        mapper._triangulate_new_points(kf)
        t1 = clock()
        mapper._search_in_neighbors(kf)
        t2 = clock()
        mapper.local_bundle_adjustment(kf)
        t3 = clock()
        timer.record("idle_tri", t1 - t0)
        timer.record("idle_fuse", t2 - t1)
        timer.record("idle_lba", t3 - t2)
    print(timer.report(), file=sys.stderr)
    return timer


if __name__ == "__main__":
    main()
