"""Stage-level timing (counterpart of ``orb_slam3_rgbl_tpu.utils.profiling``;
the reference's ``REGISTER_TIMES``, ``Tracking::PrintTimeStats``).

Every stage records host-clock samples under the reference's taxonomy;
``report()`` prints n / mean / std / median per stage. Device work is
asynchronous: with ``sync=True`` a stage that is handed its result
(``stage(name, result)``) synchronizes the CUDA stream current on the
calling thread, the System's stream for that thread, before it stops the
clock (the JAX package's ``block_until_ready``). The stages sit beside the
``torch.profiler.record_function`` spans of the same names; a profiler
trace gives their device time.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

# the reference's stage taxonomy (Tracking::PrintTimeStats)
STAGES = (
    "rect", "resize", "orb_extract", "depth_module", "stereo_match",
    "imu_integration", "pose_pred", "lm_track", "new_kf",
    "kf_insert", "mp_cull", "mp_create", "lba", "kf_cull",
    "pr", "sim3", "loop_fusion", "opt_essential", "gba",
)


class StageTimer:
    def __init__(self, sync: bool = False):
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self.sync = sync

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and isinstance(result, torch.Tensor) and result.is_cuda:
                torch.cuda.current_stream(result.device).synchronize()
            self.samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self.samples[name].append(seconds)

    def stats(self) -> Dict[str, dict]:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs) * 1e3
            out[name] = {"n": len(xs), "mean_ms": float(a.mean()), "std_ms": float(a.std()),
                         "median_ms": float(np.median(a))}
        return out

    def report(self) -> str:
        lines = [f"{'stage':<16}{'n':>6}{'mean ms':>10}{'std':>8}{'median':>9}"]
        for name, s in sorted(self.stats().items()):
            lines.append(f"{name:<16}{s['n']:>6}{s['mean_ms']:>10.2f}{s['std_ms']:>8.2f}"
                         f"{s['median_ms']:>9.2f}")
        return "\n".join(lines)


def save_stats(timer: StageTimer, path: str):
    """Per-stage statistics to a text file (the reference's
    ``ExecMean.txt``)."""
    with open(path, "w") as f:
        f.write(timer.report() + "\n")
    return path


def stage(timer, name: str):
    """``timer.stage(name)``, or nothing where no timer is set."""
    return timer.stage(name) if timer is not None else contextlib.nullcontext()
