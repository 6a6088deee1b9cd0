"""Stage-level timing (counterpart of ``orb_slam3_rgbl_tpu.utils.profiling``;
the reference's ``REGISTER_TIMES``, ``Tracking::PrintTimeStats``) and the
program's spans.

Every stage records host-clock samples under the reference's taxonomy
(rect, resize, orb_extract, depth_module, stereo_match, imu_integration,
pose_pred, lm_track, new_kf, kf_insert, mp_cull, mp_create, lba, kf_cull,
pr, sim3, loop_fusion, opt_essential, gba); ``report()`` prints n / mean /
std / median per stage. Device work is asynchronous: with ``sync=True`` a
stage that is handed its result (``stage(name, result)``) synchronizes the
CUDA stream current on the calling thread, the System's stream for that
thread, before it stops the clock (the JAX package's
``block_until_ready``). The stages sit beside the
``torch.profiler.record_function`` spans of the same names; a profiler
trace gives their device time.

``tracer`` gives a function its spans: while a ``torch.profiler`` session is
active each span is a ``record_function`` range on the profiler's clock and
an entry of an in-memory log (``span_log``) with its host window on
``time.perf_counter()`` and, on the card, its device window between two CUDA
events on the current stream. While none is active a span is one shared
null context: nothing is recorded, launched or synchronized.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function


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


class Span(NamedTuple):
    """A closed span of the log. ``parent``: the name of the program span
    that enclosed it on its thread (None for a root); ``root``: the id of
    the outermost program span open then, shared by the spans of one call;
    ``start`` / ``end``: host seconds on ``time.perf_counter()``;
    ``device_ms``: the card's time from the span's entry to its exit on the
    stream current then (None off the card)."""
    name: str
    parent: Optional[str]
    root: int
    start: float
    end: float
    device_ms: Optional[float]


# the last spans closed while a profiler ran: (name, parent, root, start, end, events)
_LOG: deque = deque(maxlen=65536)
_ROOT_IDS = itertools.count()
_OPEN = threading.local()          # .stack: this thread's open spans, (name, root)
_NULL = contextlib.nullcontext()


def _untraced(name: str):
    return _NULL


class _Traced:
    # the CUDA events are the outermost calls of a span, so that the device
    # windows of consecutive spans meet: what the span itself costs the host
    # falls inside its own window
    __slots__ = ("name", "device", "rf", "parent", "root", "start", "ev0")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name, self.device, self.ev0 = name, device, None

    def __enter__(self):
        if self.device is not None:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(torch.cuda.current_stream(self.device))
        self.rf = record_function(self.name)
        self.rf.__enter__()
        stack = _OPEN.__dict__.setdefault("stack", [])
        self.parent, self.root = stack[-1] if stack else (None, next(_ROOT_IDS))
        stack.append((self.name, self.root))
        self.start = time.perf_counter()

    def __exit__(self, *exc):
        end = time.perf_counter()
        _OPEN.stack.pop()
        self.rf.__exit__(*exc)
        events = None
        if self.ev0 is not None:
            events = (self.ev0, torch.cuda.Event(enable_timing=True))
            events[1].record(torch.cuda.current_stream(self.device))
        _LOG.append((self.name, self.parent, self.root, self.start, end, events))


def tracer(device: torch.device) -> Callable[[str], contextlib.AbstractContextManager]:
    """The spans of one call of an instrumented function, decided once at
    its entry: ``span = tracer(dev)`` then ``with span("gba.lm"): ...``.
    While no ``torch.profiler`` session is active every span is the same
    null context."""
    if not torch.autograd._profiler_enabled():
        return _untraced
    dev = device if device.type == "cuda" else None
    return lambda name: _Traced(name, dev)


def span_log() -> List[Span]:
    """The log's spans, oldest first, with their device windows resolved
    (waiting for the card where a span's work has not finished)."""
    out = []
    for name, parent, root, start, end, events in list(_LOG):
        ms = None
        if events is not None:
            events[1].synchronize()
            ms = events[0].elapsed_time(events[1])
        out.append(Span(name, parent, root, start, end, ms))
    return out
