"""Reading a ``torch.profiler`` trace of the solve: the card's operations, the
benchmark's own spans, the busy time, and the idle gaps labelled by what the
host was doing.

Device operations are the trace's kernels, copies and sets on the card (a
copy's or a set's name starts with ``Memcpy`` / ``Memset``); the device-side
copies of the benchmark's ``record_function`` ranges are left out, since they
cover the work inside them. Times are kineto's, one clock for the host and
the card, in nanoseconds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Trace(NamedTuple):
    device_ops: list    # (name, start_ns, end_ns, is_kernel), sorted by start
    spans: list         # (name, start_ns, end_ns) of the benchmark's record_function spans
    host_ops: list      # (name, start_ns, end_ns) on the thread that ran the spans


def read(prof, span_prefix: str) -> Trace:
    """The parts of ``prof`` (a finished ``torch.profiler.profile``) that the
    readers use; ``span_prefix`` picks the benchmark's spans, whose
    device-side ranges are left out of the card's operations."""
    device, spans, host = [], [], []
    span_threads = set()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, end, thread = e.start_ns(), e.end_ns(), e.start_thread_id()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not name.startswith(span_prefix):
                device.append((name, start, end, not name.startswith(("Memcpy", "Memset"))))
        else:
            host.append((name, start, end, thread))
            if name.startswith(span_prefix):
                spans.append((name, start, end))
                span_threads.add(thread)
    device.sort(key=lambda d: d[1])
    spans.sort(key=lambda s: s[1])
    host = [(n, s, t) for n, s, t, th in host if th in span_threads]
    host.sort(key=lambda h: (h[1], -h[2]))
    return Trace(device, spans, host)


def within(trace: Trace, lo: int, hi: int) -> list:
    """Device operations that start inside [lo, hi]."""
    return [d for d in trace.device_ops if lo <= d[1] <= hi]


def busy_ns(ops: list, lo: int, hi: int) -> int:
    """The union of the operations' intervals, clipped to [lo, hi]."""
    total, cur_lo, cur_hi = 0, None, None
    for _, a, b, _ in ops:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    return total + (0 if cur_hi is None else cur_hi - cur_lo)


def idle_gaps(trace: Trace, lo: int, hi: int) -> list:
    """The stretches of [lo, hi] with nothing on the card, as (start, end)."""
    gaps, t = [], lo
    for _, a, b, _ in within(trace, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def label_gaps(trace: Trace, gaps: list) -> list:
    """Each gap with the innermost host operation running at its middle on
    the spans' thread ("host idle" where none ran)."""
    mids = sorted((a + b) // 2 for a, b in gaps)
    order = sorted(range(len(gaps)), key=lambda i: (gaps[i][0] + gaps[i][1]) // 2)
    labels = [None] * len(gaps)
    stack, j, host = [], 0, trace.host_ops
    for rank, t in enumerate(mids):
        while j < len(host) and host[j][1] <= t:
            while stack and stack[-1][2] <= host[j][1]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        labels[order[rank]] = stack[-1][0] if stack else "host idle"
    return [(labels[i], gaps[i][0], gaps[i][1]) for i in range(len(gaps))]


def top(pairs: dict, n: int = 10) -> list:
    """The n largest entries of {name: seconds}, as [[name, seconds], ...]."""
    return [[k, v] for k, v in sorted(pairs.items(), key=lambda kv: -kv[1])[:n]]
