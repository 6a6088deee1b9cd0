"""The readers of the stage metrics (``cg_step_ms``, ``lm_outer_ms``,
``gather_ms``) on a made-up run: the port's span log stands in for a traced
solve, and only the spans inside the run's first ``gba.solve`` count. A
program that keeps no log, or logs nothing inside that solve, reads None."""

import pytest

from orb_slam3_rgbl_tpu_torch.utils import profiling
from slambench import run
from small import ROOT

NAMES = ["cg_step_ms", "lm_outer_ms", "gather_ms"]


def _span(name, start, end, device_ms, parent="gba.lm", root=1):
    return profiling.Span(name, parent, root, start, end, device_ms)


# one solve on [10, 20] s of the host clock: 2 LM iterations × 2 CG steps
SOLVE = [
    _span("gba.build", 10.0, 10.3, 0.5, parent=None, root=0),
    _span("gba.gather", 10.1, 10.25, 0.0, parent="gba.build", root=0),
    _span("gba.segments", 10.3, 10.4, 0.2, parent=None, root=2),
    _span("gba.lm", 10.4, 19.0, 90.0, parent=None),
    _span("gba.linearize", 10.5, 11.0, 4.0),
    _span("gba.precond", 11.0, 11.5, 2.0),
    _span("gba.cg_step", 11.5, 12.0, 3.0),
    _span("gba.cg_step", 12.0, 12.5, 5.0),
    _span("gba.accept", 12.5, 13.0, 3.0),
    _span("gba.linearize", 13.0, 13.5, 5.0),
    _span("gba.precond", 13.5, 14.0, 1.0),
    _span("gba.cg_step", 14.0, 14.5, 4.0),
    _span("gba.cg_step", 14.5, 15.0, 4.0),
    _span("gba.accept", 15.0, 15.5, 2.0),
    _span("gba.final", 15.5, 16.0, 1.0),
]
# the same solve traced again later, on host and card: left out
LATER = [s._replace(start=s.start + 20, end=s.end + 20, device_ms=100.0) for s in SOLVE]
REC = dict(host_spans=[("gba.solve", 9.9, 20.0), ("gba.assemble", 9.9, 10.5),
                       ("gba.solve", 29.9, 40.0)],
           trace=None, solve_window=None, shapes={}, schedule={"lm_iterations": 16,
                                                              "cg_steps": 64})


def _read(name):
    return run.load_reader(ROOT, name)(REC)


def test_the_three_values(monkeypatch):
    monkeypatch.setattr(profiling, "span_log", lambda: SOLVE + LATER)
    assert _read("cg_step_ms") == pytest.approx((3 + 5 + 4 + 4) / 4)
    # linearize + precond + accept over the 2 LM iterations counted
    assert _read("lm_outer_ms") == pytest.approx((4 + 2 + 3 + 5 + 1 + 2) / 2)
    assert _read("gather_ms") == pytest.approx(150.0)
    for name in NAMES:
        assert _read(f"{name}.launch_paced") == _read(name)


def test_none_with_no_log(monkeypatch):
    monkeypatch.delattr(profiling, "span_log")
    assert [_read(n) for n in NAMES] == [None] * 3


def test_none_with_nothing_inside_the_solve(monkeypatch):
    before = [s._replace(start=s.start - 9, end=s.end - 9) for s in SOLVE]
    monkeypatch.setattr(profiling, "span_log", lambda: before)
    assert [_read(n) for n in NAMES] == [None] * 3
    monkeypatch.setattr(profiling, "span_log", list)
    assert [_read(n) for n in NAMES] == [None] * 3


def test_device_metrics_none_off_the_card(monkeypatch):
    monkeypatch.setattr(profiling, "span_log",
                        lambda: [s._replace(device_ms=None) for s in SOLVE])
    assert _read("cg_step_ms") is None and _read("lm_outer_ms") is None
    assert _read("gather_ms") == pytest.approx(150.0)
