"""The card's busy seconds a solve (``gba_card_busy_s``: each solve of a
trace-0 run's window profiled on the card alone) and the whole solve's host
seconds (``solve_wall_s``: the untraced solves of a traced run's window).
On the CPU a stand-in for the profiler gives each solve a made-up trace: the
busy time is the union of the card's operations without the benchmark's
spans, a solve with nothing on the card ends the run without a result, and
a traced run's window is not profiled. On a card the busy time is above 0
and under the solve's own length."""

import json

import pytest
import torch

from slambench import run
from slambench.problems import visual_gba
from small import ROOT, small_cell, small_root

CELL = "euroc_mh_stereo_map.gba_one_call"


def _rec(spans, n_traced):
    return dict(host_spans=spans, problem=visual_gba, n_traced=n_traced)


def test_solve_wall_reads_the_untraced_solves():
    spans = [("gba.solve", 0.0, 3.0), ("gba.assemble", 0.0, 0.5), ("gba.solve", 3.0, 7.0),
             ("gba.solve", 7.0, 7.5), ("gba.assemble", 7.0, 7.1), ("gba.solve", 7.5, 8.5)]
    read = run.load_reader(ROOT, "solve_wall_s.launch_paced")
    assert read(_rec(spans, 2)) == pytest.approx((0.5 + 1.0) / 2)
    assert read(_rec(spans, 0)) == pytest.approx(8.5 / 4)
    assert read(_rec(spans[:3], 2)) is None


class _Event:
    def __init__(self, name, start, end, device):
        self._v = (name, start, end, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def start_thread_id(self):
        return 1

    def device_type(self):
        return self._v[3]


class _Profile:
    """Stands in for ``torch.profiler.profile`` where no card is: a solve's
    trace holds two overlapping kernels (3 ms busy together), a copy and
    the benchmark's own span on the card, which is left out."""
    kernels = True

    def __init__(self, activities):
        self.profiler = self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        cuda, t = torch.autograd.DeviceType.CUDA, 1_000_000_000
        self.kineto_results = self
        self._events = [_Event("gba.solve", t, t + 50_000_000, cuda)] + (
            [_Event("k1", t + 1_000_000, t + 3_000_000, cuda),
             _Event("k2", t + 2_000_000, t + 3_500_000, cuda),
             _Event("Memcpy DtoH", t + 5_000_000, t + 5_500_000, cuda)]
            if self.kernels else [])
        return False

    def events(self):
        return self._events


def _card_root(tmp_path):
    """A checkout whose small EuRoC cell reports the card's busy time and
    the whole solve's host seconds."""
    name = small_root(tmp_path, CELL, n_keyframes=6, landmarks_per_kf=60)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in (run.CARD_BUSY, "solve_wall_s.launch_paced"):
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return name


def _run(tmp_path, capsys, name, trace):
    torch.set_num_threads(2)
    rc = run.main(["--workload", name, "--seed", "11", "--seconds", "0.1", "--trace", trace],
                  root=tmp_path, device="cpu")
    out, err = capsys.readouterr()
    return rc, out, err


def test_the_busy_time_of_each_window_solve(tmp_path, capsys, monkeypatch):
    name = _card_root(tmp_path)
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    rc, out, err = _run(tmp_path, capsys, name, "0")
    assert rc == 0, err
    r = json.loads(out.strip().splitlines()[-1])
    assert r["correct"] and set(r["metrics"]) == {run.CARD_BUSY, "setup_s"}
    # the union of k1, k2 and the copy, without the span: 2.5 + 0.5 ms
    assert r["metrics"][run.CARD_BUSY]["value"] == pytest.approx(3.0e-3)


def test_a_window_solve_with_nothing_on_the_card_gives_no_result(tmp_path, capsys, monkeypatch):
    name = _card_root(tmp_path)
    monkeypatch.setattr(_Profile, "kernels", False)
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    rc, out, err = _run(tmp_path, capsys, name, "0")
    assert rc == 5 and out == "" and "no device operation" in err


def test_a_traced_run_leaves_its_window_unprofiled(tmp_path, capsys, monkeypatch):
    """A traced run reports per-layer metrics only: its window's solves run
    without the profiler, and ``solve_wall_s`` reads them."""
    name = _card_root(tmp_path)
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    monkeypatch.setattr(run, "card_busy_solve", lambda *a: pytest.fail("window profiled"))
    rc, out, err = _run(tmp_path, capsys, name, "1")
    assert rc == 0, err
    r = json.loads(out.strip().splitlines()[-1])
    assert set(r["metrics"]) == {"solve_wall_s.launch_paced"} and r["attempted"] >= 3
    assert r["metrics"]["solve_wall_s.launch_paced"]["value"] > 0


@pytest.mark.gpu
def test_busy_time_on_the_card(card):
    cell, config = small_cell(CELL, 6, 60)
    problem = run.load_problem(ROOT, config)
    solver = problem.Solver(config, cell, problem.make_map(config, cell, 11), card)
    solver.warm()
    spans, outs = [], []
    busy = [run.card_busy_solve(solver, spans, outs, problem.SPAN_PREFIX) for _ in range(2)]
    walls = [t1 - t0 for n, t0, t1 in spans if n == problem.SPAN_SOLVE]
    assert len(outs) == 2 and all(0 < b * 1e-9 < w for b, w in zip(busy, walls))
