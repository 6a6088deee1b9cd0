"""The spans of the whole-map bundle adjustment (``utils/profiling.tracer``).

Under ``torch.profiler`` a solve of 2 LM iterations × 3 CG steps logs one
``gba.lm`` root holding, in order, ``gba.linearize``, ``gba.precond``, three
``gba.cg_step`` and ``gba.accept`` per iteration, then ``gba.final``; the
inertial solve, the same loop, also logs ``gba.imu_linearize`` inside each
``gba.linearize``;
``build_full_problem`` logs ``gba.build`` around ``gba.gather`` and
``PoseSegments`` logs ``gba.segments``. The profiler's own events carry the
same names. Traced or not, the solve gives the same bits. Without a profiler
nothing is logged and ``record_function`` is never entered. On the CPU no
span has a device window."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from orb_slam3_rgbl_tpu_torch import synthetic
from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera
from orb_slam3_rgbl_tpu_torch.optim import global_ba, global_inertial_ba
from orb_slam3_rgbl_tpu_torch.slam import ba_assembly
from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState
from orb_slam3_rgbl_tpu_torch.utils import profiling

CAM = PinholeCamera(fx=718.856, fy=718.856, cx=607.19, cy=185.22, width=1241, height=376,
                    bf=386.14)
LM_STAGES = (["gba.linearize", "gba.precond"] + ["gba.cg_step"] * 3 + ["gba.accept"]) * 2 \
    + ["gba.final"]
VI_STAGES = (["gba.linearize", "gba.imu_linearize", "gba.precond"] + ["gba.cg_step"] * 3
             + ["gba.accept"]) * 2 + ["gba.final"]


@pytest.fixture(scope="module")
def problem():
    prob, _, _ = synthetic.synth_gba_problem(12, 200, 4, CAM, seed=3, device="cpu")
    return prob, global_ba.PoseSegments(prob.obs_kf, prob.obs_mask, prob.poses.shape[0])


@pytest.fixture(scope="module")
def vi_problem():
    """A small stereo-inertial map's whole-map problem, built as
    ``test_torch_global_inertial_ba`` builds it: (problem, segments, camera)."""
    import test_torch_global_inertial_ba as t
    from slambench.problems import vi_gba
    cell, config = t.small()
    solver = vi_gba.Solver(config, cell, vi_gba.make_map(config, cell, t.SEED),
                           torch.device("cpu"))
    return (*solver._assemble(), solver.cam)


def _solve(problem):
    prob, seg = problem
    return global_ba.global_bundle_adjust(prob, CAM, seg, iterations=2, cg_iters=3,
                                          huber_iters=1)


def _solve_vi(vi_problem):
    prob, seg, cam = vi_problem
    return global_inertial_ba.global_inertial_bundle_adjust(prob, cam, seg, iterations=2,
                                                            cg_iters=3, huber_iters=1)


@pytest.fixture(params=["visual", "inertial"])
def solve(request):
    """(a solve of 2 LM iterations × 3 CG steps, the stages it logs in order)."""
    if request.param == "visual":
        problem = request.getfixturevalue("problem")
        return (lambda: _solve(problem)), LM_STAGES
    vi = request.getfixturevalue("vi_problem")
    return (lambda: _solve_vi(vi)), VI_STAGES


def _small_map(seed: int = 0) -> MapState:
    """Six keyframes of 20 features, each bound to one of 30 landmarks or none."""
    rng = np.random.default_rng(seed)
    K, N, M = 6, 20, 30
    m = MapState.create(8, 64, N)
    m.kf_pose[:K, 4:7] = rng.normal(0, 1, (K, 3))
    m.kf_valid[:K] = True
    m.kf_frame_id[:K] = np.arange(K)
    m.kf_uv[:K] = rng.uniform(0, 300, (K, N, 2))
    m.kf_octave[:K] = rng.integers(0, 8, (K, N))
    m.kf_feat_valid[:K] = True
    m.kf_lm_idx[:K] = np.where(rng.random((K, N)) < 0.7, rng.integers(0, M, (K, N)), -1)
    m.lm_pos[:M] = rng.normal(0, 5, (M, 3))
    m.lm_valid[:M] = True
    m.n_kf, m.n_lm = K, M
    return m


def _profiled(fn):
    """``fn()`` under a CPU profiler: (its result, the spans it logged, the profiler)."""
    before = len(profiling.span_log())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, profiling.span_log()[before:], prof


def test_solve_logs_its_stages_in_order(solve):
    run, expected = solve
    _, spans, _ = _profiled(run)
    roots = [s for s in spans if s.name == "gba.lm"]
    assert len(roots) == 1 and roots[0].parent is None
    root = roots[0].root
    # by start; on a tie an enclosing stage before what it encloses
    logged = sorted((s for s in spans if s.name != "gba.lm"),
                    key=lambda s: (s.start, s.parent != "gba.lm"))
    assert [s.name for s in logged] == expected
    inner = [s for s in logged if s.name == "gba.imu_linearize"]
    stages = [s for s in logged if s.name != "gba.imu_linearize"]
    assert all(s.parent == "gba.lm" and s.root == root for s in stages)
    # the pairs' linearization inside each linearization
    lins = [s for s in stages if s.name == "gba.linearize"]
    assert all(i.parent == "gba.linearize" and i.root == root and l.start <= i.start
               and i.end <= l.end for i, l in zip(inner, lins))
    # the stages follow one another inside the root's window
    assert roots[0].start <= stages[0].start and stages[-1].end <= roots[0].end
    assert all(a.end <= b.start for a, b in zip(stages, stages[1:]))
    # the counters the readers divide by: CG steps and LM iterations
    assert sum(s.name == "gba.cg_step" for s in stages) == 6
    assert sum(s.name == "gba.linearize" for s in stages) == 2


def test_assembly_logs_build_around_gather_and_segments():
    def assemble():
        prob, *_ = ba_assembly.build_full_problem(_small_map(), np.ones(8, np.float32),
                                                  max_obs=4, min_pose_tier=1, min_lm_tier=1,
                                                  device="cpu")
        return global_ba.PoseSegments(prob.obs_kf, prob.obs_mask, prob.poses.shape[0])

    _, spans, _ = _profiled(assemble)
    by_name = {s.name: s for s in spans}
    assert sorted(by_name) == ["gba.build", "gba.gather", "gba.segments"] and len(spans) == 3
    build, gather, seg = by_name["gba.build"], by_name["gba.gather"], by_name["gba.segments"]
    assert build.parent is None and gather.parent == "gba.build" and gather.root == build.root
    assert build.start <= gather.start <= gather.end <= build.end
    assert seg.parent is None and seg.root != build.root and build.end <= seg.start


def test_profiler_events_carry_the_same_names(problem):
    _, spans, prof = _profiled(lambda: _solve(problem))
    names = [e.name for e in prof.events() if e.name.startswith("gba.")]
    assert sorted(names) == sorted(s.name for s in spans)


def test_traced_solve_gives_the_same_bits(solve):
    run, _ = solve
    plain = run()
    traced, _, _ = _profiled(run)
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_untraced_calls_log_nothing_and_open_no_range(problem, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    before = len(profiling.span_log())
    _solve(problem)
    prob, *_ = ba_assembly.build_full_problem(_small_map(), np.ones(8, np.float32), max_obs=4,
                                              min_pose_tier=1, min_lm_tier=1, device="cpu")
    global_ba.PoseSegments(prob.obs_kf, prob.obs_mask, prob.poses.shape[0])
    assert len(profiling.span_log()) == before
    # one shared null context, whatever the span
    span = profiling.tracer(torch.device("cpu"))
    assert span("gba.lm") is span("gba.cg_step")


def test_no_device_window_on_the_cpu(problem):
    _, spans, _ = _profiled(lambda: _solve(problem))
    assert spans and all(s.device_ms is None for s in spans)
    assert all(s.end >= s.start for s in spans)


def test_another_thread_logs_nothing(problem):
    """The profiler traces the thread that started it: a solve on another
    thread meanwhile takes the null path, and the traced thread's root holds
    only its own stages."""
    def both():
        t = threading.Thread(target=_solve, args=(problem,))
        t.start()
        _solve(problem)
        t.join(timeout=60)
        assert not t.is_alive()

    _, spans, _ = _profiled(both)
    assert [s.name for s in spans].count("gba.lm") == 1
    assert sorted(s.name for s in spans if s.name != "gba.lm") == sorted(LM_STAGES)
