"""Runs one cell of the benchmark once and prints its result as the last line
of standard output:

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``slambench/workloads/<cell>.json``; it names its configuration,
``slambench/configs/<config>.json``, and the configuration names its problem,
``slambench/problems/<problem>.py``, which is loaded by its path: the map
generator, the system under test, the plain reference and the numbers
compared, in the roles that ``slambench/problems/__init__.py`` sets out (the
visual whole-map bundle adjustment is ``visual_gba``). A new kind of cell
thus comes as new files alone. Set-up makes the map from the seed, hands it
to the problem's solver and warms it; the window then runs whole solves back
to back on the same map until ``--seconds`` have passed, letting the last one
finish. Where the cell reports the card's busy seconds a solve
(``gba_card_busy_s``), each solve of the window runs under ``torch.profiler``
on the card alone and the union of its operations' intervals is summed over
the window. With ``--trace 1`` one solve is first traced on the card alone and
the next on the host and the card (for what the host did while the card
idled), the window's solves following untraced, and the per-layer metrics
that ``BENCHMARK.json`` lists for the cell are read from it by their readers,
``slambench/metrics/<metric>.py``. After the window the problem's plain
reference (float64) solves the same map and every solve of the window is
compared with it against the cell's limits; the run is correct only where
the map as handed over fails them. Set-up's stages are logged on standard
error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the port builds nothing on this path; should anything build, it builds here
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(ROOT / ".slambench_cache" / _dir)
# the machine's Python may be told to keep no bytecode (PYTHONDONTWRITEBYTECODE):
# torch's modules would then compile from source in every run, seconds of
# set-up that swing with the host's load; their bytecode is kept here instead
sys.pycache_prefix = str(ROOT / ".slambench_cache" / "pycache")
sys.dont_write_bytecode = False
# one host thread for numpy and torch's CPU ops: the solve's host side is one
# Python thread launching kernels, and idle worker threads only add jitter
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam3_rgbl_tpu")
# the end-to-end metric of the card's busy seconds a solve
CARD_BUSY = "gba_card_busy_s"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str):
    """(cell, config) of a workload, found by name."""
    cell = load_json(root / "slambench" / "workloads" / f"{name}.json")
    return cell, load_json(root / "slambench" / "configs" / f"{cell['config']}.json")


def metrics_for(bench: dict, cell: str, kind: str) -> list:
    """The metrics of ``BENCHMARK.json``'s ``kind`` list that this cell reports."""
    return [m for m in bench.get(kind, []) if cell in m.get("workloads", [cell])]


def load_reader(root: Path, name: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``; a metric split
    by the end-to-end metric it moves, ``<base>.<suffix>``, reads with its
    base's reader where it has none of its own."""
    path = root / "slambench" / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_problem(root: Path, config: dict):
    """The problem module that ``config`` names: ``problems/<problem>.py``,
    loaded by its path."""
    name = config["problem"]
    path = root / "slambench" / "problems" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slambench_problem_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def limits_mismatch(problem, limits: dict) -> str:
    """'' where the cell's limits hold exactly the problem's compared
    numbers, else which keys differ."""
    missing = [k for k in problem.NAMES if k not in limits]
    extra = sorted(set(limits) - set(problem.NAMES))
    return "; ".join(f"{what}: {', '.join(keys)}" for what, keys in
                     (("no limit for", missing), ("limits for no compared number", extra)) if keys)


def passes(g: dict, limits: dict, names) -> bool:
    return all(math.isfinite(g[k]) and g[k] <= limits[k] for k in names)


def worst(all_gaps: list, names) -> dict:
    """The largest reading of each number over the compared results (one
    that is not finite counts as the largest)."""
    out = {}
    for k in names:
        vals = [g[k] for g in all_gaps]
        out[k] = float("nan") if any(not math.isfinite(v) for v in vals) else max(vals)
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def traced_solve(solver, spans: list, outs: list, dev, card_only: bool, span_prefix: str):
    """One solve under ``torch.profiler``: the card alone (its busy time and
    kernels), or the host and the card (what the host did while the card
    idled). The solve's result joins ``outs``."""
    import torch
    act = [torch.profiler.ProfilerActivity.CUDA]
    if not card_only:
        act.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=act) as prof:
        if card_only:
            torch.ones(1).to(dev)          # marks the solve's start on the card
        outs.append(solver.solve(spans))
    from slambench import devtrace
    return devtrace.read(prof, span_prefix)


def card_busy_solve(solver, spans: list, outs: list, span_prefix: str) -> int:
    """One solve of the window with the profiler on the card alone: its
    result joins ``outs``; returns the card's busy nanoseconds in it (the
    union of its operations' intervals)."""
    import torch
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        outs.append(solver.solve(spans))
    from slambench import devtrace
    ops = devtrace.read(prof, span_prefix).device_ops
    return devtrace.busy_ns(ops, ops[0][1], max(op[2] for op in ops)) if ops else 0


def main(argv=None, root: Path = ROOT, device=None) -> int:
    """Runs the cell; returns the exit code. ``device`` (tests only) names
    the device and skips the look for a card."""
    args = parse(argv)
    import torch

    stages, t_lap = {"imports": time.perf_counter() - T0}, time.perf_counter()

    def lap(name):
        nonlocal t_lap
        now = time.perf_counter()
        stages[name], t_lap = now - t_lap, now

    bench = load_json(root / "BENCHMARK.json")
    cell, config = load_cell(root, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            log(f"needs {cell['chips']} CUDA card(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = "cuda:0"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.empty(1, device=dev)             # the card's context
    lap("card")

    from slambench import devtrace

    problem = load_problem(root, config)
    limits = cell["limits"]
    wrong = limits_mismatch(problem, limits)
    if wrong:
        log(f"{args.workload}: the cell's limits are not the numbers that problem "
            f"{config['problem']} compares ({wrong})")
        return 6
    maparr = problem.make_map(config, cell, args.seed)
    lap("mapgen")
    solver = problem.Solver(config, cell, maparr, dev)
    lap("program_map")
    solver.warm()
    lap("warm")
    setup_s = time.perf_counter() - T0
    log(f"{args.workload}: set-up {setup_s:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f"), shapes {solver.shapes}")

    # a traced run first profiles the card alone over one solve, then the
    # host and the card over the next; the window's solves follow, untraced
    spans, outs = [], []
    dev_trace = host_trace = None
    if args.trace:
        dev_trace = traced_solve(solver, spans, outs, dev, True, problem.SPAN_PREFIX)
        if not dev_trace.device_ops:
            log("the card-only trace of a solve holds no device operation")
            return 5
        host_trace = traced_solve(solver, spans, outs, dev, False, problem.SPAN_PREFIX)
    n_traced = len(outs)

    # the window: whole solves back to back, the last one finishing; where
    # the cell reports the card's busy time each of them is profiled on the
    # card alone (a trace-0 run only: a traced run's window stays untraced)
    e2e = [] if args.trace else metrics_for(bench, args.workload, "end_to_end")
    card = any(m["name"].split(".")[0] == CARD_BUSY for m in e2e)
    busy = []
    t_start = time.perf_counter()
    while True:
        if card:
            busy.append(card_busy_solve(solver, spans, outs, problem.SPAN_PREFIX))
        else:
            outs.append(solver.solve(spans))
        if time.perf_counter() - t_start >= args.seconds:
            break
    window_s = time.perf_counter() - t_start
    solve_times = [t1 - t0 for name, t0, t1 in spans if name == problem.SPAN_SOLVE][n_traced:]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    shapes = solver.shapes
    del solver
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # per-layer metrics of the traced run: the card-only traced solve, from
    # its first operation on the card to its last
    solve_window = None
    if dev_trace is not None:
        solve_window = (dev_trace.device_ops[0][1], max(op[2] for op in dev_trace.device_ops))
    rec = dict(host_spans=spans, trace=dev_trace, solve_window=solve_window, shapes=shapes,
               schedule=cell.get("schedule"), problem=problem, n_traced=n_traced)
    metrics, extra, breakdown = {}, {}, None
    if args.trace:
        for m in metrics_for(bench, args.workload, "per_layer"):
            v = load_reader(root, m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        lo, hi = solve_window
        ops = dev_trace.device_ops
        extra["busy_s"] = devtrace.busy_ns(ops, lo, hi) * 1e-9
        extra["window_s"] = (hi - lo) * 1e-9
        by_name, by_host = {}, {}
        for name, a, b, _ in ops:
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
        breakdown = {"device_ops": devtrace.top(by_name), "idle_gaps": []}
        solves = [sp for sp in host_trace.spans if sp[0] == problem.SPAN_SOLVE]
        if solves:
            hlo, hhi = solves[0][1], solves[0][2]
            for label, a, b in devtrace.label_gaps(host_trace,
                                                   devtrace.idle_gaps(host_trace, hlo, hhi)):
                by_host[label] = by_host.get(label, 0.0) + (b - a) * 1e-9
            breakdown["idle_gaps"] = devtrace.top(by_host)
    else:
        # a metric split by its cell (``<base>.<suffix>``) measures its base
        known = {"gba_solve_s": sum(solve_times) / len(solve_times), "setup_s": setup_s}
        if card:
            if not all(busy):
                log("a profiled solve of the window holds no device operation")
                return 5
            known[CARD_BUSY] = 1e-9 * sum(busy) / len(busy)
        for m in e2e:
            base = m["name"].split(".")[0]
            if base not in known:
                log(f"no end-to-end metric {m['name']} in this harness")
                return 4
            metrics[m["name"]] = {"value": known[base], "unit": m["unit"]}

    # the plain reference on the same map, then every solve against it; the
    # map as handed over has to fail the limits, or a solve that returns it
    # unchanged would pass
    t_ref = time.perf_counter()
    stats = {}
    ref = problem.reference(config, cell, maparr, dev, stats)
    names = problem.NAMES
    all_gaps = [problem.gaps(out, ref) for out in outs]
    failed = sum(not passes(g, limits, names) for g in all_gaps)
    most = worst(all_gaps, names)
    still = problem.unchanged(maparr, stats, ref)
    tells = not passes(still, limits, names)
    log(f"window: {len(outs)} solves in {window_s:.3f} s, "
        f"solve s {[round(t, 4) for t in solve_times]}"
        + (f", card busy s {[round(b * 1e-9, 5) for b in busy]}" if busy else "")
        + f"; reference {time.perf_counter() - t_ref:.3f} s"
        f" ({', '.join(f'{k} {v!r}' for k, v in stats.items())})")
    if not tells:
        log("the map as handed over passes every limit: on this map the comparison cannot tell "
            "a sound solve from one that returns the map unchanged, so the run is not correct")

    result = {
        "correct": failed == 0 and len(outs) > 0 and tells,
        "attempted": len(outs),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak), **extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    # each solve's worst reading must stay within its limit; the unchanged
    # map's must exceed at least one
    result["compared"] = {
        **{k: {"value": most[k], "limit": limits[k]} for k in names},
        **{f"unchanged_{k}": {"value": still[k], "limit": limits[k]} for k in names}}
    for k in names:
        log(f"compared {k} {most[k]!r} limit {limits[k]!r}")
    for k in names:
        log(f"compared unchanged_{k} {still[k]!r} limit {limits[k]!r} (one must exceed)")
    found = forbidden_modules()
    if found:
        log(f"the run loaded {', '.join(found)}: the port and the benchmark import no JAX")
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
