"""The problems the benchmark's cells solve: one module per kind of solve.

A configuration (``slambench/configs/<config>.json``) names its problem in
the key ``"problem"``; ``run.load_problem`` loads
``slambench/problems/<problem>.py`` by its path, as ``run.load_reader``
loads a metric's reader. A new kind of deployment therefore comes as new
files only: its problem module, its configuration, its workload and its
metric readers. ``run.py`` and ``calibrate.py`` reach the map generator, the
program, the plain reference and the comparison only through the problem.

A problem module gives:

* ``SPAN_SOLVE``: the name of the benchmark's own host span around one solve;
  its host windows, after the traced solves, make ``gba_solve_s``, and the
  readers find the card-only traced solve by its first occurrence.
* ``SPAN_PREFIX``: the prefix of every span the benchmark and the program
  record inside a solve; ``devtrace.read`` leaves their device-side ranges
  out of the card's operations.
* ``REFERENCE``: the path of the plain reference's file, which the benchmark's
  tests hold to importing neither JAX nor anything of the program.
* ``make_map(config, cell, seed) -> dict``: the map, numpy arrays only; one
  seed gives one map, bit for bit.
* ``Solver(config, cell, maparr, device)``: the system under test on that
  map. ``warm()`` runs every shape the window runs once and sets
  ``shapes`` (a dict of numbers, handed to the readers); ``solve(spans)``
  runs one whole solve, appends its ``(name, start, end)`` host spans to
  ``spans`` (``SPAN_SOLVE`` among them) and returns its answer, ``out``, on
  the host.
* ``reference(config, cell, maparr, device, stats, control=False)``: the
  plain reference, float64, importing nothing of the program and built from
  ``maparr`` alone; it may fill the dict ``stats`` with what ``unchanged``
  needs. With ``control`` it returns instead the answer of the control (the
  reference in the nearest precision below the configuration's), in the
  form of the program's ``out``, which ``calibrate.py --control`` reads.
* ``NAMES``: the numbers compared, in the order they are printed. The
  cell's ``limits`` hold exactly these keys; a run whose cell differs names
  the keys and exits non-zero before set-up.
* ``gaps(out, ref) -> dict``: each of ``NAMES`` for one answer against the
  reference; a number that is not finite exceeds every limit.
* ``unchanged(maparr, stats, ref) -> dict``: the same numbers for the map as
  handed over, which has to fail at least one limit.
* ``faults(solver, out, ref) -> dict``: the faults planted in the program at
  the cell's size, each a name and its ``gaps``, for ``calibrate.py
  --faults``; the solver's later solves are sound again.

The configuration's ``"reference"`` key names the same file as
``REFERENCE`` (the tests hold the two equal). The cell's ``limits`` are set from ``calibrate.py``'s readings at the cell's own
size (the program's largest over a dozen seeds and more, the control's
smallest); a roofline share is counted from ``Solver.shapes`` by a reader of
the problem's own, which can reach the problem as ``rec["problem"]``.
"""
