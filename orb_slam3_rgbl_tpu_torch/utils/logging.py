"""Leveled logger (counterpart of ``orb_slam3_rgbl_tpu.utils.logging``; the
reference's ``Verbose::PrintMess``, ``System.h:47-72``).

Messages at or below the current level go to ``file`` (stderr by default).
The level starts at ``QUIET``, as the reference sets it at startup
(``System.cc:247``), so the System prints nothing unless a caller raises it
with ``set_level``.
"""

from __future__ import annotations

import sys

QUIET = 0
NORMAL = 1
VERBOSE = 2
VERY_VERBOSE = 3
DEBUG = 4

_level = QUIET


def set_level(level: int):
    global _level
    _level = level


def log(msg: str, level: int = NORMAL, file=None):
    if level <= _level:
        print(msg, file=sys.stderr if file is None else file)
