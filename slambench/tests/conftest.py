"""The benchmark's own tests: ``python -m pytest slambench/tests -q`` from the
repository's root (the suite's ``pytest tests/`` does not collect them).
Tests that need a card carry the ``gpu`` marker and skip from the ``card``
fixture where there is none."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
