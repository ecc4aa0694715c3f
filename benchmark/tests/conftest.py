"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
repository's root (the repository's `tests/` run apart). The cuda-marked
tests decide in a fixture whether a card is there."""

import sys
from pathlib import Path

import pytest

for p in (Path(__file__).resolve().parents[2], Path(__file__).resolve().parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    return "cuda"
