"""The benchmark's own tests: ``python -m pytest perfbench/tests``.  They
run on the CPU at small sizes; the cases marked ``cuda`` need the card
and skip without one."""

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# the small CPU runs are single-threaded work; a pool of threads only
# contends for cores a shared host may not give
torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, os.path.dirname(HERE))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
