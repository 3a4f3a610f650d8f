"""Shared fixtures of the benchmark's own tests.

Run them with ``python -m pytest perfbench/tests -q``.  Tests marked
``card`` need a CUDA device: the ``card`` fixture skips them elsewhere
(decided when the test runs, never at import).  ``tiny`` loads a cell of
``BENCHMARK.json`` with its traffic shrunk to seconds-long tracks, for
rehearsals of a whole run on the CPU.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="session", autouse=True)
def few_threads():
    import torch

    torch.set_num_threads(2)


def shrink(cell):
    """The cell with seconds-long tracks: two targets, two references (a
    song cell), and the compared calls among the first two (a song cell)
    or the first call (a long form): a window of a second on the CPU
    always reaches the first."""
    traffic = cell.traffic
    if traffic["entry"] == "process":
        traffic.update(targets=2, references=2, target_seconds=[8, 12], reference_seconds=[8, 12],
                       compared=2, compare_among_first=2)
    else:
        traffic.update(target_seconds=10, reference_seconds=6, compare_among_first=1)
    return cell


@pytest.fixture
def tiny():
    from perfbench import harness

    return lambda name: shrink(harness.Cell.load(name))
