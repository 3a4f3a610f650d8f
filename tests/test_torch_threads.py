"""The port's tests run under one thread policy (``one_thread`` in the
repository's root ``conftest.py``): a module fixture and a test both see
one torch intra-op thread, one thread in every pool ``threadpoolctl``
lists, and the thread variables at 1 for the subprocesses they start."""

import os

import pytest
import threadpoolctl
import torch

ONE = {"torch": 1, "pools": [1], "environment": ["1", "1", "1"]}


def _threads():
    return {
        "torch": torch.get_num_threads(),
        "pools": sorted({pool["num_threads"] for pool in threadpoolctl.threadpool_info()}),
        "environment": [os.environ.get(name) for name in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")],
    }


@pytest.fixture(scope="module")
def fixture_threads():
    return _threads()


def test_a_test_and_its_module_fixture_run_on_one_thread(fixture_threads):
    assert fixture_threads == ONE
    assert _threads() == ONE
