"""The thread policy of the port's tests (``tests/test_torch_*.py``).

The tier-1 run starts six pytest-xdist workers on one machine, and each
worker's torch intra-op pool and BLAS/OpenMP pools are as wide as the
machine: six such pools spin against each other, and the port's dense host
linear algebra (the smoothing operators' spline over an identity, the
folded LOWESS products) ran about 20 times slower than alone.  So each of
the port's tests runs, with the setup and teardown of its fixtures, under
``one_thread()``.  The JAX package's tests keep their pools: the policy is
undone after each test.  XLA's own CPU pools can only be set before JAX
starts, which ``tests/conftest.py`` does.

This file sits at the repository's root so that ``tests/conftest.py``
stays the one module ``from conftest import ...`` finds from ``tests/``.
"""

import contextlib
import os
import pathlib

import pytest

PORT_TESTS = pathlib.Path(__file__).resolve().parent / "tests"
THREAD_VARIABLES = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


@contextlib.contextmanager
def one_thread():
    """One torch intra-op thread, one thread in every pool ``threadpoolctl``
    finds (the BLAS and OpenMP runtimes behind numpy, scipy and torch), and
    ``THREAD_VARIABLES`` at 1 for the subprocesses started with this
    process's environment; each restored on exit."""
    import threadpoolctl
    import torch

    threads = torch.get_num_threads()
    saved = {name: os.environ.get(name) for name in THREAD_VARIABLES}
    with threadpoolctl.threadpool_limits(limits=1):
        torch.set_num_threads(1)
        os.environ.update(dict.fromkeys(THREAD_VARIABLES, "1"))
        try:
            yield
        finally:
            torch.set_num_threads(threads)
            for name, value in saved.items():
                if value is None:
                    os.environ.pop(name, None)
                else:
                    os.environ[name] = value


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    """A port test's setup, call and teardown under ``one_thread()``."""
    if item.path.parent != PORT_TESTS or not item.path.name.startswith("test_torch_"):
        yield
        return
    with one_thread():
        yield
