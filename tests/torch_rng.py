"""The port's test modules leave torch's global random generator as they
found it.

A module that builds a model with torch's default initializers, or draws
with `torch.rand` and no generator, moves the global generator. Under
`--dist loadfile` several test files share a process, so a port module
would change what a later module draws: a golden test of the JAX package
that builds its torch reference with default initializers would see other
weights. Each `tests/test_torch_*.py` imports `keep_torch_rng`, which
saves the generator's state before the module's first test and restores
it after its last.

Importing `two_threads` runs a whole module on two intra-op threads (the
twins' forwards, steps and CLI runs are thousands of small ops);
`torch_threads` sets them for a block.
"""
import contextlib

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def keep_torch_rng():
    with torch.random.fork_rng(devices=[]):
        yield


# torch's intra-op threads as the process starts (a thread per core)
DEFAULT_THREADS = torch.get_num_threads()


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads set to n inside the block. A tiny model's
    steps are thousands of small ops; with a thread per core each op's
    barrier stalls while the suite's other workers hold the cores (the
    loop fixture of tests/test_torch_loop.py: 701 s in a 6-worker run, 27 s
    alone). CPU sums split by thread, so a result can move by an ulp with
    n."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads over the module that imports it."""
    with torch_threads(min(DEFAULT_THREADS, 2)):
        yield
