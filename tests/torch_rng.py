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
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def keep_torch_rng():
    with torch.random.fork_rng(devices=[]):
        yield
