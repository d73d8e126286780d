"""The port's configs and synthetic batches equal the JAX package's.

The port keeps its own copies of coocc_tpu/config and
coocc_tpu/data/synthetic.py (it imports nothing of coocc_tpu); these tests
pin the copies to the reference.
"""
import dataclasses

import numpy as np
import pytest

from coocc_tpu.config import get_config as jax_get_config
from coocc_tpu.config import list_configs as jax_list_configs
from coocc_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from coocc_tpu.data.synthetic import tiny_config as jax_tiny_config

from coocc_tpu_torch.config import get_config, list_configs
from coocc_tpu_torch.data.synthetic import synthetic_batch, tiny_config
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)


def test_config_names_match():
    assert list_configs() == jax_list_configs()


@pytest.mark.parametrize("name", jax_list_configs())
def test_config_matches_jax(name):
    assert dataclasses.asdict(get_config(name)) \
        == dataclasses.asdict(jax_get_config(name))


@pytest.mark.parametrize("name", ["tiny", "coocc_multi_r50_256x704"])
def test_synthetic_batch_bit_identical(name):
    if name == "tiny":
        cfg, jcfg = tiny_config(), jax_tiny_config()
    else:
        cfg, jcfg = get_config(name), jax_get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    got = synthetic_batch(cfg, batch_size=1, seed=5)
    ref = jax_synthetic_batch(jcfg, batch_size=1, seed=5)
    assert got._fields == ref._fields
    for field, a, b in zip(ref._fields, got, ref):
        if b is None:
            assert a is None, field
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(a, b), field
