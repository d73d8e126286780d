"""The port's configs, class tables and synthetic batches equal the JAX
package's.

The port keeps its own copies of coocc_tpu/config (the SemanticKITTI
tables of config/semantic_kitti.py among them) and
coocc_tpu/data/synthetic.py (it imports nothing of coocc_tpu); these tests
pin the copies to the reference. A kitti config's synthetic batch carries
KITTI's 3x4 intrinsics in the port: JAX's batch with
`kitti_intrinsics` applied.
"""
import dataclasses

import numpy as np
import pytest

from coocc_tpu.config import get_config as jax_get_config
from coocc_tpu.config import list_configs as jax_list_configs
from coocc_tpu.config import semantic_kitti as jax_kitti
from coocc_tpu.config.nuscenes import class_weights as jax_class_weights
from coocc_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from coocc_tpu.data.synthetic import tiny_config as jax_tiny_config

from coocc_tpu_torch.config import get_config, list_configs
from coocc_tpu_torch.config import semantic_kitti
from coocc_tpu_torch.config.nuscenes import class_weights
from coocc_tpu_torch.data.synthetic import (kitti_intrinsics,
                                            synthetic_batch, tiny_config)
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


def test_kitti_synthetic_batch_is_jax_with_kitti_intrinsics():
    """coocc_kitti's batch: JAX's, with its 3x3 intrinsics K made KITTI's
    3x4 P2 = K [I | t] (the same draws otherwise)."""
    name = "coocc_kitti"
    got = synthetic_batch(get_config(name), batch_size=1, seed=5)
    ref = kitti_intrinsics(jax_synthetic_batch(jax_get_config(name),
                                               batch_size=1, seed=5))
    assert got.intrins.shape == (1, 1, 3, 4)
    np.testing.assert_array_equal(got.intrins[..., :3],
                                  jax_synthetic_batch(
                                      jax_get_config(name), batch_size=1,
                                      seed=5).intrins)
    for field, a, b in zip(ref._fields, got, ref):
        if b is None:
            assert a is None, field
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(a, b), field


def test_semantic_kitti_tables_match_jax():
    assert semantic_kitti.KITTI_CLASS_NAMES == jax_kitti.KITTI_CLASS_NAMES
    assert semantic_kitti.NUM_KITTI_CLASSES == 20
    np.testing.assert_array_equal(semantic_kitti.KITTI_CLASS_FREQUENCIES,
                                  jax_kitti.KITTI_CLASS_FREQUENCIES)
    assert semantic_kitti.KITTI_LEARNING_MAP == jax_kitti.KITTI_LEARNING_MAP
    assert semantic_kitti.KITTI_LEARNING_MAP_INV == \
        jax_kitti.KITTI_LEARNING_MAP_INV
    np.testing.assert_array_equal(semantic_kitti.learning_map_array(),
                                  jax_kitti.learning_map_array())


@pytest.mark.parametrize("num_classes", [17, 20])
def test_class_weights_match_jax(num_classes):
    got, ref = class_weights(num_classes), jax_class_weights(num_classes)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
