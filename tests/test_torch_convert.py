"""Weights carry across: convert_coocc_ray and state_dict_from_jax invert.

1. The port's seeded tiny model: its state_dict -> the JAX package's
   convert_coocc_ray -> the port's state_dict_from_jax gives back the same
   state_dict, key for key and value for value.
2. A JAX-initialized tiny CoOccRay (utils/init_utils.jit_init, with
   train=True so that the renderer's heads exist, as train/loop.py:146-147
   initializes it) goes through state_dict_from_jax and loads into the port
   with strict=True.
3. entry.init_flax draws what that jit_init draws: the same leaves are all
   zero or all one, each random leaf's std agrees with JAX's within
   sampling error, and no value of a truncated normal lies beyond its 2
   sigma (JAX's draws neither, which pins the fan_in convention).
"""
import math

import pytest
import jax
import jax.numpy as jnp
import numpy as np
import torch

from coocc_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from coocc_tpu.data.synthetic import tiny_config as jax_tiny_config
from coocc_tpu.models.coocc_ray import CoOccRay as JaxCoOccRay
from coocc_tpu.train.convert_torch import convert_coocc_ray
from coocc_tpu.utils.init_utils import jit_init

from coocc_tpu_torch.convert import state_dict_from_jax
from coocc_tpu_torch.data.synthetic import tiny_config
from coocc_tpu_torch.entry import build_model, init_flax
from coocc_tpu_torch.models.coocc_ray import CoOccRay
from coocc_tpu_torch.nn.sparse_enc_dense import SpConvWeight


def test_state_dict_round_trip():
    cfg = tiny_config()
    sd = build_model(cfg, "cpu", seed=11).state_dict()
    variables = convert_coocc_ray({k: v.numpy() for k, v in sd.items()},
                                  jax_tiny_config())
    back = state_dict_from_jax(variables, cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        assert torch.equal(back[k], v), k


@pytest.fixture(scope="module")
def jax_init():
    jcfg = jax_tiny_config()
    batch = jax.tree.map(lambda x: None if x is None else jnp.asarray(x),
                         jax_synthetic_batch(jcfg, batch_size=1, seed=0),
                         is_leaf=lambda x: x is None)
    key = jax.random.PRNGKey(0)
    variables = jit_init(JaxCoOccRay(cfg=jcfg),
                         {"params": key, "dropout": key}, batch,
                         train=True, fine_rng=key)
    return jax.tree.map(np.asarray, dict(variables))


def test_jax_initialized_weights_load_strict(jax_init):
    variables = jax_init
    sd = state_dict_from_jax(variables, tiny_config())
    model = CoOccRay(tiny_config())
    model.load_state_dict(sd, strict=True)
    k = "semantic_encoder.layers.1.0.conv1.weight"
    np.testing.assert_array_equal(
        model.state_dict()[k].numpy(),
        np.asarray(variables["params"]["semantic_encoder"]["layer1_0"]
                   ["conv1"]["conv"]["kernel"]).transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(
        model.state_dict()["rgb_head.hidden_layers.2.weight"].numpy(),
        np.asarray(variables["params"]["renderer"]["rgb_head"]["hidden2"]
                   ["kernel"]).T)


def test_init_flax_draws_like_jax_jit_init(jax_init):
    ref = state_dict_from_jax(jax_init, tiny_config())
    model = init_flax(CoOccRay(tiny_config()), seed=0)
    got = model.state_dict()
    assert set(got) == set(ref)
    plain = {f"{n}.weight" for n, m in model.named_modules()
             if isinstance(m, SpConvWeight)}
    n_random = 0
    for k, g in got.items():
        g, r = g.numpy().astype(np.float64), ref[k].numpy().astype(np.float64)
        assert g.shape == r.shape, k
        if np.all(r == r.flat[0]):
            assert r.flat[0] in (0.0, 1.0), k
            assert np.all(g == r.flat[0]), k
            continue
        n_random += 1
        # the sample std of n draws has a relative error of about
        # 1 / sqrt(2 n): allow 5 of those, for each side
        tol = 5 * math.sqrt(1 / (2 * g.size) + 1 / (2 * r.size))
        assert abs(g.std() / r.std() - 1) <= tol, (k, g.std(), r.std())
        if k not in plain:
            gain = 2.0 if k.endswith("depth_conv.4.weight") else 1.0
            sigma = math.sqrt(gain / (g.size / g.shape[0]))
            limit = 2 * sigma / 0.87962566103423978 * (1 + 1e-6)
            assert np.abs(g).max() <= limit, k
            assert np.abs(r).max() <= limit, k
    assert n_random > 100
    assert plain, "the spconv weights draw a plain normal (JAX _kaiming)"
