"""Weights carry across: convert_coocc_ray and state_dict_from_jax invert.

1. The port's seeded tiny model: its state_dict -> the JAX package's
   convert_coocc_ray -> the port's state_dict_from_jax gives back the same
   state_dict, key for key and value for value.
2. A JAX-initialized tiny CoOccRay (utils/init_utils.jit_init, with
   train=True so that the renderer's heads exist, as train/loop.py:146-147
   initializes it) goes through state_dict_from_jax and loads into the port
   with strict=True.
"""
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
from coocc_tpu_torch.entry import build_model
from coocc_tpu_torch.models.coocc_ray import CoOccRay


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


def test_jax_initialized_weights_load_strict():
    jcfg = jax_tiny_config()
    batch = jax.tree.map(lambda x: None if x is None else jnp.asarray(x),
                         jax_synthetic_batch(jcfg, batch_size=1, seed=0),
                         is_leaf=lambda x: x is None)
    key = jax.random.PRNGKey(0)
    variables = jit_init(JaxCoOccRay(cfg=jcfg),
                         {"params": key, "dropout": key}, batch,
                         train=True, fine_rng=key)
    variables = jax.tree.map(np.asarray, dict(variables))
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
