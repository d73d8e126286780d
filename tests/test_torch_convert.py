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
4. The stereo config's depth net, whose names JAX's converter lacks: the
   tiny stereo model round-trips through convert_coocc_ray composed with
   the port's stereo_depth_net_to_jax, and that gives every variable path
   and shape JAX's init creates.
5. The LiDAR encoder's routes: the variables JAX's model creates on one
   route (gather, dense, packed_hd) load strict into the port's model on
   every route of that encoder and convert back to the same paths; the
   Enc4x scopes round-trip through state_dict_from_jax and
   sparse_enc4x_to_jax; JAX's own converter cannot fill an Enc4x tree
   (ROADMAP C12).
"""
import dataclasses
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
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)


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


def _stereo_variables(sd, monkeypatch):
    """JAX variables of a tiny stereo model's state_dict: JAX's
    convert_coocc_ray (its mono depth net skipped) with the port's
    stereo_depth_net_to_jax for that subtree (tests/test_torch_stereo.py)."""
    from coocc_tpu.train import convert_torch
    from test_torch_stereo import _jax_variables, _skip_mono
    monkeypatch.setattr(convert_torch, "convert_depthnet",
                        _skip_mono(convert_torch.convert_depthnet))
    return _jax_variables({k: v.numpy() for k, v in sd.items()},
                          jax_tiny_config(stereo=True))


def test_stereo_state_dict_round_trip(monkeypatch):
    cfg = tiny_config(stereo=True)
    sd = build_model(cfg, "cpu", seed=11).state_dict()
    back = state_dict_from_jax(_stereo_variables(sd, monkeypatch), cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def test_stereo_names_are_the_flax_scopes(monkeypatch):
    """The port's stereo depth net converts to exactly the variables JAX's
    CoOccRay creates (every path and shape of its init, in training so
    that the renderer's heads exist, traced with eval_shape), and JAX's
    variables of those shapes load strict into the port's model."""
    jcfg = jax_tiny_config(stereo=True)
    batch = jax.tree.map(lambda x: None if x is None else jnp.asarray(x),
                         jax_synthetic_batch(jcfg, batch_size=1, seed=0),
                         is_leaf=lambda x: x is None)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda b: JaxCoOccRay(cfg=jcfg).init(
        {"params": key, "dropout": key}, b, train=True, fine_rng=key), batch)
    cfg = tiny_config(stereo=True)
    sd = build_model(cfg, "cpu", seed=11).state_dict()
    ours = _stereo_variables(sd, monkeypatch)
    for col, stereo_only in (("params", "sim_fc0"),
                             ("batch_stats", "sim_bn0")):
        ref = _paths(dict(shapes[col]))
        assert _paths(ours[col]) == ref, col
        assert any(stereo_only in p for p in ref)
    zeros = {col: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                               dict(shapes[col]))
             for col in ("params", "batch_stats")}
    CoOccRay(cfg).load_state_dict(state_dict_from_jax(zeros, cfg),
                                  strict=True)


# ---------------------------------------------------------------------------
# 5. The LiDAR encoder's routes: one JAX tree loads into each form
# ---------------------------------------------------------------------------

def _route(cfg, impl):
    return dataclasses.replace(cfg, pts=dataclasses.replace(cfg.pts,
                                                            impl=impl))


def _jax_shapes(jcfg):
    batch = jax.tree.map(lambda x: None if x is None else jnp.asarray(x),
                         jax_synthetic_batch(jcfg, batch_size=1, seed=0),
                         is_leaf=lambda x: x is None)
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda b: JaxCoOccRay(cfg=jcfg).init(
        {"params": key, "dropout": key}, b, train=True, fine_rng=key), batch)


@pytest.mark.parametrize("family,jax_impl,port_impls", [
    ("flagship", "gather", ("gather", "dense", "packed")),
    ("flagship", "dense", ("gather", "dense", "packed")),
    ("lidar", "gather", ("gather", "packed_hd")),
    ("lidar", "packed_hd", ("gather", "packed_hd"))])
def test_one_jax_tree_loads_into_every_route(family, jax_impl, port_impls):
    """JAX's CoOccRay on one LiDAR route creates the variables (every path
    and shape of its init, traced with eval_shape) that load strict into
    the port's model on each route of the same encoder, and the port's
    state_dict converts back to exactly those paths and shapes."""
    from test_torch_configs import lidar_configs
    jcfg, cfg = (jax_tiny_config(), tiny_config()) if family == "flagship" \
        else lidar_configs()
    shapes = _jax_shapes(_route(jcfg, jax_impl))
    rs = np.random.RandomState(0)
    tree = {col: jax.tree.map(lambda s: rs.rand(*s.shape).astype(s.dtype),
                              dict(shapes[col]))
            for col in ("params", "batch_stats")}
    for impl in port_impls:
        sd = state_dict_from_jax(tree, _route(cfg, impl))
        model = CoOccRay(_route(cfg, impl))
        model.load_state_dict(sd, strict=True)
        ours = convert_coocc_ray({k: v.numpy() for k, v in
                                  model.state_dict().items()},
                                 _route(jcfg, jax_impl))
        for col in ("params", "batch_stats"):
            assert _paths(ours[col]) == _paths(dict(shapes[col])), (impl,
                                                                    col)


def test_enc4x_names_round_trip_jax_scopes():
    """SparseLiDAREnc4x: JAX's init tree (conv_input, gn_input, res1_*,
    down2, res2_*, down3, res3_*, conv_out, gn_out) comes across through
    state_dict_from_jax and loads strict; the port's sparse_enc4x_to_jax
    gives back every path, shape and value."""
    from coocc_tpu.nn.sparse_enc import SparseLiDAREnc4x as JaxEnc4x
    from coocc_tpu.ops.sparse_conv import SparseTensor as JaxSparseTensor
    from coocc_tpu_torch.convert import (_sparse_enc4x, _Writer,
                                         sparse_enc4x_to_jax)
    grid, A = (16, 16, 8), 64
    sp = JaxSparseTensor(jnp.full((1, A), 16 * 16 * 8, jnp.int32),
                         jnp.zeros((1, A, 4)), jnp.zeros((1, A), bool))
    # jitted: flax's eager init dispatches every op of the encoder
    variables = jax.tree.map(np.asarray, dict(jax.jit(JaxEnc4x(
        sparse_shape_xyz=grid, capacity=A).init)(jax.random.PRNGKey(1), sp)))
    # state_dict_from_jax's writer for the encoder's subtree
    w = _Writer({c: {"enc": variables[c]}
                 for c in ("params", "batch_stats")})
    _sparse_enc4x(w, "enc", "enc")
    enc = CoOccRay(dataclasses.replace(tiny_config(), pts=dataclasses.replace(
        tiny_config().pts, encoder="SparseLiDAREnc4x"))).pts_middle_encoder
    enc.load_state_dict({k[len("enc."):]: v for k, v in w.sd.items()},
                        strict=True)
    back = sparse_enc4x_to_jax(enc.state_dict())
    for col in ("params", "batch_stats"):
        assert _paths(back[col]) == _paths(variables[col]), col
    for (p1, a), (p2, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(
                {c: variables[c] for c in ("params", "batch_stats")})[0]):
        assert p1 == p2
        np.testing.assert_array_equal(a, b, err_msg=str(p1))


def test_jax_converter_cannot_fill_an_enc4x_tree():
    """ROADMAP C12: JAX's convert_coocc_ray sends SparseLiDAREnc4x through
    convert_sparse_enc8x (coocc_tpu/train/convert_torch.py:497-499), which
    reads an 8x encoder's conv1.0.0 strided block: an Enc4x checkpoint has
    none at conv1 (its level 0 is two basic blocks), and the KeyError
    stops it; its names are the 8x tree's, not Enc4x's scopes."""
    cfg = dataclasses.replace(tiny_config(), pts=dataclasses.replace(
        tiny_config().pts, encoder="SparseLiDAREnc4x"))
    jcfg = dataclasses.replace(jax_tiny_config(), pts=dataclasses.replace(
        jax_tiny_config().pts, encoder="SparseLiDAREnc4x"))
    sd = build_model(cfg, "cpu", seed=11).state_dict()
    with pytest.raises(KeyError, match="conv1.0.0"):
        convert_coocc_ray({k: v.numpy() for k, v in sd.items()}, jcfg)
