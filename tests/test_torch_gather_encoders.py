"""The gather-GEMM LiDAR encoders and their routes in the port, against the
JAX package on the CPU (tiny shapes, seeded numpy inputs).

(a) `SparseLiDAREnc8x`, `SparseLiDAREnc4x` and `SparseEncoderHD` (its
    rulebook form) against JAX's from one set of weights (the port's
    seeded init through the converters), B = 2 voxelized clustered clouds,
    at a capacity that keeps every site and at one that binds at every
    strided level (the largest ids dropped): the eval output within 1e-4
    of its scale; a train step (batch statistics) - the output within 1e-4
    of its scale, the moved statistics within 1e-4 of each one's scale,
    each parameter's gradient of sum(out * noise) within 1e-3 of its
    scale (every sum is fp32 on both sides, in other orders; the deepest
    BatchNorms see a few dozen sites).
(b) The tiny flagship and `coocc_lidar` twins with pts.impl 'gather' (and
    COOCC_HD_IMPL=gather for the LiDAR-only one): every `stop_at` prefix
    and the full outputs at tests/test_torch_model.py's TOL (5e-3), from
    one JAX compile a model that captures the prefixes. The tiny twin's
    voxel cap (4,096) binds at its first strided level.
(c) The routes: no (encoder, impl) pair that JAX accepts raises; the
    pairs JAX refuses raise its ValueError; an Enc4x model at the
    flagship's grid builds and raises at its fuser grid. `ztap_levels`
    (JAX `_ZTapBasicBlock`), `zb_down` and COOCC_STRIDED_MODE=lm, packed,
    hybrid are layouts of one function: JAX's packed encoder under each
    gives the port's packed output (which runs K2's plain version; JAX's
    SubM convs on its XLA fp32 route, the port's K2 seam swapped for the
    fp32 conv of unrounded operands) within 1e-4 of its scale.
"""
import dataclasses
import functools
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.data.synthetic import tiny_config as jax_tiny_config
from coocc_tpu.nn.sparse_enc import SparseLiDAREnc4x as JaxEnc4x
from coocc_tpu.nn.sparse_enc import SparseLiDAREnc8x as JaxEnc8x
from coocc_tpu.nn.sparse_enc_packed import PackedLiDAREnc8x as JaxPacked
from coocc_tpu.nn.sparse_encoder_hd import SparseEncoderHD as JaxHDGather
from coocc_tpu.ops.sparse_conv import SparseTensor as JaxSparseTensor
from coocc_tpu.ops.voxelize import voxelize as jax_voxelize
from coocc_tpu.train.convert_torch import (ParamTreeBuilder,
                                           convert_sparse_enc8x,
                                           convert_sparse_encoder_hd)

from test_torch_configs import lidar_configs
from test_torch_model import TOL, _run_both, _with_impl
from test_torch_packed_encoder import _fp32_subm as fp32_k2

from coocc_tpu_torch.config import get_config
from coocc_tpu_torch.convert import sparse_enc4x_to_jax
from coocc_tpu_torch.data.synthetic import tiny_config
from coocc_tpu_torch.entry import init_weights
from coocc_tpu_torch.models.coocc_ray import STAGES, CoOccRay
from coocc_tpu_torch.nn import sparse_enc_packed
from coocc_tpu_torch.nn.sparse_enc import SparseLiDAREnc4x, SparseLiDAREnc8x
from coocc_tpu_torch.nn.sparse_enc_packed import PackedLiDAREnc8x
from coocc_tpu_torch.nn.sparse_encoder_hd import SparseEncoderHD
from coocc_tpu_torch.ops.sparse_conv import SparseTensor
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

# ---------------------------------------------------------------------------
# (a) the encoders as modules
# ---------------------------------------------------------------------------

# name: (grid, JAX class, the port's, capacities (keeps all, binds))
ENCODERS = {
    "enc8x": ((32, 32, 16), JaxEnc8x, SparseLiDAREnc8x, (3000, 150)),
    "enc4x": ((16, 16, 8), JaxEnc4x, SparseLiDAREnc4x, (3000, 150)),
    "hd": ((16, 16, 65), JaxHDGather, SparseEncoderHD, (3000, 150)),
}
PCR = (-8.0, -8.0, -1.0, 8.0, 8.0, 3.0)


def _voxels(grid, B=2, P=1200):
    """B clustered clouds voxelized with their means (JAX's voxelizer; the
    port's equals it, tests/test_torch_lidar.py): numpy ids, features,
    mask [B, V]."""
    rng = np.random.RandomState(11)
    vs = [(PCR[i + 3] - PCR[i]) / grid[i] for i in range(3)]
    out = []
    for _ in range(B):
        centres = rng.uniform(PCR[:3], PCR[3:], (60, 3))
        pts = centres[rng.randint(0, 60, P)] + rng.randn(P, 3) * 0.6
        cloud = np.concatenate([pts, rng.rand(P, 2)], 1).astype(np.float32)
        v = jax_voxelize(jnp.asarray(cloud), jnp.ones(P, bool), PCR, vs,
                         grid, max_voxels=1000, num_features=4)
        out.append([np.asarray(a) for a in v])
    return [np.stack(a) for a in zip(*out)]


def _jax_variables(name, sd):
    """The port's state_dict (weights, or gradients by name) as the JAX
    module's variables, through the converters."""
    if name == "enc4x":
        return sparse_enc4x_to_jax(sd)
    b = ParamTreeBuilder()
    conv = convert_sparse_enc8x if name == "enc8x" \
        else convert_sparse_encoder_hd
    conv(b, {f"enc.{k}": v.numpy() for k, v in sd.items()}, "enc", "enc")
    return {"params": b.params["enc"], "batch_stats": b.batch_stats["enc"]}


def _jax_side(name, variables, sp, capacity, cot):
    """JAX's eval output, train output, moved statistics and the gradient
    of sum(train output * cot) in the parameters."""
    grid, jcls = ENCODERS[name][:2]
    kw = dict(sparse_shape_xyz=grid, capacity=capacity)
    if name == "hd":
        mod = jcls(in_channels=4, **kw)
    else:
        mod = jcls(input_channel=4, **kw)
    ev = jax.jit(lambda v: mod.apply(v, sp, train=False))(variables)

    def train(params):
        out, upd = mod.apply({**variables, "params": params}, sp,
                             train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd["batch_stats"])
    (_, (out, stats)), grads = jax.jit(jax.value_and_grad(
        train, has_aux=True))(variables["params"])
    return jax.tree.map(np.asarray, (ev, out, stats, grads))


@pytest.fixture(scope="module")
def encoder_runs():
    """{(name, capacity): (JAX's (eval, train out, stats, grads) as numpy
    in JAX's layout, the port's the same in JAX's layout, via its own
    converter)}; JAX's compiles in threads beside the port's runs."""
    out, threads = {}, []
    for name, (grid, _, tcls, caps) in ENCODERS.items():
        ids, feats, mask = _voxels(grid)
        enc = init_weights(tcls(4, sparse_shape_xyz=grid), 3)
        sd = {k: v.clone() for k, v in enc.state_dict().items()}
        variables = _jax_variables(name, sd)
        jsp = JaxSparseTensor(jnp.asarray(ids), jnp.asarray(feats),
                              jnp.asarray(mask))
        tsp = SparseTensor(*(torch.from_numpy(np.array(a))
                             for a in (ids.astype(np.int64), feats, mask)))
        for cap in caps:
            enc.load_state_dict(sd)
            enc.eval()
            with torch.no_grad():
                ev = enc(tsp, cap)
            sites = [int(s.max()) for s in enc.level_sites]
            enc.train()
            tout = enc(tsp, cap)
            cot = np.random.RandomState(cap).randn(
                *tout.permute(0, 2, 3, 4, 1).shape).astype(np.float32)
            (tout * torch.from_numpy(cot).permute(0, 4, 1, 2, 3)).sum() \
                .backward()
            got = {"eval": ev.permute(0, 2, 3, 4, 1).numpy(),
                   "train": tout.detach().permute(0, 2, 3, 4, 1).numpy(),
                   "sd": {k: v.detach().clone()
                          for k, v in enc.state_dict().items()},
                   "grads": {k: p.grad.clone()
                             for k, p in enc.named_parameters()
                             if p.grad is not None},
                   "sites": sites}
            enc.zero_grad()
            key = (name, cap)
            out[key] = [None, got]

            def run(key=key, name=name, v=variables, sp=jsp, cap=cap,
                    cot=cot):
                try:
                    out[key][0] = _jax_side(name, v, sp, cap, cot)
                except BaseException as e:  # re-raised below
                    out[key][0] = e
            threads.append(threading.Thread(target=run))
            threads[-1].start()
    for t in threads:
        t.join()
    for key, (j, _) in out.items():
        if isinstance(j, BaseException):
            raise j
    return out


def _close(got, ref, rel, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = np.abs(ref).max()
    assert scale > 0, what
    err = np.abs(got - ref).max()
    assert err <= rel * scale, (what, err, scale)


CASES = [(n, c) for n, v in ENCODERS.items() for c in v[3]]


@pytest.mark.parametrize("name,cap", CASES)
def test_encoder_eval_matches_jax(encoder_runs, name, cap):
    (jev, _, _, _), got = encoder_runs[(name, cap)]
    _close(got["eval"], jev, 1e-4, "eval")
    binds = cap == ENCODERS[name][3][1]
    assert (max(got["sites"]) > cap) == binds, got["sites"]


@pytest.mark.parametrize("name,cap", CASES)
def test_encoder_train_step_matches_jax(encoder_runs, name, cap):
    (_, jout, jstats, jgrads), got = encoder_runs[(name, cap)]
    _close(got["train"], jout, 1e-4, "train output")
    stats = _jax_variables(name, got["sd"])["batch_stats"]
    flat_j = jax.tree_util.tree_flatten_with_path(jstats)[0]
    flat_p = dict(jax.tree_util.tree_flatten_with_path(stats)[0])
    assert len(flat_j) == len(flat_p) > 10
    for path, ref in flat_j:
        _close(flat_p[path], ref, 1e-4, jax.tree_util.keystr(path))
    # the gradients through the same converter (zeros where the port has
    # none: the Enc8x stem's GroupNorm scale, as JAX's)
    grads = {k: got["grads"].get(k, torch.zeros_like(v))
             for k, v in got["sd"].items()}
    pg = dict(jax.tree_util.tree_flatten_with_path(
        _jax_variables(name, grads)["params"])[0])
    flat_g = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat_g) == len(pg)
    for path, ref in flat_g:
        if np.abs(ref).max() == 0:
            assert np.abs(pg[path]).max() == 0, jax.tree_util.keystr(path)
            continue
        _close(pg[path], ref, 1e-3, jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# (b) the tiny twins on the gather routes, every prefix
# ---------------------------------------------------------------------------

def _gather(cfg):
    return _with_impl(cfg, "gather")


@pytest.fixture(scope="module")
def twins():
    """{name: _run_both's result} for the flagship's and coocc_lidar's tiny
    twins on the gather route, JAX's two compiles in threads."""
    stops = STAGES + (None,)
    jl, tl = lidar_configs()
    pairs = {"flagship": (_gather(jax_tiny_config()), _gather(tiny_config())),
             "lidar": (_gather(jl), _gather(tl))}
    out = {}

    def run(name):
        try:
            out[name] = _run_both(*pairs[name], stops, capture=True)
        except BaseException as e:  # re-raised below
            out[name] = e
    threads = [threading.Thread(target=run, args=(n,)) for n in pairs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for v in out.values():
        if isinstance(v, BaseException):
            raise v
    return out


@pytest.mark.parametrize("stop", STAGES + (None,))
@pytest.mark.parametrize("name", ["flagship", "lidar"])
def test_gather_twin_prefix_matches_jax(twins, name, stop):
    j, t = twins[name][stop]
    assert set(t) == set(j), (set(t), set(j))
    for key in j:
        pairs = list(zip(j[key], t[key])) if key == "semantic" \
            else [(j[key], t[key])]
        for a, b in pairs:
            if a is None:
                assert b is None, key
                continue
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape, key
            if key in ("fine_overflow", "fine_valid", "fine_coords"):
                np.testing.assert_array_equal(b, a)
                continue
            assert np.abs(b).max() > 0, f"{key} is all zero"
            np.testing.assert_allclose(b, a, err_msg=f"{stop}/{key}", **TOL)


# ---------------------------------------------------------------------------
# (c) the routes
# ---------------------------------------------------------------------------

def _pts(cfg, **kw):
    return dataclasses.replace(cfg, pts=dataclasses.replace(cfg.pts, **kw))


@pytest.mark.parametrize("encoder,impl,hd_env,want", [
    ("SparseLiDAREnc8x", "auto", None, "PackedLiDAREnc8x"),
    ("SparseLiDAREnc8x", "gather", None, "SparseLiDAREnc8x"),
    ("SparseLiDAREnc8x", "packed_hd", None, "SparseLiDAREnc8x"),
    ("SparseLiDAREnc4x", "auto", None, "SparseLiDAREnc4x"),
    ("SparseLiDAREnc4x", "gather", None, "SparseLiDAREnc4x"),
    ("SparseLiDAREnc4x", "dense", None, ValueError),
    ("SparseLiDAREnc4x", "packed", None, ValueError),
    ("SparseEncoderHD", "auto", "gather", "SparseEncoderHD"),
    ("SparseEncoderHD", "auto", "packed_hd", "PackedEncoderHD"),
    ("SparseEncoderHD", "gather", None, "SparseEncoderHD"),
    ("SparseEncoderHD", "gather", "packed_hd", "SparseEncoderHD"),
    ("SparseEncoderHD", "packed_hd", "gather", "PackedEncoderHD")])
def test_every_route_jax_accepts_resolves(monkeypatch, encoder, impl,
                                          hd_env, want):
    """Each pair as JAX's _pts_voxels resolves it (coocc_ray.py:130-250),
    at full width on the meta device."""
    if hd_env is None:
        monkeypatch.delenv("COOCC_HD_IMPL", raising=False)
    else:
        monkeypatch.setenv("COOCC_HD_IMPL", hd_env)
    base = get_config("coocc_lidar" if encoder == "SparseEncoderHD"
                      else "coocc_multi_r50_256x704")
    cfg = _pts(base, encoder=encoder, impl=impl)
    with torch.device("meta"):
        if isinstance(want, type):
            with pytest.raises(want, match="dense/packed twin only"):
                CoOccRay(cfg)
            return
        model = CoOccRay(cfg)
    assert type(model.pts_middle_encoder).__name__ == want


def test_enc4x_model_raises_at_the_fuser_grid():
    """An Enc4x flagship: its 200x200x16 pts_voxel is not the 100x100x8
    fuser grid, where JAX's fuser fails; the img and pts prefixes run."""
    from coocc_tpu_torch.data.synthetic import synthetic_batch
    cfg = _pts(tiny_config(), encoder="SparseLiDAREnc4x")
    model = CoOccRay(cfg).eval()
    init_weights(model, 0)
    batch = synthetic_batch(cfg, batch_size=1, seed=0).to("cpu")
    pts = model(batch, stop_at="pts")["pts_voxel"]
    assert tuple(pts.shape[1:4]) == tuple(s // 4 for s in
                                          cfg.pts.sparse_shape_xyz)
    with pytest.raises(ValueError, match="fuser"):
        model(batch)


# (ztap_levels, zb_down, COOCC_STRIDED_MODE)
FORMS = [((1,), False, None), ((1, 2, 3), False, None),
         ((), True, None), ((), False, "lm"), ((), False, "packed"),
         ((), False, "hybrid")]


@pytest.fixture(scope="module")
def packed_forms():
    """The port's packed encoder (K2's seam on the fp32 conv of unrounded
    operands) and JAX's PackedLiDAREnc8x under each form, on one
    occupancy grid, in JAX's layout; the forms' compiles in threads."""
    grid = (32, 32, 16)
    rng = np.random.RandomState(4)
    occ = rng.rand(1, *grid) < 0.1
    enc = init_weights(PackedLiDAREnc8x(4), 6).eval()
    sd = {f"enc.{k}": v.numpy() for k, v in enc.state_dict().items()}
    b = ParamTreeBuilder()
    convert_sparse_enc8x(b, sd, "enc", "enc")
    variables = {"params": b.params["enc"],
                 "batch_stats": b.batch_stats["enc"]}
    out = {}
    lock = threading.Lock()

    def run(i, ztap, zb, mode):
        mod = JaxPacked(sparse_shape_xyz=grid, ztap_levels=ztap,
                        zb_down=zb)
        fn = jax.jit(functools.partial(mod.apply, train=False))
        with lock:     # the form's environment while JAX traces it
            old = os.environ.pop("COOCC_STRIDED_MODE", None)
            if mode:
                os.environ["COOCC_STRIDED_MODE"] = mode
            try:
                lowered = fn.lower(variables, jnp.asarray(occ))
            finally:
                os.environ.pop("COOCC_STRIDED_MODE", None)
                if old is not None:
                    os.environ["COOCC_STRIDED_MODE"] = old
        out[i] = np.asarray(lowered.compile()(variables, jnp.asarray(occ)))
    threads = [threading.Thread(target=run, args=(i, *f))
               for i, f in enumerate(FORMS)]
    for t in threads:
        t.start()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sparse_enc_packed, "subm_ext_conv", fp32_k2)
        with torch.no_grad():
            port = enc(torch.from_numpy(occ)).permute(0, 2, 3, 4, 1).numpy()
    for t in threads:
        t.join()
    return port, out


@pytest.mark.parametrize("form", range(len(FORMS)),
                         ids=[f"ztap{f[0]}-zb{int(f[1])}-{f[2]}"
                              for f in FORMS])
def test_packed_layout_forms_match_the_port(packed_forms, form):
    port, jax_out = packed_forms
    _close(port, jax_out[form], 1e-4, str(FORMS[form]))


def test_ztap_levels_runs_the_packed_encoder():
    """pts.ztap_levels builds the port's packed encoder (K2 at every
    level): the same function."""
    cfg = _pts(tiny_config(), impl="packed", ztap_levels=(1, 2, 3))
    assert type(CoOccRay(cfg).pts_middle_encoder) is PackedLiDAREnc8x

