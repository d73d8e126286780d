"""The stereo config, coocc_multi_r50_256x704_stereo (BEVStereo
temporal-stereo depth), in the port against the JAX package at tiny
shapes (CPU).

One set of weights: the port draws them; JAX's `convert_coocc_ray` carries
everything but the stereo depth net (it has no stereo names and its mono
`convert_depthnet` is skipped where the state_dict has no mono depth
net), and the port's `convert.stereo_depth_net_to_jax` carries that
subtree (`_jax_variables`). Held:
  * depth_sampling_k_list equal to JAX's, bit for bit;
  * grid_sample_2d against JAX's (align_corners=True, zeros padding, the
    plane sweep's), with points on the grid's edges and off it, an fp32
    and a bf16 map;
  * homo_warp against JAX's (vmapped over the views): the identity rig
    (the map resampled onto itself) and a rig with a plane behind the
    sweep camera (zeros there);
  * DepthNetStereo and LSSBEVStereo at test_lss_stereo.py's shapes and a
    rig that moves the camera, LSSBEVStereo at em_iteration 1 (the tiny
    config's) and 3 (the shipped one): fp32 within 1e-4 of each output's
    scale, bf16 (JAX compiled with xla_allow_excess_precision off) within
    2x (max) and 1.5x (mean) of JAX's own bf16-vs-fp32 drift;
  * the tiny stereo model (tiny_config(stereo=True), 2 cameras at 64x192)
    at every stop_at prefix and its full outputs: fp32 at 5e-3 with the
    default packed LiDAR encoder, K2's seam swapped for an fp32 conv
    (tests/test_torch_configs.py's `_fp32_subm`: JAX's fp32 XLA route does
    not round the SubM operands to bf16); bf16 with the dense twin pinned
    on both sides, by the drift rule, with equal dtypes and the refined
    cells JAX refines;
  * one train step against JAX's value_and_grad: at em_iteration 1 at
    tests/test_torch_train.py's fixed bounds (the raw loss terms, the
    outputs the losses read, the moved BN statistics, the gradients); at
    the shipped 3 (the similarity net runs 12 times) the moved statistics
    at the same bound and the rest within JAX's own change under a 1e-5
    weight perturbation, which is large there; at both, every backbone
    BatchNorm normalizes twice a step (the key frame first) and the
    similarity net's once per range and round, counted;
  * each module the depth nets reuse, at 2 and 6 cameras (ROADMAP C7).
JAX's compiles run in threads beside the port's work
(tests/test_torch_train_configs.py's pattern).
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.data.synthetic import tiny_config as jax_tiny_config
from coocc_tpu.nn.lss_stereo import DepthNetStereo as JaxDepthNetStereo
from coocc_tpu.nn.lss_stereo import LSSBEVStereo as JaxLSSBEVStereo
from coocc_tpu.nn.lss_stereo import depth_sampling_k_list as jax_k_list
from coocc_tpu.nn.lss_stereo import homo_warp as jax_homo_warp
from coocc_tpu.ops.grid_sample import grid_sample_2d as jax_grid_sample_2d
from coocc_tpu.train import convert_torch

import test_torch_model
import test_torch_train
from test_torch_configs import (_fine_sorted, _fp32_subm, _in_threads,
                                _pairs, _refined)
from test_torch_model import TOL, _common_fine, _run_both
from test_torch_train import (SEED, _jax_step, _leaf_errors, _np, _port_step,
                              _to_port)

from coocc_tpu_torch.convert import stereo_depth_net_to_jax
from coocc_tpu_torch.data.synthetic import tiny_config
from coocc_tpu_torch.entry import build_model, init_weights
from coocc_tpu_torch.models.coocc_ray import STAGES
from coocc_tpu_torch.nn import sparse_enc_packed
from coocc_tpu_torch.nn.layers import BatchNorm
from coocc_tpu_torch.nn.lss_stereo import (LSSBEVStereo, depth_sampling_k_list,
                                           homo_warp)
from coocc_tpu_torch.ops.grid_sample import grid_sample_2d
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

DEPTH_NET = "img_view_transformer.depth_net"
JIT16 = dict(compiler_options={"xla_allow_excess_precision": False})


def stereo_tiny(make, em_iteration=None):
    """make(stereo=True) (either package's tiny_config), its EM rounds set
    when given."""
    cfg = make(stereo=True)
    if em_iteration is None:
        return cfg
    return cfg.replace(lss=dataclasses.replace(
        cfg.lss, stereo_em_iteration=em_iteration))


def _skip_mono(convert_depthnet):
    def convert(b, sd, tprefix, fprefix):
        if f"{tprefix}.reduce_conv.0.weight" in sd:
            convert_depthnet(b, sd, tprefix, fprefix)
    return convert


def _jax_variables(sd, jcfg):
    """JAX variables of the port's state_dict `sd`: convert_coocc_ray with
    the stereo depth net's subtree from stereo_depth_net_to_jax (needs
    the `stereo_convert` fixture's patch)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    variables = _convert_coocc_ray(sd, jcfg)
    if jcfg.lss is not None and jcfg.lss.stereo:
        sub = stereo_depth_net_to_jax(sd)
        for col in ("params", "batch_stats"):
            variables[col].setdefault("img_view_transformer", {})[
                "depth_net"] = sub[col]
    return variables


_convert_coocc_ray = convert_torch.convert_coocc_ray


@pytest.fixture(scope="module")
def stereo_convert():
    """For this module: JAX's mono convert_depthnet skipped where the
    state_dict has no mono depth net, and test_torch_model's _run_both
    converting through _jax_variables."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convert_torch, "convert_depthnet",
                   _skip_mono(convert_torch.convert_depthnet))
        mp.setattr(test_torch_model, "convert_coocc_ray", _jax_variables)
        yield


# ---------------------------------------------------------------------------
# depth_sampling_k_list, grid_sample_2d, homo_warp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampling_range,num_samples", [(3, 3), (3, 5),
                                                        (2, 4)])
def test_depth_sampling_k_list_equals_jax(sampling_range, num_samples):
    got = depth_sampling_k_list(sampling_range, num_samples)
    ref = jax_k_list(sampling_range, num_samples)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


# grid points (x, y): the corners and edge midpoints exactly, points just
# past the edges and far off the map
GRID_POINTS = {
    "edges": np.array([[-1, -1], [1, 1], [-1, 1], [1, -1], [0, -1], [1, 0],
                       [-1, 0.5], [0.25, 1]], np.float32),
    "outside": np.array([[-1.0001, 0], [0, 1.0001], [1.3, 0.2],
                         [-1.7, -1.2], [2.0, 2.0], [0.5, -1.25],
                         [1.0001, 1.0001], [-3.0, 0.0]], np.float32),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("points", ["random", "edges", "outside"])
def test_grid_sample_2d_matches_jax(points, dtype):
    """An fp32 grid over an fp32 or a bf16 map, align_corners=True and
    zeros padding (the plane sweep's): the same products summed in the
    same order, to 1e-6 of the map's scale; the output dtype JAX's (fp32
    for a bf16 map under an fp32 grid); points past the edges read zeros
    where all four corners lie outside."""
    rs = np.random.RandomState(5)
    img = torch.from_numpy(rs.randn(5, 7, 3).astype(np.float32)).to(
        getattr(torch, dtype))
    grid = GRID_POINTS.get(points)
    if grid is None:
        grid = rs.uniform(-1.4, 1.4, (64, 2)).astype(np.float32)
    grid = grid.reshape(2, -1, 2)
    ref = jax_grid_sample_2d(
        jnp.asarray(img.float().numpy()).astype(dtype), jnp.asarray(grid),
        align_corners=True, padding_mode="zeros")
    got = grid_sample_2d(img[None], torch.from_numpy(grid)[None])[0]
    assert str(got.dtype)[6:] == ref.dtype.name == "float32"
    scale = float(img.float().abs().max())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6 * scale)
    if points == "outside":
        far = (np.abs(grid) > 1.5).any(-1)
        assert float(np.abs(got.numpy()[far]).max()) == 0.0
    else:
        assert np.abs(np.asarray(ref)).max() > 0


def _rig(BN, yaw=0.05, step=(0.3, 0.0, 0.1)):
    """A key -> sweep camera rig that moves the camera: [BN, 3, 3] and
    [BN, 3] (each view turned a little more)."""
    rots, trans = [], []
    for n in range(BN):
        a = yaw * (n + 1)
        rots.append([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]])
        trans.append(np.array(step) * (n + 1))
    return (np.array(rots, np.float32), np.array(trans, np.float32))


def _intrinsics(BN, W, H):
    k = np.zeros((BN, 3, 3), np.float32)
    for n in range(BN):
        k[n] = [[50.0 + 5 * n, 0, W / 2 + n], [0, 50.0 + 5 * n, H / 2],
                [0, 0, 1]]
    return k


@pytest.mark.parametrize("case", ["identity", "rig", "behind"])
def test_homo_warp_matches_jax(case):
    """Per view against JAX's homo_warp (vmapped as LSSBEVStereo calls it),
    to 1e-5 of the map's scale. identity: the map warps onto itself at any
    depth. behind: one plane at negative depth lies behind the sweep
    camera, samples at the sentinel 2.0 and reads zeros."""
    rs = np.random.RandomState(6)
    BN, S, H, W, C = 2, 3, 6, 8, 4
    feat = rs.randn(BN, H, W, C).astype(np.float32)
    intrin = _intrinsics(BN, W * 4, H * 4)
    depth = rs.uniform(2.0, 10.0, (BN, S, H, W)).astype(np.float32)
    if case == "identity":
        rot = np.broadcast_to(np.eye(3, dtype=np.float32), (BN, 3, 3))
        tran = np.zeros((BN, 3), np.float32)
    else:
        rot, tran = _rig(BN)
    if case == "behind":
        depth[:, 1] = -depth[:, 1]
    ref = jax.vmap(jax_homo_warp, in_axes=(0, 0, 0, 0, 0, 0, None))(
        *(jnp.asarray(a) for a in (feat, depth, intrin, intrin, rot, tran)),
        4)
    got = homo_warp(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        feat, depth, intrin, intrin, rot, tran)), stereo_downsample=4)
    assert got.shape == (BN, S, H, W, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * np.abs(feat).max())
    if case == "identity":
        np.testing.assert_allclose(got.numpy(), np.broadcast_to(
            feat[:, None], got.shape), atol=1e-3)
    if case == "behind":
        assert float(got[:, 1].abs().max()) == 0.0
        assert float(got[:, 0].abs().max()) > 0


# ---------------------------------------------------------------------------
# the depth net's reused modules at 2 and 6 cameras (ROADMAP C7)
# ---------------------------------------------------------------------------

def _reused(name, C):
    """(port module, JAX module, fill(reader, prefix), inputs kind) of one
    module the stereo depth net reuses from the mono DepthNet."""
    from coocc_tpu.nn import depthnet as J
    from coocc_tpu.nn import layers as jl
    from coocc_tpu_torch.convert import _aspp, _basic_block, _dcn
    from coocc_tpu_torch.nn import depthnet as P

    def dense(*names, conv1x1=False):
        return lambda r, t: [r.dense(f"{t}.{n}", f"{t}/{n}/linear", conv1x1)
                             for n in names]
    return {
        "bn": (BatchNorm(27), jl.BatchNorm(), lambda r, t: r.bn(t, f"{t}/bn"),
               "cam"),
        "Mlp": (P.Mlp(27, C, C), J.Mlp(C, C), dense("fc1", "fc2"), "cam"),
        "SELayer": (P.SELayer(C), J.SELayer(C),
                    dense("conv_reduce", "conv_expand", conv1x1=True), "se"),
        "BasicBlock2D": (P.BasicBlock2D(C), J.BasicBlock2D(C),
                         lambda r, t: _basic_block(r, t, t), "x"),
        "ASPP": (P.ASPP(C, C), J.ASPP(C), lambda r, t: _aspp(r, t, t), "x"),
        "DCN": (P.DCN(C, 4), J.DCNLayer(C, groups=4),
                lambda r, t: _dcn(r, t, t), "x"),
    }[name]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["bn", "Mlp", "SELayer", "BasicBlock2D",
                                  "ASPP", "DCN"])
def test_reused_module_matches_jax_at_2_and_6_cameras(name, train,
                                                      monkeypatch):
    """Each module the stereo depth net reuses, on the first 2 and on all
    6 cameras of one input (BatchNorm on the cameras' batch statistics in
    training), fp32, against JAX's: within 1e-5 of the output's scale at
    both counts, fp32 rounding (measured at most 9.2e-7: in training
    BasicBlock2D 3.3e-7 at 2 cameras and 8.0e-7 at 6, ASPP 7.9e-7 and
    9.2e-7, the camera vector's BatchNorm 1.5e-7 and 3.1e-7; DCN 0 and
    3.5e-7; Mlp and SELayer 0). No module rounds apart from
    JAX; the camera-only train step's depth_prob drift that grows with the
    camera count (ROADMAP C7) is its conditioning, not a module's
    rounding."""
    from coocc_tpu_torch.convert import _Reader
    from coocc_tpu_torch.nn.layers import Dropout
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    C, H, W = 32, 8, 22
    rs = np.random.RandomState(9)
    x6 = rs.randn(6, H, W, C).astype(np.float32)
    se6 = rs.randn(6, C).astype(np.float32)
    cam6 = rs.randn(6, 27).astype(np.float32)
    dists = []
    for n in (2, 6):
        mod, jmod, fill, kind = _reused(name, C)
        mod = init_weights(mod, seed=3).train(train)
        for m in mod.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        r = _Reader({f"m.{k}": v for k, v in mod.state_dict().items()})
        fill(r, "m")
        variables = {k: v["m"] for k, v in r.tree.items() if v}
        x, se, cam = x6[:n], se6[:n], cam6[:n]
        args = {"cam": (cam,), "se": (x, se), "x": (x,)}[kind]
        targs = [torch.from_numpy(a) for a in args]
        if kind != "cam":
            targs[0] = targs[0].permute(0, 3, 1, 2)
        kw = {"train": train} if name in ("BasicBlock2D", "ASPP") else {}
        if name == "bn":
            kw = {"use_running_average": not train}
        # jitted: flax's eager apply dispatches every op of the module
        ref = jax.jit(functools.partial(
            jmod.apply, mutable=["batch_stats"] if train else False, **kw))(
                variables, *map(jnp.asarray, args))
        ref = np.asarray(ref[0] if train else ref)
        with torch.no_grad():
            got = mod(*targs).numpy()
        if got.ndim == 4:
            got = got.transpose(0, 2, 3, 1)
        err = np.abs(got - ref).max() / np.abs(ref).max()
        dists.append(err)
        assert err <= 1e-5, (name, train, n, err)
    print(f"C7 {name} {'train' if train else 'eval'}: max |port - JAX| "
          f"{dists[0]:.3g} of the scale at 2 cameras, {dists[1]:.3g} at 6")


# ---------------------------------------------------------------------------
# DepthNetStereo and LSSBEVStereo
# ---------------------------------------------------------------------------

# tests/test_lss_stereo.py's shapes (stereo grid 16x24 under 64x96 images)
BN, FH, FW, C_IN = 2, 4, 6, 32
SH, SW, CS = 16, 24, 16
D, MID, CTX = 16, 16, 8
DBOUND = (2.0, 10.0, 0.5)
RANGES = ((2, 4), (4, 6), (6, 8), (8, 10))
GROUPS = 4


def _module_inputs():
    """(numpy arrays, in LSSBEVStereo's argument order, channels-last where
    JAX's are): key_feat, sweep_stereo, key_stereo, mlp_input, key and
    sweep intrinsics, the rig."""
    rs = np.random.RandomState(7)
    rot, tran = _rig(BN)
    intrin = _intrinsics(BN, SW * 4, SH * 4)
    return [rs.randn(BN, FH, FW, C_IN).astype(np.float32),
            rs.randn(BN, SH, SW, CS).astype(np.float32),
            rs.randn(BN, SH, SW, CS).astype(np.float32),
            rs.randn(BN, 27).astype(np.float32), intrin, intrin, rot, tran]


def _port_module(em_iteration):
    mod = LSSBEVStereo(C_IN, MID, CTX, D, DBOUND, RANGES,
                       em_iteration=em_iteration, num_groups=GROUPS)
    return init_weights(mod, seed=8).eval()


def _module_variables(mod):
    sub = stereo_depth_net_to_jax({f"{DEPTH_NET}.{k}": v for k, v in
                                   mod.state_dict().items()})
    return {col: jax.tree.map(jnp.asarray, tree) for col, tree in
            sub.items()}


def _port_call(mod, inputs, dtype, depth_net_only):
    """The port's module on the inputs (NCHW, features in `dtype`) ->
    channels-last fp32-widened numpy outputs."""
    def feat(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2).to(dtype)
    key, sweep, keyst, mlp, *geo = inputs
    with torch.no_grad():
        if depth_net_only:
            outs = mod.depth_net(feat(key), torch.from_numpy(mlp))
        else:
            outs = mod(feat(key), feat(sweep), feat(keyst),
                       torch.from_numpy(mlp),
                       *(torch.from_numpy(a) for a in geo))
    return [(o.permute(0, 2, 3, 1).float().numpy(), str(o.dtype)[6:])
            for o in outs]


def _jax_call(variables, inputs, em_iteration, bf16, depth_net_only):
    dtype = jnp.bfloat16 if bf16 else None
    key, sweep, keyst, mlp, *geo = (jnp.asarray(a) for a in inputs)
    if bf16:
        key, sweep, keyst = (a.astype(jnp.bfloat16)
                             for a in (key, sweep, keyst))
    if depth_net_only:
        mod = JaxDepthNetStereo(MID, CTX, D, num_ranges=len(RANGES),
                                dtype=dtype)
        v = {col: tree["depth_net"] for col, tree in variables.items()}
        outs = jax.jit(lambda v, k, m: mod.apply(v, k, m),
                       **(JIT16 if bf16 else {}))(v, key, mlp)[:5]
    else:
        mod = JaxLSSBEVStereo(mid_channels=MID, context_channels=CTX,
                              depth_channels=D, dbound=DBOUND,
                              range_list=RANGES, em_iteration=em_iteration,
                              num_groups=GROUPS, dtype=dtype)
        outs = jax.jit(mod.apply, **(JIT16 if bf16 else {}))(
            variables, key, sweep, keyst, mlp, *geo)
    return [(np.asarray(o.astype(jnp.float32)), o.dtype.name) for o in outs]


MODULE_CASES = [("depth_net", 1), ("stereo", 1), ("stereo", 3)]


@pytest.fixture(scope="module")
def modules():
    """{(which, em_iteration, dtype): (JAX's outputs, the port's)}: JAX's
    six compiles in threads beside the port's calls."""
    inputs = _module_inputs()
    out, jobs = {}, {}
    with ThreadPoolExecutor(6) as pool:
        for which, em in MODULE_CASES:
            mod = _port_module(em)
            variables = _module_variables(mod)
            only = which == "depth_net"
            for dtype in ("fp32", "bf16"):
                bf16 = dtype == "bf16"
                jobs[(which, em, dtype)] = pool.submit(
                    _jax_call, variables, inputs, em, bf16, only)
                out[(which, em, dtype)] = _port_call(
                    mod, inputs, torch.bfloat16 if bf16 else torch.float32,
                    only)
        return {k: (jobs[k].result(), v) for k, v in out.items()}


@pytest.mark.parametrize("which,em", MODULE_CASES)
def test_fp32_module_matches_jax(modules, which, em):
    """Every output (DepthNetStereo: context, mono depth, mu, sigma, range
    logits; LSSBEVStereo: context, depth_prob) within 1e-4 of its scale."""
    ref, got = modules[(which, em, "fp32")]
    assert len(ref) == len(got) == (5 if which == "depth_net" else 2)
    for i, ((r, _), (g, _)) in enumerate(zip(ref, got)):
        assert g.shape == r.shape, i
        scale = np.abs(r).max()
        assert scale > 0, i
        assert np.abs(g - r).max() <= 1e-4 * scale, (i, np.abs(g - r).max(),
                                                     scale)
    if which == "stereo":
        np.testing.assert_allclose(got[1][0].sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("which,em", MODULE_CASES)
def test_bf16_module_within_jax_own_drift(modules, which, em):
    ref16, got16 = modules[(which, em, "bf16")]
    ref32 = modules[(which, em, "fp32")][0]
    for i, ((j16, jd), (p16, pd), (j32, _)) in enumerate(
            zip(ref16, got16, ref32)):
        assert pd == jd, (i, pd, jd)
        port, own = np.abs(p16 - j16), np.abs(j16 - j32)
        assert own.max() > 0, i
        assert port.max() <= 2.0 * own.max(), (i, port.max(), own.max())
        assert port.mean() <= 1.5 * own.mean(), (i, port.mean(), own.mean())


# ---------------------------------------------------------------------------
# the tiny stereo model, every prefix
# ---------------------------------------------------------------------------

def _dense(cfg):
    return cfg.replace(pts=dataclasses.replace(cfg.pts, impl="dense"))


@pytest.fixture(scope="module")
def runs(stereo_convert):
    """{dtype: _run_both's result} of the tiny stereo model: every prefix
    from one JAX compile of the full forward per dtype, the two in
    threads. fp32 runs the default packed LiDAR encoder (K2's seam
    swapped, as the module note says), bf16 the dense twin on both sides
    (see test_bf16_matches_jax_bf16_within_its_own_drift)."""
    out = {}

    def run(dtype):
        bf16 = dtype == "bf16"
        pin = _dense if bf16 else (lambda c: c)
        try:
            out[dtype] = _run_both(
                pin(stereo_tiny(jax_tiny_config)),
                pin(stereo_tiny(tiny_config)), STAGES + (None,),
                capture=True, bf16=bf16)
        except BaseException as e:  # re-raised below
            out[dtype] = e
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("COOCC_PALLAS_SUBM", raising=False)  # JAX's XLA route
        mp.setattr(sparse_enc_packed, "subm_ext_conv", _fp32_subm)
        _in_threads(run, [("fp32",), ("bf16",)])
    for res in out.values():
        if isinstance(res, BaseException):
            raise res
    return out


@pytest.mark.parametrize("stop", STAGES)
def test_fp32_prefix_matches_jax(runs, stop):
    for key, a, b in _pairs(runs["fp32"], stop):
        assert a.shape == b.shape, key
        assert np.abs(b).max() > 0, f"{key} is all zero"
        np.testing.assert_allclose(b, a, err_msg=f"{stop}/{key}", **TOL)


def test_fp32_full_outputs_match_jax(runs):
    j, t = runs["fp32"][None]
    np.testing.assert_allclose(t["occ"], j["occ"], **TOL)
    np.testing.assert_array_equal(t["fine_valid"], j["fine_valid"])
    np.testing.assert_array_equal(t["fine_overflow"], j["fine_overflow"])
    (gc, gl), (rc, rl) = _fine_sorted(t), _fine_sorted(j)
    assert len(rc) > 0
    np.testing.assert_array_equal(gc, rc)
    np.testing.assert_allclose(gl, rl, **TOL)


def _drift_cases():
    return [("pts", "img_voxel", None), ("pts", "pts_voxel", None),
            ("fuse", "voxel_feats", None)] \
        + [("sem", "semantic", i) for i in range(4)] \
        + [(None, "occ", None), (None, "fine_logits", None)]


@pytest.mark.parametrize("stop,key,level", _drift_cases())
def test_bf16_matches_jax_bf16_within_its_own_drift(runs, stop, key, level):
    """bf16 with the dense LiDAR encoder on both sides (its bf16 twin
    rounds as JAX's does: pts_voxel equal but for a handful of values), so
    that the drift rule reads the stereo branch and what follows it; JAX's
    fp32 side is the packed fp32 run (its XLA route, the dense twin's
    function). With the packed encoder K2's plain version rounds its fused
    BatchNorm epilogue once where JAX's XLA route rounds twice (ROADMAP,
    handled): pts_voxel then sits as far from JAX's bf16 as JAX's bf16
    from its fp32 (mean ratio 1.00), and that noise reaches the deepest
    semantic level's 576 values at 2.03x JAX's max drift on this batch
    (one value 3 bf16 ulps off, the mean 0.99x). The packed encoder's bf16
    route is held by tests/test_torch_model.py and
    tests/test_torch_packed_encoder.py. Measured here, max and mean ratios:
    img_voxel 0.91, 0.63; voxel_feats 0.91, 0.45; semantic levels 0-3
    1.06, 0.87 / 1.07, 0.88 / 1.10, 0.86 / 1.43, 0.98; occ 1.28, 0.92;
    fine_logits 0.20, 0.50."""
    jb, tb = runs["bf16"][stop]
    jf = runs["fp32"][stop][0]
    if key == "fine_logits":
        tb, jb, jf = _common_fine(tb, jb, jf)
    else:
        tb, jb, jf = tb[key], jb[key], jf[key]
        if level is not None:
            tb, jb, jf = tb[level], jb[level], jf[level]
    assert tb.shape == jb.shape == jf.shape
    port, own = np.abs(tb - jb), np.abs(jb - jf)
    assert own.max() > 0
    assert port.max() <= 2.0 * own.max(), (port.max(), own.max())
    assert port.mean() <= 1.5 * own.mean(), (port.mean(), own.mean())


@pytest.mark.parametrize("stop", STAGES + (None,))
def test_bf16_prefix_dtypes_match_jax(runs, stop):
    dtypes = runs["bf16"]["dtypes"][stop]
    assert dtypes
    for key, (jd, td) in dtypes.items():
        assert jd == td, (stop, key)


def test_bf16_refines_the_cells_jax_refines(runs):
    j, t = runs["bf16"][None]
    assert _refined(t) == _refined(j)
    assert len(_refined(j)) > 0


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

TRAIN_EMS = (1, 3)
OUTPUTS = ("occ", "fine_logits", "depth_prob", "voxel_feats",
           "render_depth", "render_rgb")


def _counted_port_step(cfg, sd, prio):
    """_port_step's fp32 wiring step (K2's seam swapped for the unrounded
    conv), with each BatchNorm's calls in training counted. -> (raw, outs,
    grads, stats, {BatchNorm's name: calls})."""
    built, calls = [], {}
    forward = BatchNorm.forward

    def counted(self, x, update_stats=True):
        if self.training:
            calls[id(self)] = calls.get(id(self), 0) + 1
        return forward(self, x, update_stats)

    def build(*a, **k):
        built.append(build_model(*a, **k))
        return built[-1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BatchNorm, "forward", counted)
        mp.setattr(test_torch_train, "build_model", build)
        res = _port_step(cfg, sd, prio, None, True)
    names = {id(m): n for n, m in built[0].named_modules()
             if isinstance(m, BatchNorm)}
    return (*res, {names[i]: n for i, n in calls.items()})


def _jax_train(jcfg, cfg, variables):
    """JAX's fp32 value_and_grad (dropout off) -> ((raw, outs, port-named
    grads and statistics), [the same under two 1e-5 relative weight
    perturbations])."""
    raw, outs, grads, stats, fn = _jax_step(jcfg, variables, False)
    noise = []
    rs = np.random.RandomState(0)
    for _ in range(2):
        pert = jax.tree.map(lambda p: p * (1 + 1e-5 * rs.choice(
            [-1, 1], size=np.shape(p)).astype(np.float32)),
            variables["params"])
        (_, (r, s, o)), g = fn(pert, variables["batch_stats"])
        noise.append((r, o, _to_port(g, s, cfg)))
    return (raw, outs, _to_port(grads, stats, cfg)), noise


@pytest.fixture(scope="module")
def steps(stereo_convert):
    """{em_iteration: {"cfg", "sd", "wiring", "jax32", "noise"}} for the
    tiny config's 1 and the shipped 3: JAX's two compiles in threads, the
    port's fp32 wiring steps beside them."""
    n = int(np.prod(jax_tiny_config(stereo=True).lss_grid_size))
    prio = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 2), 0),
        (n,))))[None]
    out, jobs = {}, {}
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(2) as pool:
        mp.delenv("COOCC_PALLAS_SUBM", raising=False)  # JAX's XLA route
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        for em in TRAIN_EMS:
            jcfg = stereo_tiny(jax_tiny_config, em)
            cfg = stereo_tiny(tiny_config, em)
            sd = build_model(cfg, "cpu", seed=SEED).state_dict()
            jobs[em] = pool.submit(_jax_train, jcfg, cfg,
                                   _jax_variables(sd, jcfg))
            out[em] = {"cfg": cfg, "sd": sd}
        for em in TRAIN_EMS:
            o = out[em]
            o["wiring"] = _counted_port_step(o["cfg"], o["sd"], prio)
        for em in TRAIN_EMS:
            out[em]["jax32"], out[em]["noise"] = jobs[em].result()
    return out


def _own(o, part, key):
    """JAX's own change of one quantity (part 0: a raw loss term, 1: an
    output, 2: a gradient or statistic) under the weight perturbations:
    the larger of the two, elementwise max."""
    ref = _np(o["jax32"][part][key])
    return max(float(np.abs(_np(n[part][key]) - ref).max())
               for n in o["noise"])


def test_train_raw_loss_terms_match_jax(steps):
    o = steps[1]
    raw, jraw = o["wiring"][0], o["jax32"][0]
    assert set(raw) == set(jraw)
    assert {"loss_depth", "loss_depth_render", "loss_rgb"} <= set(raw)
    for k in jraw:
        np.testing.assert_allclose(_np(raw[k]), _np(jraw[k]), rtol=1e-4,
                                   err_msg=f"{k}: JAX's own change "
                                   f"{_own(o, 0, k)}")


@pytest.mark.parametrize("key", OUTPUTS)
def test_train_outputs_match_jax(steps, key):
    o = steps[1]
    got, ref = _np(o["wiring"][1][key]), _np(o["jax32"][1][key])
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(got - ref).max()
    assert err <= 1e-3 * scale, (key, err, scale, _own(o, 1, key))


@pytest.mark.parametrize("em", TRAIN_EMS)
def test_train_moved_bn_statistics_match_jax(steps, em):
    """Every moved statistic within 1e-3 of its scale, at both EM depths
    (at 3 the similarity net's two BatchNorms move twelve times in a
    chain)."""
    o = steps[em]
    stats, ref = o["wiring"][3], o["jax32"][2]
    assert len(stats) > 100
    for k, v in stats.items():
        r = ref[k].numpy()
        err = np.abs(v.numpy() - r).max()
        assert err <= 1e-3 * np.abs(r).max(), (k, err, _own(o, 2, k))
        assert not np.array_equal(v.numpy(), o["sd"][k].numpy()), k
    assert any(k.startswith(f"{DEPTH_NET}.sim_bn") for k in stats)


@pytest.mark.parametrize("em", TRAIN_EMS)
def test_train_bn_calls_backbone_twice_similarity_net_per_round(steps, em):
    """The statistics above moved as JAX's, through these calls: every
    backbone BatchNorm normalizes the key frame and then the previous one
    (all four stages), the similarity net's two BatchNorms once per range
    and EM round, every other BatchNorm once (the packed LiDAR encoder's
    masked ones go through packed_bn_train, not counted here)."""
    o = steps[em]
    calls = o["wiring"][4]
    stats = {k.rsplit(".", 1)[0] for k in o["wiring"][3]
             if not k.startswith("pts_middle_encoder.")}
    assert stats == set(calls)
    rounds = o["cfg"].lss.stereo_num_ranges * em
    for name, n in calls.items():
        if name.startswith("img_backbone."):
            want = 2
        elif name in (f"{DEPTH_NET}.sim_bn0", f"{DEPTH_NET}.sim_bn1"):
            want = rounds
        else:
            want = 1
        assert n == want, (name, n, want)
    assert any(k.startswith("img_backbone.layer4") for k in calls)


def test_train_gradients_match_jax_within_its_own_conditioning(steps):
    o = steps[1]
    grads, ref = o["wiring"][2], o["jax32"][2]
    errs = _leaf_errors(grads, ref)
    noise = {k: _own(o, 2, k) for k in errs}
    bad = [(k, e / max(s, 1e-30), noise[k] / max(s, 1e-30))
           for k, (e, s) in errs.items()
           if e > max(10 * noise[k], 0.1 * s)]
    assert not bad, bad
    rel = np.array([e / s for e, s in errs.values() if s > 0])
    assert len(rel) > 250
    assert np.median(rel) <= 0.06, np.median(rel)
    assert np.quantile(rel, 0.9) <= 0.2, np.quantile(rel, 0.9)
    assert any(k.startswith(f"{DEPTH_NET}.sim_fc") and float(
        g.abs().max()) > 0 for k, g in grads.items())


@pytest.mark.parametrize("part,key", [(0, None), *((1, k) for k in OUTPUTS)])
def test_em3_train_step_within_jax_own_change(steps, part, key):
    """At the shipped em_iteration 3 the tiny twin's training forward is
    ill-conditioned: three EM rounds on random-noise images, each moving
    mu by the softmax of a rough cost volume, amplify a 1e-5 relative
    weight perturbation into JAX's own change of 1.4-5.6% of depth_prob's
    scale and 0.9-1.3% of occ's (1.6e-3 and 2.2e-3 at em_iteration 1,
    where the fixed bounds above hold). Each raw loss term (part 0) and
    output the losses read (part 1) is held within that change, the larger
    of the two perturbations' (measured: at most 0.6 of it)."""
    o = steps[3]
    keys = sorted(o["jax32"][0]) if part == 0 else [key]
    for k in keys:
        err = float(np.abs(_np(o["wiring"][part][k])
                           - _np(o["jax32"][part][k])).max())
        own = _own(o, part, k)
        assert 0 < own and err <= own, (k, err, own)


def test_em3_gradients_within_jax_own_change(steps):
    """The per-leaf rule of the em_iteration 1 test (within 10x JAX's own
    change or 10% of the leaf's scale); over the leaves, the median
    relative error within JAX's own median relative change (the fixed 6%
    median does not apply where JAX's own gradients move by 28% of a
    leaf's scale at the median; measured: port 22%)."""
    o = steps[3]
    grads, ref = o["wiring"][2], o["jax32"][2]
    errs = _leaf_errors(grads, ref)
    noise = {k: _own(o, 2, k) for k in errs}
    bad = [(k, e / max(s, 1e-30), noise[k] / max(s, 1e-30))
           for k, (e, s) in errs.items()
           if e > max(10 * noise[k], 0.1 * s)]
    assert not bad, bad
    live = [k for k, (_, s) in errs.items() if s > 0]
    rel = np.array([errs[k][0] / errs[k][1] for k in live])
    own = np.array([noise[k] / errs[k][1] for k in live])
    assert np.median(rel) <= np.median(own), (np.median(rel),
                                              np.median(own))
