"""The envelope's other image, fusion and temporal modules, the port
against the JAX package on the CPU (fp32), each on the inputs of the JAX
package's own tests (tests/test_occnet.py, test_efficientnet.py,
test_golden_efficientnet.py, test_alt_necks.py, test_alt_modules.py,
test_temporal.py):

  * OccupancyEncoder, DualpathTransformerBlock (nn/occnet.py), EfficientNet
    b0 and es (nn/efficientnet.py), SECONDFPN2, GeneralizedLSSFPN,
    FPNRender (nn/alt_necks.py), AddFuser, AttnFuser (nn/alt_fusers.py) and
    MoE (nn/moe.py): JAX's module initialized by flax, every parameter
    perturbed and every BatchNorm statistic drawn from a seeded numpy
    generator, carried into the port by convert.module_state_dict_from_jax
    (strict); each output within 1e-4 of its scale in eval and in training
    (BatchNorm on batch statistics; dropout off on both sides, flax's
    patched to the identity; MoE's gate noise JAX's own draw from the same
    key, passed to the port), every moved statistic within 1e-4 of its
    scale;
  * FLoSP, ego_motion_bev_matrix, shift_bev_feature and
    TemporalBEVConcat (nn/flosp.py, models/temporal.py): against JAX's on
    the identity, a pure translation and a rotated, translated ego motion,
    with and without detach; the gather's gradient (gather_rows) against
    jax.vjp within 1e-5 of its scale;
  * the tables (_make_divisible, scaled_layers) equal to JAX's, and
    golden_refs.TorchEfficientNet's state_dict loading into the port
    straight and through JAX's convert_efficientnet, its outputs within
    tests/test_golden_efficientnet.py's tolerance.
JAX's jitted runs go through a thread pool beside the port's work.
"""
from concurrent.futures import ThreadPoolExecutor

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.models import temporal as jtemporal
from coocc_tpu.nn import alt_fusers as jfusers
from coocc_tpu.nn import alt_necks as jnecks
from coocc_tpu.nn import efficientnet as jeff
from coocc_tpu.nn import moe as jmoe
from coocc_tpu.nn import occnet as jocc
from coocc_tpu.nn.flosp import flosp as jflosp
from coocc_tpu.train.convert_torch import (ParamTreeBuilder,
                                           convert_efficientnet)

from coocc_tpu_torch.convert import module_state_dict_from_jax
from coocc_tpu_torch.models import temporal
from coocc_tpu_torch.nn import alt_fusers, alt_necks, efficientnet, moe, occnet
from coocc_tpu_torch.nn.flosp import flosp
from coocc_tpu_torch.nn.layers import Dropout
from golden_refs import TorchEfficientNet, randomize_bn_stats
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

REL = 1e-4


def _randomized(variables, seed):
    """Every parameter moved by 10% of its leaf's spread (0.1 where the
    leaf is constant: biases, norm scales), BN statistics drawn."""
    rs = np.random.RandomState(seed)

    def param(p):
        p = np.asarray(p)
        s = 0.1 * (p.std() if p.std() > 0 else 1.0)
        return (p + rs.standard_normal(p.shape) * s).astype(np.float32)

    def stat(path, v):
        v = np.asarray(v)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return (rs.rand(*v.shape) * 1.5 + 0.2).astype(np.float32)
        return (rs.standard_normal(v.shape) * 0.3).astype(np.float32)
    out = {"params": jax.tree.map(param, variables["params"])}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            stat, variables["batch_stats"])
    return out


def _close(got, ref, what, rel=REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0, what
    assert np.abs(got - ref).max() <= rel * scale, (
        what, np.abs(got - ref).max(), scale)


def _cl(t):
    """channels-first torch -> channels-last numpy."""
    return t.detach().movedim(1, -1).numpy()


def _cf(a):
    """channels-last numpy -> channels-first torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


# each case: (JAX module, port module from its JAX one, JAX inputs, the
# port's call on them, its outputs as JAX's layout, whether JAX's call
# takes `train`)
def _feats(rng, chans, H=16, W=24):
    return [rng.randn(1, H // 2 ** i, W // 2 ** i, c).astype(np.float32)
            for i, c in enumerate(chans)]


def _grids(rng):
    return (rng.rand(1, 8, 8, 4, 32).astype(np.float32),
            rng.rand(1, 8, 8, 4, 32).astype(np.float32))


def _cases():
    rng = np.random.RandomState(0)
    many = lambda outs: [_cl(o) for o in outs]  # noqa: E731
    return {
        "dualpath": (
            jocc.DualpathTransformerBlock(channels=32, stride=2, shift=True,
                                          head_channels=8),
            occnet.DualpathTransformerBlock(24, 32, 2, True, 8),
            (rng.randn(1, 16, 16, 4, 24).astype(np.float32),),
            lambda m, x: m(_cf(x)), _cl, True),
        "occupancy_encoder": (
            jocc.OccupancyEncoder(block_numbers=(1, 1),
                                  block_inplanes=(16, 32),
                                  block_strides=(1, 2), out_indices=(0, 1)),
            occnet.OccupancyEncoder(16, (1, 1), (16, 32), (1, 2), (0, 1)),
            (rng.randn(1, 16, 16, 8, 16).astype(np.float32),),
            lambda m, x: m(_cf(x)), many, True),
        "efficientnet_b0": (
            jeff.EfficientNet(arch="b0", out_indices=(2, 3, 4, 5)),
            efficientnet.EfficientNet("b0", (2, 3, 4, 5)),
            (rng.randn(1, 64, 96, 3).astype(np.float32),),
            lambda m, x: m(_cf(x)), many, True),
        "efficientnet_es": (
            jeff.EfficientNet(arch="es", out_indices=(2, 3, 4)),
            efficientnet.EfficientNet("es", (2, 3, 4)),
            (rng.randn(1, 64, 64, 3).astype(np.float32),),
            lambda m, x: m(_cf(x)), many, True),
        "secondfpn2": (
            jnecks.SECONDFPN2(in_channels=(8, 16, 32),
                              out_channels=(8, 8, 8),
                              upsample_strides=(1, 2, 4)),
            alt_necks.SECONDFPN2((8, 16, 32), (8, 8, 8), (1, 2, 4)),
            (_feats(rng, (8, 16, 32)),),
            lambda m, f: m([_cf(a) for a in f]), many, True),
        "generalized_lss_fpn": (
            jnecks.GeneralizedLSSFPN(in_channels=(8, 16, 32),
                                     out_channels=12),
            alt_necks.GeneralizedLSSFPN((8, 16, 32), 12),
            (_feats(rng, (8, 16, 32)),),
            lambda m, f: m([_cf(a) for a in f]), many, True),
        "fpn_render": (
            jnecks.FPNRender(in_channels=(8, 16, 32, 64), out_channels=10),
            alt_necks.FPNRender((8, 16, 32, 64), 10),
            (_feats(rng, (8, 16, 32, 64)),),
            lambda m, f: m([_cf(a) for a in f]), many, False),
        "add_fuser": (
            jfusers.AddFuser(in_channels=32, out_channels=32),
            alt_fusers.AddFuser(32, 32), _grids(rng),
            lambda m, i, p: m(_cf(i), _cf(p)), _cl, True),
        "attn_fuser": (
            jfusers.AttnFuser(in_channels=32, out_channels=32, num_heads=4),
            alt_fusers.AttnFuser(32, 32, 4), _grids(rng),
            lambda m, i, p: m(_cf(i), _cf(p)), _cl, True),
        "moe": (
            jmoe.MoE(num_experts=4, k=2, hidden=32, out_features=8),
            moe.MoE(16, 4, 2, 32, 8),
            (rng.rand(10, 16).astype(np.float32),),
            lambda m, x: m(torch.from_numpy(x)),
            lambda t: t.detach().numpy(), True),
    }


CASES = ("dualpath", "occupancy_encoder", "efficientnet_b0",
         "efficientnet_es", "secondfpn2", "generalized_lss_fpn",
         "fpn_render", "add_fuser", "attn_fuser", "moe")


def _jax_side(name, jmod, inputs, has_train):
    """JAX's init (randomized), eval and train outputs, moved statistics,
    and (MoE) the gate noise drawn in training."""
    args = [jax.tree.map(jnp.asarray, a) for a in inputs]
    kw = {"train": False} if has_train else {}
    # jitted: flax's eager init dispatches every op of the forward
    variables = _randomized(jax.tree.map(np.asarray, jax.jit(
        lambda *a: jmod.init({"params": jax.random.PRNGKey(0)}, *a, **kw))(
            *args)), 1)
    out = {"variables": variables,
           "eval": jax.jit(lambda v, *a: jmod.apply(v, *a, **kw))(
               variables, *args)}
    if not has_train:
        return jax.tree.map(np.asarray, out)
    rngs = {"dropout": jax.random.PRNGKey(1)}
    drawn = []
    if name == "moe":
        normal = jax.random.normal

        def record(*a, **k):
            drawn.append(normal(*a, **k))
            return drawn[-1]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "normal", record)
            y, upd = jmod.apply(variables, *args, train=True, rngs=rngs,
                                mutable=["batch_stats"])
        out["noise"] = drawn[0]
    else:
        y, upd = jax.jit(lambda v, *a: jmod.apply(
            v, *a, train=True, rngs=rngs, mutable=["batch_stats"]))(
                variables, *args)
    out["train"] = y
    out["stats"] = upd.get("batch_stats", {})
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def modules():
    """{case: (JAX's results, the port's eval outputs, its train outputs,
    {statistic: (JAX's moved, the port's moved)}, the port module)}."""
    cases = _cases()
    assert tuple(cases) == CASES
    res = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        # MoE's records its noise draw through a patched jax.random.normal:
        # before the pool's threads, whose inits draw too
        jobs = {"moe": _jax_side("moe", *(cases["moe"][i]
                                          for i in (0, 2, 5)))}
        with ThreadPoolExecutor(4) as pool:
            jobs.update({n: pool.submit(_jax_side, n, c[0], c[2], c[5])
                         for n, c in cases.items() if n != "moe"})
            res = _port_side(cases, jobs)
    return res


def _port_side(cases, jobs):
    res = {}
    for name, (_, port, inputs, call, back, has_train) in cases.items():
        ref = jobs[name] if name == "moe" else jobs[name].result()
        port.load_state_dict(module_state_dict_from_jax(
            port, ref["variables"]), strict=True)
        for m in port.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        with torch.no_grad():
            got = back(call(port.eval(), *inputs))
        trained = state = None
        if has_train:
            port.train()
            if name == "moe":
                trained = back(port(torch.from_numpy(inputs[0]),
                                    torch.from_numpy(np.array(ref["noise"]))))
            else:
                trained = back(call(port, *inputs))
            moved = module_state_dict_from_jax(port, {
                "params": ref["variables"]["params"],
                "batch_stats": ref["stats"]})
            state = {k: (v, port.state_dict()[k])
                     for k, v in moved.items() if "running" in k}
        res[name] = (ref, got, trained, state, port)
    return res


def _pairs(got, ref):
    if isinstance(got, list):
        assert len(got) == len(ref)
        return list(zip(got, ref))
    return [(got, ref)]


@pytest.mark.parametrize("name", CASES)
def test_eval_matches_jax(modules, name):
    ref, got = modules[name][:2]
    for i, (g, r) in enumerate(_pairs(got, ref["eval"])):
        _close(g, r, f"{name}[{i}]")


@pytest.mark.parametrize("name", [n for n in CASES if n != "fpn_render"])
def test_train_matches_jax(modules, name):
    ref, _, trained, state, _ = modules[name]
    for i, (g, r) in enumerate(_pairs(trained, ref["train"])):
        _close(g, r, f"{name}[{i}] in training")
    if name == "moe":
        # the noise moved the gate: training differs from eval
        assert not np.allclose(ref["train"], ref["eval"])
        return
    assert len(state) >= 2
    before = module_state_dict_from_jax(modules[name][4],
                                        ref["variables"])
    for k, (jv, pv) in state.items():
        _close(pv.numpy(), jv.numpy(), k)
        assert not torch.equal(pv, before[k]), k


def test_efficientnet_tables_equal_jax():
    for v in (16.0, 17.6, 44.8, 640.0, 7.9):
        assert efficientnet._make_divisible(v) == jeff._make_divisible(v)
    for arch in efficientnet.ARCHS:
        assert efficientnet.scaled_layers(arch) == jeff.scaled_layers(arch)


@pytest.mark.parametrize("arch", ["b0", "es"])
def test_efficientnet_reference_names_through_jax_converter(arch):
    """golden_refs.TorchEfficientNet (the reference's mmdet names) ->
    JAX's convert_efficientnet -> convert.module_state_dict_from_jax: the
    port's state_dict has the reference's names (its own checkpoint loads
    straight in) and both routes give its outputs within
    tests/test_golden_efficientnet.py's tolerance."""
    torch.manual_seed(0)
    out_indices = (2, 3, 4)
    tm = TorchEfficientNet(arch=arch, out_indices=out_indices)
    with torch.no_grad():
        for p in tm.parameters():
            p.copy_(0.1 * torch.randn_like(p))
    randomize_bn_stats(tm, np.random.RandomState(0))
    tm.eval()
    x = torch.from_numpy(np.random.RandomState(1).randn(
        1, 3, 64, 64).astype(np.float32))
    b = ParamTreeBuilder()
    convert_efficientnet(b, {"m." + k: v.numpy() for k, v in
                             tm.state_dict().items()}, "m", "eff",
                         arch=arch, out_indices=out_indices)
    via_jax = efficientnet.EfficientNet(arch, out_indices).eval()
    via_jax.load_state_dict(module_state_dict_from_jax(via_jax, {
        "params": b.params["eff"], "batch_stats": b.batch_stats["eff"]}))
    direct = efficientnet.EfficientNet(arch, out_indices).eval()
    direct.load_state_dict(tm.state_dict())
    assert set(direct.state_dict()) == {
        k for k in tm.state_dict() if not k.endswith("num_batches_tracked")}
    with torch.no_grad():
        ref = tm(x)
        for port in (via_jax, direct):
            got = port(x)
            assert len(got) == len(ref) == 3
            for g, r in zip(got, ref):
                atol = 3e-4 + 1e-5 * float(r.abs().max())
                np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-4,
                                           atol=atol)


def test_occnet_groups_fit_like_jax():
    for g, ch in ((32, 8), (32, 24), (32, 64), (32, 48), (32, 2)):
        m = occnet.BottleNeckASPP(ch * 4, num_groups=g)
        assert m.input_gn.num_groups == occnet.fit_groups(g, ch)
        assert ch % m.input_gn.num_groups == 0


# ---------------------------------------------------------------------------
# FLoSP and the temporal alignment
# ---------------------------------------------------------------------------

def _poses(seed):
    """[1, 2, 3, 3] rotations about z and [1, 2, 3] translations of two
    frames."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        a = rs.uniform(-0.3, 0.3)
        r = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                      [0, 0, 1]], np.float32)
        t = rs.uniform(-1.5, 1.5, 3).astype(np.float32)
        out += [np.broadcast_to(r, (1, 2, 3, 3)).copy(),
                np.broadcast_to(t, (1, 2, 3)).copy()]
    return out


def test_ego_motion_matches_jax():
    rc, tc, ra, ta = _poses(0)
    ref = jtemporal.ego_motion_bev_matrix(rc[:, 0], tc[:, 0], ra[:, 0],
                                          ta[:, 0])
    got = temporal.ego_motion_bev_matrix(*(torch.from_numpy(a[:, 0])
                                           for a in (rc, tc, ra, ta)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    ident = temporal.ego_motion_bev_matrix(
        torch.eye(3)[None], torch.zeros(1, 3), torch.eye(3)[None],
        torch.zeros(1, 3))
    np.testing.assert_allclose(ident.numpy(), np.eye(3)[None], atol=1e-6)


@pytest.mark.parametrize("motion", ["identity", "translation", "rotation"])
def test_shift_bev_feature_matches_jax(motion):
    rs = np.random.RandomState(1)
    X, Y, K, dx, bx = 8, 10, 4, (0.5, 0.5), (-2.0, -2.0)
    feat = rs.randn(1, X, Y, K).astype(np.float32)
    if motion == "identity":
        m = np.eye(3, dtype=np.float32)[None]
    elif motion == "translation":
        m = np.array([[[1, 0, 2 * dx[0]], [0, 1, 0], [0, 0, 1]]],
                     np.float32)
    else:
        rc, tc, ra, ta = _poses(2)
        m = np.asarray(jtemporal.ego_motion_bev_matrix(
            rc[:, 0], tc[:, 0], ra[:, 0], ta[:, 0]))
    ref = np.asarray(jtemporal.shift_bev_feature(jnp.asarray(feat),
                                                 jnp.asarray(m), dx, bx))
    got = temporal.shift_bev_feature(_cf(feat),
                                     torch.from_numpy(np.array(m)), dx, bx)
    _close(_cl(got), ref, motion, 1e-5)
    if motion == "translation":
        assert np.abs(_cl(got)[0, X - 2:]).max() == 0  # off-grid -> zeros


@pytest.mark.parametrize("detach", [True, False])
def test_temporal_concat_matches_jax(detach):
    rs = np.random.RandomState(3)
    curr = rs.randn(1, 6, 6, 2, 4).astype(np.float32)
    prev = rs.randn(1, 6, 6, 2, 4).astype(np.float32)
    poses = _poses(4)
    geo = ((0.5, 0.5), (-1.5, -1.5))
    cot = rs.randn(1, 6, 6, 2, 8).astype(np.float32)
    jm = jtemporal.TemporalBEVConcat(detach=detach)
    # jitted: flax's eager init and apply dispatch every op on its own
    v = jax.jit(lambda c, p: jm.init(jax.random.PRNGKey(0), c, p, *poses,
                                     *geo))(curr, prev)

    def f(c, p):
        return jm.apply(v, c, p, *(jnp.asarray(a) for a in poses), *geo)
    ref, vjp = jax.vjp(jax.jit(f), jnp.asarray(curr), jnp.asarray(prev))
    _, gprev = vjp(jnp.asarray(cot))
    tprev = _cf(prev).requires_grad_()
    got = temporal.TemporalBEVConcat(detach=detach)(
        _cf(curr), tprev, *(torch.from_numpy(a) for a in poses), *geo)
    _close(_cl(got), np.asarray(ref), "concat", 1e-5)
    np.testing.assert_array_equal(_cl(got)[..., :4], curr)
    if detach:
        assert not got.requires_grad and np.abs(np.asarray(gprev)).max() == 0
        return
    (got * _cf(cot)).sum().backward()
    _close(_cl(tprev.grad), np.asarray(gprev), "d prev", 1e-5)


def test_flosp_matches_jax():
    rs = np.random.RandomState(5)
    C, H, W, scene = 3, 4, 5, (3, 2, 4)
    V = int(np.prod(scene))
    x2d = rs.randn(H, W, C).astype(np.float32)
    pix = np.stack([rs.randint(-2, W + 2, V), rs.randint(-2, H + 2, V)],
                   1).astype(np.int32)
    fov = rs.rand(V) < 0.8
    ref, vjp = jax.vjp(lambda x: jflosp(x, jnp.asarray(pix),
                                        jnp.asarray(fov), scene),
                       jnp.asarray(x2d))
    cot = rs.randn(*scene, C).astype(np.float32)
    (gref,) = vjp(jnp.asarray(cot))
    tx = torch.from_numpy(x2d).permute(2, 0, 1).contiguous() \
        .requires_grad_()
    got = flosp(tx, torch.from_numpy(pix), torch.from_numpy(fov), scene)
    np.testing.assert_array_equal(got.detach().permute(1, 2, 3, 0).numpy(),
                                  np.asarray(ref))
    (got * torch.from_numpy(cot).permute(3, 0, 1, 2)).sum().backward()
    _close(tx.grad.permute(1, 2, 0).numpy(), np.asarray(gref), "d x2d",
           1e-5)
    assert (np.asarray(ref).reshape(-1, C)[~fov] == 0).all()
