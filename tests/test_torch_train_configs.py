"""One train step of the port == JAX's `value_and_grad` for the shipped
configs other than the flagship, at tiny shapes (CPU).

The twins: `lidar_tiny` of tests/test_torch_configs.py (coocc_lidar: the
HD encoder on a 64x64x65 grid, SECOND3D + FPN, no cascade, the depth-only
render on a stride-16 frustum), and training twins of its `openocc_tiny`
and `cam_tiny` (below: their coarse grids grown so that the semantic
stack's deepest BatchNorms see 8 and 25 cells, not 2 and 9; neither
package's tiny_config changes): `openocc_train`
(coocc_multi_r101_openoccupancy: cascade ratio 4, the LiDAR Z of 80
packing p = 4/2/1) and `cam_train` (coocc_cam_r101_896x1600: no LiDAR, no
fuser, rgb and depth rendered from img_voxel). For each, one state_dict
goes through convert_coocc_ray and both sides take one training step on
synthetic_batch(seed=3) as tests/test_torch_train.py does for the flagship
(dropout off on both sides, the training cascade on JAX's own priorities),
and JAX's gradients and moved statistics come back under the port's
names.

What is held, and how tight:
  * fp32 wiring, every config, at the flagship test's bounds: the port
    with K2 swapped for an fp32 conv at the encoders' `subm_conv` seam
    (JAX's fp32 XLA route does not round the SubM operands to bf16; K2
    does): the raw loss terms to rtol 1e-4 (with loss_depth_render for
    coocc_lidar, loss_rgb for the camera-only model), the outputs the
    losses read to 1e-3 of their scale, the moved BN statistics to 1e-3 of
    their scale (the HD encoder's masked ones and SECOND3D's among them),
    the refined cells equal; the gradients per leaf within 10x JAX's own
    change under a 1e-5 relative weight perturbation (the larger of two)
    or 10% of the leaf's scale, the median leaf within 6% of its scale and
    the 90th percentile within 20%. JAX's own change is reported beside
    each failure.
  * coocc_lidar, the full packed route (K2's bf16 operands, its dX's plain
    version and dW) in fp32, and the bf16 step against JAX's bf16 step
    (compiled with xla_allow_excess_precision off): each output (and the
    packed route's raw loss terms) within 2x (max) and 1.5x (mean) of
    JAX's own bf16-vs-fp32 drift, equal dtypes; the bf16 step's loss terms
    equal JAX's losses of its outputs to a bf16 ulp.
  * `packed_bn_train` moves the running statistics by its BatchNorm's own
    momentum: at 0.01 (the HD encoder's) and 0.1 (the flagship's), equal
    to JAX's `_PackedBNCore` within 1e-6 of their scale; its backward and
    `BatchNorm`'s (both keep only the input and the [C] statistics) equal
    autograd through the same normalization in fp32.
  * the train CLI on coocc_lidar's tiny twin on the CPU: one epoch of 2
    steps, then a resume for a second; the checkpoint holds the HD
    encoder's and SECOND3D's moved statistics bit for bit.

JAX compiles once per config and dtype, in threads beside the port's
steps (XLA compiles without holding the interpreter lock).
"""
import contextlib
import dataclasses
import io
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from coocc_tpu.data.synthetic import tiny_config as jax_tiny_config
from coocc_tpu.losses import ssc as jax_ssc
from coocc_tpu.models.coocc_ray import CoOccRay as JaxCoOccRay
from coocc_tpu.models.losses import compute_losses as jax_compute_losses
from coocc_tpu.nn.sparse_enc_packed import _PackedBNCore
from coocc_tpu.train.convert_torch import convert_coocc_ray

from test_torch_configs import cam_tiny, lidar_configs, occ_grid, openocc_tiny
from test_torch_train import (BATCH_SEED, SEED, _leaf_errors, _np, _port_step,
                              _raw, _to_port)

from coocc_tpu_torch.data.synthetic import tiny_config
from coocc_tpu_torch.entry import build_model
from coocc_tpu_torch.nn.layers import BatchNorm
from coocc_tpu_torch.nn.sparse_enc_packed import packed_bn_train
from coocc_tpu_torch.train import __main__ as train_cli
from coocc_tpu_torch.train.checkpoint import CheckpointManager
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)


# The training twins of openocc_tiny and cam_tiny. The serving twins'
# coarse grids (8x8x10, 20x20x4) end the semantic stack (strides 1, 2, 2,
# 2) on 2 and 9 cells, where BatchNorm on batch statistics is
# ill-conditioned: under a 1e-5 relative weight perturbation JAX's own occ
# moves by 10% of its scale in the first, and its gradients by 106% and
# 14% of a leaf's scale at the median leaf. These end on 8 cells (12x12x10,
# LiDAR 96x96x80 at the serving twin's Z and packing) and 25 (40x40x6).
OPENOCC_OCC, OPENOCC_LIDAR = (48, 48, 40), (96, 96, 80)
CAM_OCC = (80, 80, 12)


def openocc_train(tiny):
    return openocc_tiny(tiny, OPENOCC_OCC, OPENOCC_LIDAR)


def cam_train(tiny):
    cfg = cam_tiny(tiny)
    return cfg.replace(
        occ_size=CAM_OCC, grid=occ_grid(cfg, CAM_OCC, cfg.lss_downsample),
        occ_head=dataclasses.replace(cfg.occ_head, final_occ_size=CAM_OCC))


def _configs(name):
    """(JAX's, the port's) tiny training config of `name`."""
    if name == "lidar":
        return lidar_configs()
    make = {"openocc": openocc_train, "cam": cam_train}[name]
    return make(jax_tiny_config), make(tiny_config)


NAMES = ("lidar", "openocc", "cam")
# the outputs the losses read, per config
OUTPUTS = {
    "lidar": ("occ", "voxel_feats", "render_depth"),
    "openocc": ("occ", "fine_logits", "depth_prob", "voxel_feats",
                "render_depth", "render_rgb"),
    "cam": ("occ", "fine_logits", "depth_prob", "voxel_feats",
            "render_depth", "render_rgb"),
}
# the losses each config computes (JAX compute_losses)
VOXEL = ("loss_voxel_ce", "loss_voxel_sem_scal", "loss_voxel_geo_scal",
         "loss_voxel_lovasz")
LOSSES = {
    "lidar": {f"{k}_c_0" for k in VOXEL} | {"loss_depth_render"},
    "openocc": {f"{k}_{t}" for k in VOXEL for t in ("c_0", "fine")}
    | {"loss_depth", "loss_depth_render", "loss_rgb"},
    "cam": {f"{k}_{t}" for k in VOXEL for t in ("c_0", "fine")}
    | {"loss_depth", "loss_depth_render", "loss_rgb"},
}


def _jax_batch(jcfg):
    return jax.tree.map(lambda x: None if x is None else jnp.asarray(x),
                        jax_synthetic_batch(jcfg, batch_size=1,
                                            seed=BATCH_SEED),
                        is_leaf=lambda x: x is None)


def _jax_step(name, jcfg, variables, bf16):
    """JAX's value_and_grad of its train loss (dropout off) -> (raw loss
    terms, the outputs the losses read, grads, moved statistics, the
    compiled grad fn)."""
    batch = _jax_batch(jcfg)
    model = JaxCoOccRay(cfg=jcfg, dtype=jnp.bfloat16 if bf16 else None)
    rng = jax.random.PRNGKey(0)
    keep = OUTPUTS[name] + ("fine_coords", "fine_valid")

    def loss_fn(params, stats):
        outs, mutated = model.apply(
            {"params": params, "batch_stats": stats}, batch, train=True,
            fine_rng=jax.random.fold_in(rng, 2),
            rngs={"dropout": jax.random.fold_in(rng, 1)},
            mutable=["batch_stats"])
        losses = jax_compute_losses(outs, batch, jcfg)
        total = sum(v for k, v in losses.items() if k.startswith("loss"))
        raw = jax_compute_losses(outs, batch, _raw(jcfg))
        return total, (raw, mutated["batch_stats"],
                       {k: outs[k] for k in keep if k in outs})

    opts = {"xla_allow_excess_precision": False} if bf16 else None
    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                 compiler_options=opts)
    (_, (raw, stats, outs)), grads = fn(variables["params"],
                                        variables["batch_stats"])
    return raw, outs, grads, stats, fn


def _jax_side(name, jcfg, cfg, variables):
    """JAX's fp32 step and the yardstick: the same step with the weights
    perturbed by 1e-5 relative (random signs), twice, through the compiled
    step -> (raw, outs, port-named grads and statistics, [(raw, outs,
    port-named grads and statistics) perturbed])."""
    raw, outs, grads, stats, fn = _jax_step(name, jcfg, variables, False)
    noise = []
    rs = np.random.RandomState(0)
    for _ in range(2):
        pert = jax.tree.map(lambda p: p * (1 + 1e-5 * rs.choice(
            [-1, 1], size=np.shape(p)).astype(np.float32)),
            variables["params"])
        (_, (r, s, o)), g = fn(pert, variables["batch_stats"])
        noise.append((r, o, _to_port(g, s, cfg)))
    return raw, outs, _to_port(grads, stats, cfg), noise


def _jax_bce(p, target):
    """JAX's `_bce` (coocc_tpu/losses/ssc.py:16-19) without its term of
    weight 0: the port's `_bce` (coocc_tpu_torch/losses/ssc.py)."""
    p = jnp.clip(p, 1e-12, 1.0 - 1e-12)
    loss = -target * jnp.log(p)
    if target != 1.0:
        loss = loss - (1.0 - target) * jnp.log(1.0 - p)
    return loss


def _jax_losses_of(jcfg, outs):
    """JAX's raw loss terms of the port's bf16 coocc_lidar outputs."""
    jouts = {"occ": jnp.asarray(_np(outs["occ"])).astype(jnp.bfloat16),
             "render_depth": jnp.asarray(_np(outs["render_depth"]))}
    return jax_compute_losses(jouts, _jax_batch(jcfg), _raw(jcfg))


@pytest.fixture(scope="module")
def steps():
    """{name: {"cfg", "sd", "jax32", "noise", "wiring"}}, and for lidar
    "jax16", "packed" and "bf16": JAX's compiles in threads, the port's
    steps in this one."""
    out = {}
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(5) as pool:
        mp.delenv("COOCC_PALLAS_SUBM", raising=False)  # JAX's XLA route
        # dropout off in JAX's trace
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        # where geo_scal's precision rounds to 1.0 (a synthetic
        # OpenOccupancy ground truth pooled to no empty coarse cell), JAX's
        # 0 * log(0) makes its loss and every gradient NaN; the port
        # leaves that term out
        mp.setattr(jax_ssc, "_bce", _jax_bce)
        jobs = {}
        for name in NAMES:
            jcfg, cfg = _configs(name)
            sd = build_model(cfg, "cpu", seed=SEED).state_dict()
            variables = convert_coocc_ray(
                {k: v.numpy() for k, v in sd.items()}, jcfg)
            n = int(np.prod(jcfg.lss_grid_size))
            prio = torch.from_numpy(np.array(jax.random.uniform(
                jax.random.fold_in(jax.random.fold_in(
                    jax.random.PRNGKey(0), 2), 0), (n,))))[None]
            out[name] = {"cfg": cfg, "jcfg": jcfg, "sd": sd, "prio": prio}
            jobs[name] = pool.submit(_jax_side, name, jcfg, cfg, variables)
            if name == "lidar":
                jobs["lidar16"] = pool.submit(_jax_step, name, jcfg,
                                              variables, True)
        o = out["lidar"]
        o["packed"] = _port_step(o["cfg"], o["sd"], o["prio"], None, False)
        o["bf16"] = _port_step(o["cfg"], o["sd"], o["prio"], torch.bfloat16,
                               False)
        jobs["bf16_losses"] = pool.submit(_jax_losses_of, o["jcfg"],
                                          o["bf16"][1])
        for o in out.values():
            o["wiring"] = _port_step(o["cfg"], o["sd"], o["prio"], None, True)
        for name in NAMES:
            raw, outs, ported, noise = jobs[name].result()
            out[name].update(jax32=(raw, outs, ported), noise=noise)
        o = out["lidar"]
        raw, outs, grads, stats, _ = jobs["lidar16"].result()
        o["jax16"] = (raw, outs, _to_port(grads, stats, o["cfg"]))
        o["bf16_jax_losses"] = jobs["bf16_losses"].result()
    return out


# ---------------------------------------------------------------------------
# the masked BatchNorm's statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("momentum", [0.01, 0.1])
def test_packed_bn_train_moves_statistics_by_its_momentum(momentum):
    """`packed_bn_train` against JAX's `_PackedBNCore(C, eps=1e-3,
    momentum)` on a packed [1, 3, 6, 5, p*C] tensor with a sparse mask,
    from running statistics away from their initial values: the moved
    mean and variance within 1e-6 of their scale, and the output."""
    rs = np.random.RandomState(int(momentum * 100))
    p, C = 4, 8
    x = (rs.randn(1, 3, 6, 5, p * C) * 2 + 0.5).astype(np.float32)
    m = rs.rand(1, 3, 6, 5, p) < 0.3
    mean0 = rs.randn(C).astype(np.float32)
    var0 = (rs.rand(C) + 0.5).astype(np.float32)
    scale = (rs.rand(C) + 0.5).astype(np.float32)
    bias = rs.randn(C).astype(np.float32)
    core = _PackedBNCore(C, eps=1e-3, momentum=momentum)
    y, mut = core.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x), jnp.asarray(np.repeat(m, C, -1), jnp.float32), True,
        mutable=["batch_stats"])
    bn = BatchNorm(C, eps=1e-3, momentum=momentum)
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    got = packed_bn_train(bn, torch.from_numpy(x), torch.from_numpy(m))
    for ours, ref, start in (
            (bn.running_mean, mut["batch_stats"]["mean"], mean0),
            (bn.running_var, mut["batch_stats"]["var"], var0)):
        ref = np.asarray(ref)
        assert np.abs(ours.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
        # the step moved them by about momentum of the way
        assert np.abs(ref - start).max() > 1e-3 * momentum
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)


def _bn_reference(x, w, b, eps, mcell=None):
    """The training BatchNorm's forward as plain fp32 ops, for autograd:
    over dim 1 of x, or (mcell given) JAX's masked one over x's last dim."""
    if mcell is None:
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mean = x.mean(dims)
        var = ((x * x).mean(dims) - mean * mean).clamp(min=0.0)
        return (x - mean.view(shape)) * (torch.rsqrt(var + eps)
                                         * w).view(shape) + b.view(shape)
    m = mcell[..., None].float()
    dims = tuple(range(x.dim() - 1))
    n = mcell.sum().float()
    mean = (x * m).sum(dims) / n
    var = ((x * m * x).sum(dims) / n - mean * mean).clamp(min=0.0)
    return ((x - mean) / torch.sqrt(var + eps) * w + b) * m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm_backward_is_the_batch_statistics_gradient(masked, dtype):
    """`BatchNorm`'s and `packed_bn_train`'s backward (they keep the input
    and the [C] statistics, not autograd's fp32 copies) against autograd
    through the same normalization in fp32 on the same values: dW and dB
    within 1e-5 of their scale, dX within 1e-5 of its scale in fp32 and,
    rounded once to bf16, within a bf16 half-ulp more; zero at inactive
    cells."""
    rs = np.random.RandomState(1 + masked)
    C = 8
    shape = (1, 3, 6, 5, 4 * C) if masked else (3, C, 5, 7)
    x = torch.from_numpy((rs.randn(*shape) * 2 + 0.5).astype(np.float32))
    x = x.to(dtype)
    g = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)
    bn = BatchNorm(C, eps=1e-3).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rs.rand(C).astype(np.float32) + .5))
        bn.bias.copy_(torch.from_numpy(rs.randn(C).astype(np.float32)))
    mcell = torch.from_numpy(rs.rand(*shape[:-1], 4) < 0.3) if masked \
        else None
    xr = x.float().clone().requires_grad_()
    w, b = (bn.weight.detach().clone().requires_grad_(),
            bn.bias.detach().clone().requires_grad_())
    if masked:
        ref = _bn_reference(xr.reshape(*shape[:-1], 4, C), w, b, bn.eps,
                            mcell).reshape(shape)
    else:
        ref = _bn_reference(xr, w, b, bn.eps)
    ref.backward(g.float())
    xg = x.detach().clone().requires_grad_()
    y = packed_bn_train(bn, xg, mcell) if masked else bn(xg)
    y.backward(g)
    assert y.dtype == dtype and xg.grad.dtype == dtype
    for got, want in ((bn.weight.grad, w.grad), (bn.bias.grad, b.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
    gx, want = xg.grad.float(), xr.grad
    tol = 1e-5 * float(want.abs().max())
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * want.abs()
    assert bool(((gx - want).abs() <= tol).all())
    if masked:
        inactive = ~mcell[..., None].expand(*shape[:-1], 4, C).reshape(shape)
        assert bool((gx[inactive] == 0).all())
        assert bool((gx[~inactive] != 0).any())


# ---------------------------------------------------------------------------
# fp32 wiring, every config
# ---------------------------------------------------------------------------

def _own(o, part, key):
    """JAX's own change of one quantity (part 0: a raw loss term, 1: an
    output, 2: a gradient or statistic by the port's name) under the 1e-5
    weight perturbation: the larger of the two, elementwise max."""
    ref = _np(o["jax32"][part][key])
    return max(float(np.abs(_np(n[part][key]) - ref).max())
               for n in o["noise"])


@pytest.mark.parametrize("name", NAMES)
def test_raw_loss_terms_match_jax(steps, name):
    o = steps[name]
    raw, jraw = o["wiring"][0], o["jax32"][0]
    assert set(raw) == set(jraw) == LOSSES[name]
    for k in jraw:
        got, ref = _np(raw[k]), _np(jraw[k])
        assert np.isfinite(got) and float(got) > 0, k
        # JAX's own change under the perturbation: a reading, not a bound
        assert abs(got - ref) <= 1e-4 * abs(ref), \
            (k, got, ref, _own(o, 0, k))


@pytest.mark.parametrize("name,key", [(n, k) for n in NAMES
                                      for k in OUTPUTS[n]])
def test_outputs_match_jax(steps, name, key):
    o = steps[name]
    ref = _np(o["jax32"][1][key])
    got = _np(o["wiring"][1][key])
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(got - ref).max()
    assert err <= 1e-3 * scale, (key, err, scale, _own(o, 1, key))


def test_lidar_renders_depth_only(steps):
    """coocc_lidar renders depth on its stride-16 frustum of the batch's
    poses (input 64x192 -> 4x12 rays a camera, upsampled x16), no rgb;
    voxel_feats is pts_voxel (no fuser), geom stays unset, as in JAX."""
    _, outs, _, _ = steps["lidar"]["wiring"]
    cfg = steps["lidar"]["cfg"]
    H, W = cfg.data.input_size
    assert outs["render_depth"].shape == (1, 2, H, W)
    assert "render_rgb" not in outs and outs["geom"] is None
    assert outs["depth_prob"] is None


@pytest.mark.parametrize("name", ["openocc", "cam"])
def test_refines_the_cells_jax_refines(steps, name):
    _, outs, _, _ = steps[name]["wiring"]
    jouts = steps[name]["jax32"][1]
    np.testing.assert_array_equal(outs["fine_coords"].numpy(),
                                  np.asarray(jouts["fine_coords"]))
    np.testing.assert_array_equal(outs["fine_valid"].numpy(),
                                  np.asarray(jouts["fine_valid"]))
    r = steps[name]["cfg"].occ_head.cascade_ratio
    assert outs["fine_coords"].shape[1] == 256 * r ** 3
    assert int(outs["fine_valid"].sum()) > 0


@pytest.mark.parametrize("name", NAMES)
def test_moved_bn_statistics_match_jax(steps, name):
    o = steps[name]
    stats, ref = o["wiring"][3], o["jax32"][2]
    assert len(stats) > 40
    for k, v in stats.items():
        r = ref[k].numpy()
        err = np.abs(v.numpy() - r).max()
        assert err <= 1e-3 * np.abs(r).max(), \
            (k, err, np.abs(r).max(), _own(o, 2, k))
        # and they moved: the step took batch statistics
        assert not np.array_equal(v.numpy(), o["sd"][k].numpy()), k
    if name == "lidar":
        for part in ("pts_middle_encoder.conv_input",
                     "pts_middle_encoder.encoder_layers",
                     "pts_middle_encoder.conv_out", "pts_backbone",
                     "pts_neck"):
            assert any(k.startswith(part) for k in stats), part


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax_within_its_own_conditioning(steps, name):
    o = steps[name]
    grads, ref = o["wiring"][2], o["jax32"][2]
    errs = _leaf_errors(grads, ref)
    noise = {k: _own(o, 2, k) for k in errs}
    bad = [(k, e / max(s, 1e-30), noise[k] / max(s, 1e-30))
           for k, (e, s) in errs.items()
           if e > max(10 * noise[k], 0.1 * s)]
    assert not bad, bad
    live = [k for k, (_, s) in errs.items() if s > 0]
    # a leaf JAX gives no gradient (a BatchNorm over one cell passes none
    # back) gets none from the port either
    assert all(float(grads[k].abs().max()) == 0 for k in errs
               if k not in live)
    assert len(live) > 0.8 * len(errs)
    rel = np.array([errs[k][0] / errs[k][1] for k in live])
    own = np.array([noise[k] / errs[k][1] for k in live])
    # the flagship test's bounds; JAX's own change is a reading
    assert np.median(rel) <= 0.06, (np.median(rel), np.median(own))
    assert np.quantile(rel, 0.9) <= 0.2, \
        (np.quantile(rel, 0.9), np.quantile(own, 0.9))
    if name == "lidar":
        assert any(k.startswith("pts_middle_encoder.encoder_layers")
                   and float(g.abs().max()) > 0 for k, g in grads.items())


# ---------------------------------------------------------------------------
# coocc_lidar: the packed route and bf16
# ---------------------------------------------------------------------------

def _stacked(name, raws):
    ks = sorted(LOSSES[name])
    return [np.array([_np(r[k]) for k in ks]) for r in raws]


@pytest.mark.parametrize("route,key", [
    ("packed", k) for k in OUTPUTS["lidar"] + ("losses",)] + [
    ("bf16", k) for k in OUTPUTS["lidar"]])
def test_lidar_step_within_jax_own_drift(steps, route, key):
    """The packed route (K2's bf16 operands, fp32 elsewhere) against JAX's
    fp32 step, and the bf16 step against JAX's bf16 step: within 2x (max)
    and 1.5x (mean) of JAX's own bf16-vs-fp32 drift."""
    o = steps["lidar"]
    raw, outs, _, _ = o[route]
    (jraw16, jouts16), (jraw32, jouts32) = o["jax16"][:2], o["jax32"][:2]
    if key == "losses":
        port, j16, j32 = _stacked("lidar", (raw, jraw16, jraw32))
    else:
        port, j16, j32 = outs[key], jouts16[key], jouts32[key]
        if route == "bf16":
            assert str(port.dtype)[6:] == j16.dtype.name, key
        port, j16, j32 = _np(port), _np(j16), _np(j32)
    ref = j32 if route == "packed" else j16
    err, own = np.abs(port - ref), np.abs(j16 - j32)
    assert own.max() > 0
    assert err.max() <= 2.0 * own.max(), (key, err.max(), own.max())
    assert err.mean() <= 1.5 * own.mean(), (key, err.mean(), own.mean())


def test_lidar_bf16_losses_are_jax_losses_of_its_outputs(steps):
    """The bf16 step's raw loss terms are JAX's losses of the port's own
    bf16 outputs, to a bf16 ulp of each; the outputs are held by the drift
    rule above. (A loss term is one bf16 scalar of a sum over the coarse
    grid: two bf16 forwards that each lie within JAX's drift give terms
    apart by a few ulps, 3 measured in loss_voxel_sem_scal_c_0 against
    JAX's own 0.1 ulp between its bf16 and fp32 steps, so a scalar drift
    rule would hold noise.)"""
    o = steps["lidar"]
    raw, ref = o["bf16"][0], o["bf16_jax_losses"]
    assert set(ref) == set(raw) == LOSSES["lidar"]
    for k in ref:
        got, want = float(_np(raw[k])), float(_np(ref[k]))
        assert abs(got - want) <= 2.0 ** -7 * abs(want), (k, got, want)


# ---------------------------------------------------------------------------
# the train CLI on coocc_lidar's tiny twin
# ---------------------------------------------------------------------------

def test_lidar_train_cli_trains_and_resumes(monkeypatch):
    """`python -m coocc_tpu_torch.train coocc_lidar --synthetic --device
    cpu` on the config's tiny twin: one epoch of 2 steps with its eval
    hook, then a resume for a second epoch. The first checkpoint holds the
    HD encoder's and SECOND3D's moved statistics, and the resumed epoch
    starts from them and moves them again."""
    cfg = lidar_configs()[1]
    monkeypatch.setattr(train_cli, "config_by_name",
                        lambda name: cfg if name == "coocc_lidar" else None)
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard",
                        None)
    keys = ("pts_middle_encoder.encoder_layers.encoder_layer1.0.norm1."
            "running_var", "pts_backbone.blocks.0.1.running_mean",
            "pts_middle_encoder.conv_out.1.running_mean")
    with tempfile.TemporaryDirectory() as d:
        wd = os.path.join(d, "lidar")
        args = ["coocc_lidar", "--synthetic", "--device", "cpu",
                "--steps-per-epoch", "2"]
        with contextlib.redirect_stdout(io.StringIO()):
            train_cli.main(args + ["--max-epochs", "1", "--work-dir", wd])
        first, epoch = CheckpointManager(wd).restore()
        assert epoch == 0
        init = build_model(cfg, "cpu", seed=0).state_dict()
        for k in keys:
            assert not torch.equal(first["model"][k], init[k]), k
        first = {k: first["model"][k].clone() for k in keys}
        with contextlib.redirect_stdout(io.StringIO()):
            train_cli.main(args + ["--max-epochs", "2", "--resume-from",
                                   wd])
        second, epoch = CheckpointManager(wd).restore()
        assert epoch == 1
        for k in keys:
            v = second["model"][k]
            assert torch.isfinite(v).all() and not torch.equal(v, first[k])
