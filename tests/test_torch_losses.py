"""The port's losses, renderer and optimizer == the JAX package's.

On seeded random inputs (tiny shapes), value and gradient:
  * each loss of losses/ (CE, sem_scal, geo_scal, lovasz, the depth BCE and
    KL, the ground truth's mode pooling), in fp32 to 1e-5 and in bf16 to the
    roundings of the ops JAX rounds, and models/losses.py:compute_losses
    with its loss / stop_grad(loss) normalization, its fine-cell gather and
    the render losses added after it;
  * the renderer's `composite`, `gather_frustum` (with lookups past the
    voxel table, which JAX's gather clamps and its transpose drops) and the
    whole renderer with its heads, gradients of the heads and of the voxel
    features included;
  * the nuScenes class weights equal to coocc_tpu/config/nuscenes.py's;
  * the optimizer (train/state.py: clip by global norm 5, AdamW, decay on
    ndim >= 2 only, step LR) against optax (JAX train/state.py's
    make_optimizer) on a toy tree over 3 steps, the clip binding on one of
    them and a schedule boundary crossed, to 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.config.base import OptimConfig as JaxOptimConfig
from coocc_tpu.config.nuscenes import class_weights as jax_class_weights
from coocc_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from coocc_tpu.data.synthetic import tiny_config as jax_tiny_config
from coocc_tpu.losses import depth as jdepth
from coocc_tpu.losses import gt_pool as jpool
from coocc_tpu.losses import lovasz as jlovasz
from coocc_tpu.losses import ssc as jssc
from coocc_tpu.models import renderer as jrenderer
from coocc_tpu.models.losses import compute_losses as jax_compute_losses
from coocc_tpu.train.convert_torch import ParamTreeBuilder, convert_nerf_mlp
from coocc_tpu.train.state import make_optimizer as jax_make_optimizer

from coocc_tpu_torch.config import OptimConfig
from coocc_tpu_torch.config.nuscenes import class_weights
from coocc_tpu_torch.data.synthetic import synthetic_batch, tiny_config
from coocc_tpu_torch.entry import init_weights
from coocc_tpu_torch.losses import depth, gt_pool, lovasz, ssc
from coocc_tpu_torch.models import renderer
from coocc_tpu_torch.models.losses import compute_losses
from coocc_tpu_torch.nn.layers import softmax
from coocc_tpu_torch.nn.nerf_mlp import NeRFMLP
from coocc_tpu_torch.train.state import Optimizer
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

RS = np.random.RandomState(0)
LOGITS = RS.randn(2, 6, 5, 4, 17).astype(np.float32) * 2
# a block of identical cells, as empty space gives: exact ties in lovasz
LOGITS[:, :2] = LOGITS[:, :1, :1]
TARGET = RS.randint(0, 17, (2, 6, 5, 4)).astype(np.int32)
TARGET[RS.rand(*TARGET.shape) < 0.1] = 255


def _both(jfn, tfn, arrays, dtype="float32"):
    """(value, grads) of jfn on jnp arrays and of tfn on torch tensors; the
    first array (floating) is differentiated, in `dtype`."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    first = arrays[0]
    jv, jg = jax.value_and_grad(lambda a: jfn(a.astype(jd), *[
        jnp.asarray(x) for x in arrays[1:]]).astype(jnp.float32))(
        jnp.asarray(first))
    t = torch.from_numpy(first).requires_grad_()
    tv = tfn(t.to(td), *[torch.from_numpy(x) for x in arrays[1:]])
    tv.float().backward()
    return (float(jv), np.asarray(jg)), (float(tv.detach()), t.grad.numpy())


SSC = [("ce", lambda l, t: jssc.ce_ssc_loss(l, t, jax_class_weights(17)),
        lambda l, t: ssc.ce_ssc_loss(l, t, class_weights(17))),
       ("ce_unweighted", jssc.ce_ssc_loss, ssc.ce_ssc_loss),
       ("sem_scal", jssc.sem_scal_loss, ssc.sem_scal_loss),
       ("geo_scal", jssc.geo_scal_loss, ssc.geo_scal_loss),
       ("lovasz", lambda l, t: jlovasz.lovasz_softmax(
           jax.nn.softmax(l, -1), t),
        lambda l, t: lovasz.lovasz_softmax(softmax(l, -1), t))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,jfn,tfn", SSC)
def test_ssc_loss_matches_jax(name, jfn, tfn, dtype):
    """fp32 to 1e-5. bf16: both round each op to bf16 and sum in fp32, in
    other orders; the value within 2^-6 of it, the gradient within 2^-6 of
    its scale."""
    (jv, jg), (tv, tg) = _both(jfn, tfn, [LOGITS, TARGET], dtype)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    assert tv == pytest.approx(jv, rel=tol, abs=tol), name
    np.testing.assert_allclose(tg, jg, rtol=0,
                               atol=tol * np.abs(jg).max(), err_msg=name)


def test_mode_pool_matches_jax():
    gt = RS.randint(0, 17, (2, 8, 6, 4)).astype(np.int32)
    gt[RS.rand(*gt.shape) < 0.3] = 0
    gt[RS.rand(*gt.shape) < 0.05] = 255
    gt[:, :2, :2, :2] = 0     # an all-empty block stays 0
    ref = np.asarray(jpool.mode_pool_gt(jnp.asarray(gt), 2, 17))
    got = gt_pool.mode_pool_gt(torch.from_numpy(gt), 2, 17).numpy()
    np.testing.assert_array_equal(got, ref)
    assert {0, 255} <= set(np.unique(ref).tolist())


@pytest.mark.parametrize("kind", ["bce", "kld"])
def test_depth_loss_matches_jax(kind):
    prob = RS.rand(1, 2, 4, 12, 16).astype(np.float32) + 0.05
    prob /= prob.sum(-1, keepdims=True)
    # sparse depths, as projected LiDAR gives: each 16x16 patch's minimum
    # lands in a different bin, some past the range, some patches empty
    gt = RS.uniform(1.0, 10.5, (1, 2, 64, 192)).astype(np.float32)
    gt[RS.rand(*gt.shape) < 0.99] = 0.0
    dbound = (1.0, 9.0, 0.5)
    jfn = {"bce": jdepth.bce_depth_loss, "kld": jdepth.kld_depth_loss}[kind]
    tfn = {"bce": depth.bce_depth_loss, "kld": depth.kld_depth_loss}[kind]
    (jv, jg), (tv, tg) = _both(lambda p, g: jfn(p, g, 16, dbound),
                               lambda p, g: tfn(p, g, 16, dbound),
                               [prob, gt])
    assert tv == pytest.approx(jv, rel=1e-5) and jv > 0
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-5 * np.abs(jg).max())


def test_class_weights_match_jax():
    """nuScenes' 17 classes and SemanticKITTI's 20."""
    np.testing.assert_array_equal(class_weights(17), jax_class_weights(17))
    np.testing.assert_array_equal(class_weights(20), jax_class_weights(20))


@pytest.mark.parametrize("loss_norm", [True, False])
def test_compute_losses_matches_jax(loss_norm):
    """Every term and the gradient of their sum w.r.t. each input, on the
    tiny batch's ground truth; invalid fine slots are ignored."""
    cfg = dataclasses.replace(tiny_config(), loss_norm=loss_norm)
    jcfg = dataclasses.replace(jax_tiny_config(), loss_norm=loss_norm)
    jb = jax.tree.map(lambda x: None if x is None else jnp.asarray(x),
                      jax_synthetic_batch(jcfg, batch_size=1, seed=3),
                      is_leaf=lambda x: x is None)
    tb = synthetic_batch(cfg, batch_size=1, seed=3).to("cpu")
    rs = np.random.RandomState(1)
    fc = rs.randint(0, 40, (1, 2048, 3)).astype(np.int32)
    fc[..., 2] %= 8
    fv = rs.rand(1, 2048) < 0.8
    prob = rs.rand(1, 2, 4, 12, 16).astype(np.float32) + 0.05
    ins = {"occ": rs.randn(1, 20, 20, 4, 17).astype(np.float32),
           "fine_logits": rs.randn(1, 2048, 17).astype(np.float32),
           "depth_prob": prob / prob.sum(-1, keepdims=True),
           "render_depth": rs.rand(1, 2, 64, 192).astype(np.float32) * 16,
           "render_rgb": rs.rand(1, 2, 64, 192, 3).astype(np.float32)}
    fixed = {"fine_coords": fc, "fine_valid": fv}
    keys = list(ins)

    def jl(*vals):
        L = jax_compute_losses({**dict(zip(keys, vals)), **{
            k: jnp.asarray(v) for k, v in fixed.items()}}, jb, jcfg)
        return sum(v for k, v in L.items() if k.startswith("loss")), L
    (jv, jL), jg = jax.jit(jax.value_and_grad(
        jl, argnums=tuple(range(len(keys))), has_aux=True))(
            *(jnp.asarray(ins[k]) for k in keys))
    ts = {k: torch.from_numpy(v).requires_grad_() for k, v in ins.items()}
    L = compute_losses({**ts, **{k: torch.from_numpy(v)
                                 for k, v in fixed.items()}}, tb, cfg)
    assert set(L) == set(jL) and len(L) == 11
    for k in L:
        assert float(L[k].detach()) == pytest.approx(float(jL[k]),
                                                     rel=1e-5), k
    sum(v for k, v in L.items() if k.startswith("loss")).backward()
    for k, g in zip(keys, jg):
        g = np.asarray(g)
        np.testing.assert_allclose(ts[k].grad.numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max(), err_msg=k)


def test_composite_matches_jax():
    rs = np.random.RandomState(2)
    rgb = rs.rand(3, 5, 16, 3).astype(np.float32)
    sigma = (rs.rand(3, 5, 16) * 2).astype(np.float32)
    pts = rs.randint(0, 20, (3, 5, 16, 3)).astype(np.float32)
    jr, jd = jrenderer.composite(*(jnp.asarray(a) for a in (rgb, sigma,
                                                             pts)))
    tr, td = renderer.composite(*(torch.from_numpy(a) for a in (rgb, sigma,
                                                                pts)))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)


def _render_case():
    rs = np.random.RandomState(3)
    cfg = jax_tiny_config().render        # render grid 40x40x8 at 0.5
    vf = rs.randn(1, 20, 20, 4, 64).astype(np.float32)  # a 20x20x4 table
    geom = (rs.rand(1, 2, 16, 4, 12, 3) * [24, 24, 5]
            - [12, 12, 2.5]).astype(np.float32)
    return cfg, vf, geom


def test_gather_frustum_matches_jax():
    cfg, vf, geom = _render_case()
    dx, bx, nx = renderer.render_grid(tiny_config().render)
    jf, jm, jp = jrenderer._gather_frustum(
        jnp.asarray(vf[0]), jnp.asarray(geom[0]), jnp.asarray(dx),
        jnp.asarray(bx), np.asarray(nx))
    tf, tm, tp = renderer.gather_frustum(torch.from_numpy(vf[0]),
                                         torch.from_numpy(geom[0]), dx, bx,
                                         nx)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    lid = (tp[..., 0] * 20 + tp[..., 1]) * 4 + tp[..., 2]
    assert bool((lid >= 20 * 20 * 4).any()), "no lookup past the table"


def test_renderer_matches_jax_with_gradients():
    """The whole renderer (heads, lookup, compositing, x16 upsampling) on
    random features: values, and the gradients of an MSE against random
    targets w.r.t. the heads and the voxel features (the lookups past the
    table pass none back, as JAX's gather transpose drops them)."""
    cfg, vf, geom = _render_case()
    sig, rgbh = NeRFMLP(64, 1, 1), NeRFMLP(64, 3, 3)
    init_weights(sig, 1)
    init_weights(rgbh, 2)
    sd = {f"sigma_head.{k}": v.numpy() for k, v in sig.state_dict().items()}
    sd.update({f"rgb_head.{k}": v.numpy()
               for k, v in rgbh.state_dict().items()})
    b = ParamTreeBuilder()
    convert_nerf_mlp(b, sd, "sigma_head", "sigma_head", 1)
    convert_nerf_mlp(b, sd, "rgb_head", "rgb_head", 3)
    rs = np.random.RandomState(4)
    tgt = rs.rand(1, 2, 64, 192, 3).astype(np.float32)
    tgd = rs.rand(1, 2, 64, 192).astype(np.float32) * 10

    def jl(params, v):
        r, d = jrenderer.FrustumRenderer(cfg, scale=16).apply(
            {"params": params}, v, jnp.asarray(geom))
        return jnp.mean((r - tgt) ** 2) + jnp.mean((d - tgd) ** 2)
    jv, (jg, jgv) = jax.jit(jax.value_and_grad(jl, argnums=(0, 1)))(
        b.params, jnp.asarray(vf))
    tv = torch.from_numpy(vf).requires_grad_()
    r, d = renderer.render(sig, rgbh, tiny_config().render, tv,
                           torch.from_numpy(geom))
    assert r.shape == (1, 2, 64, 192, 3) and d.shape == (1, 2, 64, 192)
    loss = ((r - torch.from_numpy(tgt)) ** 2).mean() \
        + ((d - torch.from_numpy(tgd)) ** 2).mean()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jv), rel=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jgv), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jgv)).max())
    names = {"hidden_layers.0": "hidden0", "hidden_layers.1": "hidden1",
             "hidden_layers.2": "hidden2", "output_layer": "output"}
    for head, m in (("sigma_head", sig), ("rgb_head", rgbh)):
        for k, p in m.named_parameters():
            layer, attr = k.rsplit(".", 1)
            ref = np.asarray(jg[head][names[layer]][
                "kernel" if attr == "weight" else "bias"])
            ref = ref.T if attr == "weight" else ref
            np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg=f"{head}.{k}")


def test_optimizer_matches_optax_over_three_steps():
    """Three updates of a toy tree (a matrix, a vector, a conv kernel) from
    the same gradients: the clip binds on step 1 only (global norms 1.2,
    40, 0.7 against 5), the schedule's boundary (epoch 1 of 2 steps) falls
    before step 2, and only the ndim >= 2 leaves decay."""
    rs = np.random.RandomState(5)
    shapes = {"w": (4, 3), "b": (3,), "k": (2, 3, 3, 3)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    steps = []
    for norm in (1.2, 40.0, 0.7):
        g = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
        total = np.sqrt(sum((v ** 2).sum() for v in g.values()))
        steps.append({k: v * norm / total for k, v in g.items()})
    kw = dict(lr_step_epochs=(1,), lr_step_gamma=0.1, weight_decay=0.05)
    tx, _ = jax_make_optimizer(JaxOptimConfig(**kw), 2,
                               {k: jnp.asarray(v) for k, v in
                                params.items()})
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = Optimizer(tp.items(), OptimConfig(**kw), 2)
    norms = []
    for g in steps:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        opt.zero_grad()
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norms.append(float(opt.step()))
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6,
                                       err_msg=k)
    assert norms == pytest.approx([1.2, 40.0, 0.7], rel=1e-5)
    assert opt.adamw.param_groups[0]["lr"] == pytest.approx(1e-5)
