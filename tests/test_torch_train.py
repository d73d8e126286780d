"""One train step of the port == JAX's `loss_fn` / `value_and_grad` (tiny).

One set of weights: the port's tiny model is seeded (entry.build_model), its
state_dict goes through the JAX package's convert_coocc_ray, and both sides
take one training step on synthetic_batch(tiny_config, seed=3), as
coocc_tpu/parallel/train_step.py:27-55 computes it: the forward with
train=True (BatchNorm on batch statistics, which it moves), the losses of
models/losses.py, and the gradient of their sum. JAX's gradients and moved
statistics come back through the port's state_dict_from_jax, so every leaf
is compared under the port's name.

Lined up: dropout is off on both sides (flax's Dropout.__call__ patched to
the identity for the JAX run, nothing in coocc_tpu changes; the port's
Dropout at p = 0; its draw and 1/(1-p) scale have a test below); the
training cascade's priorities are JAX's own draw,
uniform(fold_in(fold_in(rng, 2), 0)), passed to the port. One JAX compile
per dtype (a module-scoped fixture); the bf16 one runs in a thread beside
the fp32 one and the port's steps.

What is held, and how tight:
  * fp32 wiring: the port with K2 swapped for an fp32 conv at the encoder's
    `subm_conv` seam (JAX's fp32 XLA route does not round the SubM
    operands to bf16; K2 does): the raw loss terms (before loss_norm, which
    makes every voxel and depth term read 1.0) to rtol 1e-4, the outputs
    the losses read to 1e-3 of their scale (measured 1.4e-4 at most), the
    moved BN statistics to 1e-3 of their scale (measured 4.4e-5), the same
    refined cells. The gradients are ill-conditioned at these shapes (BN on
    batch statistics over 2 pooled camera maps in ASPP and 9 cells at the
    deepest semantic level; ReLU patterns): JAX's own gradient moves by 7%
    of a leaf's scale at the median (up to 120%) when its weights are
    perturbed by 1e-5 relative, which moves its own occ by 1e-3 of its
    scale. The yardstick per leaf is that change (the larger of two
    perturbations). Each leaf: |port - jax| within 10x the yardstick or 10%
    of its scale; over all leaves the median of |port - jax| / scale within
    6% (measured 2.6%) and the 90th percentile within 20%.
  * the full packed route (K2's bf16 operands, its dX kernel's plain
    version and its dW): bf16 rounding in nine SubM layers compounds, as in
    eval (tests/test_torch_packed_encoder.py); the raw loss terms and the
    outputs are held within JAX's own bf16-vs-fp32 drift.
  * bf16: the port's bf16 step against JAX's bf16 step (compiled with
    xla_allow_excess_precision off), within 2x (max) and 1.5x (mean) of
    JAX's own bf16-vs-fp32 drift, per output and per loss term; per
    gradient leaf within 1.5x (mean) and 2.5x (max) of it. These steps
    and the packed route's run the twin with 128 x 384 images (IMAGE) and
    the same weights, against JAX's fp32 step of that twin. JAX's own bf16
    gradients move by up to twice a leaf's scale; the port's max ratio is
    0.95 at the median leaf, 1.57 at the 99th percentile and 1.80 at the
    worst (fine_mlp.0.weight), its mean ratio at most 1.29.
  * AdamW with the clip: the port's optimizer (train/state.py) on JAX's
    gradients against optax's update of the same gradients (the JAX
    package's make_optimizer), to 1e-6 of each leaf.
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from coocc_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from coocc_tpu.data.synthetic import tiny_config as jax_tiny_config
from coocc_tpu.models.coocc_ray import CoOccRay as JaxCoOccRay
from coocc_tpu.models.losses import compute_losses as jax_compute_losses
from coocc_tpu.train.convert_torch import convert_coocc_ray
from coocc_tpu.train.state import make_optimizer as jax_make_optimizer

from coocc_tpu_torch.convert import state_dict_from_jax
from coocc_tpu_torch.data.synthetic import synthetic_batch, tiny_config
from coocc_tpu_torch.entry import build_model
from coocc_tpu_torch.models.losses import compute_losses
from coocc_tpu_torch.nn import sparse_enc_packed
from coocc_tpu_torch.nn.layers import Dropout
from coocc_tpu_torch.ops.subm_conv import subm_conv_unrounded
from coocc_tpu_torch.train.state import make_optimizer
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

SEED, BATCH_SEED = 7, 3
OUTPUTS = ("occ", "fine_logits", "depth_prob", "voxel_feats",
           "render_depth", "render_rgb")
# the twin's camera images: twice tiny_config's (64, 192) a side, a
# stride-16 map of 8 x 24 cells a camera. At 4 x 12 the image branch's
# gradients sum over 96 cells, and the bf16 step's img_mlp.0.weight read
# 0.86-1.97x (F.interpolate's resizes) and 1.26-2.51x (JAX's) of JAX's own
# max drift as torch's CPU threads went from 1 to 4, and both routes broke
# the 1.5x mean bound on one thread; at 8 x 24 every leaf of both stays
# within 2.03x (max) and 1.34x (mean) on 1-4 threads
IMAGE = (128, 384)


def _grown(cfg):
    """cfg with IMAGE as its input size (the data's and the head's)."""
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, input_size=IMAGE),
        occ_head=dataclasses.replace(cfg.occ_head, input_size=IMAGE))


def _raw(cfg):
    return dataclasses.replace(cfg, loss_norm=False)


def _np(t):
    t = t.detach() if isinstance(t, torch.Tensor) else t
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t).astype(np.float32)


def _jax_step(jcfg, variables, bf16, edit=None):
    """JAX's value_and_grad of its train loss (dropout off) -> (raw loss
    terms, outputs, port-named {grads | moved statistics}, grad fn): one
    compile, reused with perturbed weights through the returned fn.
    edit(batch) -> batch changes the synthetic batch, where given."""
    batch = jax_synthetic_batch(jcfg, batch_size=1, seed=BATCH_SEED)
    batch = jax.tree.map(lambda x: None if x is None else jnp.asarray(x),
                         edit(batch) if edit else batch,
                         is_leaf=lambda x: x is None)
    model = JaxCoOccRay(cfg=jcfg, dtype=jnp.bfloat16 if bf16 else None)
    rng = jax.random.PRNGKey(0)

    def loss_fn(params, stats):
        outs, mutated = model.apply(
            {"params": params, "batch_stats": stats}, batch, train=True,
            fine_rng=jax.random.fold_in(rng, 2),
            rngs={"dropout": jax.random.fold_in(rng, 1)},
            mutable=["batch_stats"])
        losses = jax_compute_losses(outs, batch, jcfg)
        total = sum(v for k, v in losses.items() if k.startswith("loss"))
        raw = jax_compute_losses(outs, batch, _raw(jcfg))
        keep = {k: outs[k] for k in OUTPUTS + ("fine_coords", "fine_valid")}
        return total, (raw, mutated["batch_stats"], keep)

    jit = functools.partial(
        jax.jit, compiler_options={"xla_allow_excess_precision": False}) \
        if bf16 else jax.jit
    fn = jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, (raw, stats, outs)), grads = fn(variables["params"],
                                        variables["batch_stats"])
    return raw, outs, grads, stats, fn


def _optax_update(jcfg, params, grads):
    """optax's update (the JAX package's make_optimizer, 1000 steps an
    epoch) of `params` by `grads` from a fresh state -> the new params."""
    tx, _ = jax_make_optimizer(jcfg.optim, 1000, params)

    @jax.jit
    def update(grads, params):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates)
    return jax.block_until_ready(update(grads, params))


def _to_port(tree, stats, cfg):
    return state_dict_from_jax(jax.tree.map(
        np.asarray, {"params": tree, "batch_stats": stats}), cfg)


def _port_step(cfg, sd, prio, dtype, swap_k2, edit=None):
    """The port's forward + losses + backward with dropout off -> (raw loss
    terms, outputs, {name: grad}, {name: moved statistic}); edit as
    _jax_step's."""
    model = build_model(cfg, "cpu", seed=SEED, dtype=dtype)
    model.load_state_dict(sd)
    model.train()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    batch = synthetic_batch(cfg, batch_size=1, seed=BATCH_SEED)
    batch = (edit(batch) if edit else batch).to("cpu")
    with pytest.MonkeyPatch.context() as mp:
        if swap_k2:
            mp.setattr(sparse_enc_packed, "subm_conv", subm_conv_unrounded)
        outs = model(batch, fine_priorities=prio)
        losses = compute_losses(outs, batch, cfg)
        raw = compute_losses(outs, batch, _raw(cfg))
        sum(v for k, v in losses.items() if k.startswith("loss")).backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    return raw, outs, grads, stats


@pytest.fixture(scope="module")
def step():
    cfg, jcfg = tiny_config(), jax_tiny_config()
    sd = build_model(cfg, "cpu", seed=SEED).state_dict()
    variables = convert_coocc_ray({k: v.numpy() for k, v in sd.items()},
                                  jcfg)
    # the bf16 comparisons' twin: the same weights, larger images
    gcfg, gjcfg = _grown(cfg), _grown(jcfg)
    n = int(np.prod(jcfg.lss_grid_size))
    prio = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 2), 0),
        (n,))))[None]
    out = {"cfg": cfg, "jcfg": jcfg, "sd": sd, "variables": variables}
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(3) as pool:
        # dropout off in JAX's trace
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        # JAX's steps of the grown twin trace and compile beside the fp32
        # one and the port's steps (XLA compiles without holding the
        # interpreter lock)
        jax16 = pool.submit(_jax_step, gjcfg, variables, True)
        jax32g = pool.submit(_jax_step, gjcfg, variables, False)
        raw, outs, grads, stats, fn = _jax_step(jcfg, variables, False)
        out["jax32"] = (raw, outs, _to_port(grads, stats, cfg), grads)
        optax_step = pool.submit(_optax_update, jcfg, variables["params"],
                                 grads)
        # the yardstick: JAX's own gradient with its weights perturbed by
        # 1e-5 relative (random signs), twice, through the compiled step
        noise = []
        rs = np.random.RandomState(0)
        for _ in range(2):
            pert = jax.tree.map(lambda p: p * (1 + 1e-5 * rs.choice(
                [-1, 1], size=np.shape(p)).astype(np.float32)),
                variables["params"])
            _, g = fn(pert, variables["batch_stats"])
            noise.append(_to_port(g, stats, cfg))
        out["noise"] = noise
        out["wiring"] = _port_step(cfg, sd, prio, None, True)
        out["packed"] = _port_step(gcfg, sd, prio, None, False)
        out["bf16"] = _port_step(gcfg, sd, prio, torch.bfloat16, False)
        for key, fut in (("jax16", jax16), ("jax32_grown", jax32g)):
            raw, outs, grads, stats, _ = fut.result()
            out[key] = (raw, outs, _to_port(grads, stats, cfg), grads)
        out["optax"] = optax_step.result()
    return out


def _leaf_errors(port_grads, ref):
    """{name: (max |port - ref|, max |ref|)} over the parameter leaves."""
    return {k: (float(np.abs(_np(g) - ref[k].numpy()).max()),
                float(np.abs(ref[k].numpy()).max()))
            for k, g in port_grads.items()}


def test_raw_loss_terms_match_jax(step):
    raw, _, _, _ = step["wiring"]
    jraw = step["jax32"][0]
    assert set(raw) == set(jraw)
    for k in jraw:
        np.testing.assert_allclose(_np(raw[k]), _np(jraw[k]), rtol=1e-4,
                                   err_msg=k)


def test_normalized_terms_read_one(step):
    """loss / stop_grad(loss): every voxel and depth term is 1.0, the
    render terms are added after the normalization (JAX losses.py:120-130);
    the total is the sum of both kinds."""
    cfg = step["cfg"]
    raw, outs, _, _ = step["wiring"]
    batch = synthetic_batch(cfg, batch_size=1, seed=BATCH_SEED).to("cpu")
    losses = {k: v.detach() for k, v in
              compute_losses(outs, batch, cfg).items()}
    for k, v in losses.items():
        if k in ("loss_depth_render", "loss_rgb"):
            assert float(v) == float(raw[k].detach()) and 0 < float(v), k
        else:
            assert float(v) == pytest.approx(1.0, abs=1e-6), k


@pytest.mark.parametrize("key", OUTPUTS)
def test_outputs_match_jax(step, key):
    _, outs, _, _ = step["wiring"]
    ref = _np(step["jax32"][1][key])
    got = _np(outs[key])
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got - ref).max() <= 1e-3 * scale, key


def test_refines_the_cells_jax_refines(step):
    _, outs, _, _ = step["wiring"]
    jouts = step["jax32"][1]
    np.testing.assert_array_equal(outs["fine_coords"].numpy(),
                                  np.asarray(jouts["fine_coords"]))
    np.testing.assert_array_equal(outs["fine_valid"].numpy(),
                                  np.asarray(jouts["fine_valid"]))
    assert 0 < int(outs["fine_valid"].sum()) == outs["fine_valid"].numel(), \
        "the tiny config's fine_topk (256) is below the occupied cells"


def test_moved_bn_statistics_match_jax(step):
    _, _, _, stats = step["wiring"]
    ref = step["jax32"][2]
    assert len(stats) > 100
    for k, v in stats.items():
        r = ref[k].numpy()
        assert np.abs(v.numpy() - r).max() <= 1e-3 * np.abs(r).max(), k
        # and they moved: the step took batch statistics
        assert not np.array_equal(v.numpy(), step["sd"][k].numpy()), k


def test_gradients_match_jax_within_its_own_conditioning(step):
    _, _, grads, _ = step["wiring"]
    ref = step["jax32"][2]
    errs = _leaf_errors(grads, ref)
    noise = {k: max(float(np.abs(n[k].numpy() - ref[k].numpy()).max())
                    for n in step["noise"]) for k in errs}
    bad = [(k, e / max(s, 1e-30), noise[k] / max(s, 1e-30))
           for k, (e, s) in errs.items()
           if e > max(10 * noise[k], 0.1 * s)]
    assert not bad, bad
    rel = np.array([e / s for e, s in errs.values() if s > 0])
    assert len(rel) > 250
    assert np.median(rel) <= 0.06, np.median(rel)
    assert np.quantile(rel, 0.9) <= 0.2, np.quantile(rel, 0.9)


def _drift(port, jax16, jax32):
    """(max, mean) of |port - jax16| against those of |jax16 - jax32|."""
    p, j16, j32 = _np(port), _np(jax16), _np(jax32)
    return (np.abs(p - j16).max(), np.abs(p - j16).mean(),
            np.abs(j16 - j32).max(), np.abs(j16 - j32).mean())


@pytest.mark.parametrize("key", OUTPUTS + ("losses",))
def test_packed_route_within_jax_bf16_drift(step, key):
    """The full packed route (K2's bf16 operands) against JAX's fp32 step:
    within JAX's own bf16-vs-fp32 drift."""
    raw, outs, _, _ = step["packed"]
    jraw16, jouts16 = step["jax16"][0], step["jax16"][1]
    jraw32, jouts32 = step["jax32_grown"][0], step["jax32_grown"][1]
    if key == "losses":
        port = np.array([_np(raw[k]) for k in sorted(jraw32)])
        own = np.array([_np(jraw16[k]) for k in sorted(jraw32)])
        ref = np.array([_np(jraw32[k]) for k in sorted(jraw32)])
    else:
        port, own, ref = _np(outs[key]), _np(jouts16[key]), _np(jouts32[key])
    err, drift = np.abs(port - ref), np.abs(own - ref)
    assert err.max() <= drift.max(), (key, err.max(), drift.max())
    assert err.mean() <= drift.mean(), (key, err.mean(), drift.mean())


@pytest.mark.parametrize("key", OUTPUTS + ("losses",))
def test_bf16_step_within_jax_own_drift(step, key):
    raw, outs, _, _ = step["bf16"]
    (jraw16, jouts16), (jraw32, jouts32) = step["jax16"][:2], \
        step["jax32_grown"][:2]
    if key == "losses":
        ks = sorted(jraw32)
        pm, pa, om, oa = _drift(np.array([_np(raw[k]) for k in ks]),
                                np.array([_np(jraw16[k]) for k in ks]),
                                np.array([_np(jraw32[k]) for k in ks]))
    else:
        assert str(outs[key].dtype)[6:] == jouts16[key].dtype.name, key
        pm, pa, om, oa = _drift(outs[key], jouts16[key], jouts32[key])
    assert om > 0
    assert pm <= 2.0 * om, (key, pm, om)
    assert pa <= 1.5 * oa, (key, pa, oa)


def test_bf16_gradients_within_jax_own_drift(step):
    _, _, grads, _ = step["bf16"]
    g16, g32 = step["jax16"][2], step["jax32_grown"][2]
    bad = []
    for k, g in grads.items():
        p, j16, j32 = _np(g), g16[k].numpy(), g32[k].numpy()
        port, own = np.abs(p - j16), np.abs(j16 - j32)
        if not (port.max() <= max(2.5 * own.max(), 1e-30)
                and port.mean() <= max(1.5 * own.mean(), 1e-30)):
            bad.append((k, port.max() / own.max(), port.mean() / own.mean()))
    assert not bad, bad


def test_adamw_step_matches_optax_on_jax_gradients(step):
    """The port's optimizer (clip 5, AdamW, ndim >= 2 decay, step LR) on
    JAX's gradients == optax's update of them (JAX make_optimizer)."""
    cfg = step["cfg"]
    jgrads = step["jax32"][3]
    stats = step["variables"]["batch_stats"]
    ref = _to_port(step["optax"], stats, cfg)
    grads = _to_port(jgrads, stats, cfg)
    model = build_model(cfg, "cpu", seed=SEED)
    opt = make_optimizer(model, cfg.optim, 1000)
    for k, p in model.named_parameters():
        p.grad = grads[k].clone()
    norm = float(opt.step())
    assert norm > cfg.optim.grad_clip_norm, "the clip did not bind"
    moved = 0
    for k, p in model.named_parameters():
        r, before = ref[k].numpy(), step["sd"][k].numpy()
        np.testing.assert_allclose(p.detach().numpy(), r, rtol=0,
                                   atol=1e-6 * max(np.abs(r).max(), 1e-3),
                                   err_msg=k)
        # a leaf moves where optax moves it (a zero gradient on a leaf
        # without weight decay leaves it where it was, on both sides)
        assert np.array_equal(p.detach().numpy(), before) \
            == np.array_equal(r, before), k
        moved += not np.array_equal(r, before)
    assert moved > 0.95 * (len(ref) - len([k for k in ref
                                           if "running" in k]))


def test_dropout_draws_and_scales_like_flax():
    """The port's Dropout keeps 1 - p of the elements in expectation and
    scales them by 1 / (1 - p) in the input's dtype; it is the identity in
    eval and at p = 0 (flax.linen.Dropout's rule)."""
    x = torch.full((200, 300), 3.0, dtype=torch.bfloat16)
    d = Dropout(0.5).train()
    d.generator = torch.Generator().manual_seed(0)
    y = d(x)
    kept = y != 0
    assert y.dtype == torch.bfloat16
    assert torch.equal(y[kept], torch.full_like(y[kept], 6.0))
    assert abs(float(kept.float().mean()) - 0.5) < 0.01
    d.generator = torch.Generator().manual_seed(0)
    assert torch.equal(d(x), y), "the draw follows the generator"
    assert torch.equal(d.eval()(x), x)
    d.train().p = 0.0
    assert torch.equal(d(x), x)
