"""The port's ops/interpolate.py against the JAX package's
coocc_tpu/ops/interpolate.py (tiny shapes, CPU).

  * Forward, bit for bit, against JAX's resize_linear run op by op (each
    jnp op dispatched alone, so each rounds as its code says): integer
    ratios x2, x4, x16, a non-integer ratio (13 -> 25, the flagship FPN's),
    align_corners=True, one axis left as it is; in fp32 and in bf16 (an
    integer ratio keeps bf16, any other promotes to fp32 through the fp32
    lerp weights, as JAX's does), with JAX's bf16 also compiled with
    xla_allow_excess_precision off. The channels-first wrapper in JAX's
    z-batch axis order (resize_trilinear_zxy, the FPN's and occupancy
    head's) against JAX's resize_linear on the z-batch layout, and the
    renderer's x16 bilinear.
  * The gradient: autograd against jax.vjp within 1e-6 of its scale; the
    non-integer branch's gather sums its cotangents through gather_rows'
    fixed-order backward, never an index_add_; two backward passes equal.
  * A tiny train step with F.interpolate patched to raise: no model site
    calls it any more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from coocc_tpu.ops import interpolate as jip

from coocc_tpu_torch.ops import interpolate as tip
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

# (input [X, Y, Z, C] channels-last, output (X, Y, Z), align_corners)
CASES = [
    ((5, 4, 3, 6), (10, 8, 6), False),        # x2 on every axis
    ((5, 4, 2, 6), (20, 16, 8), False),       # x4
    ((2, 3, 1, 4), (32, 48, 16), False),      # x16
    ((13, 13, 1, 6), (25, 25, 2), False),     # non-integer, then x2
    ((3, 3, 1, 4), (20, 20, 4), False),       # 3 -> 20: non-integer
    ((4, 5, 3, 6), (7, 9, 5), True),          # align_corners
    ((4, 5, 3, 6), (8, 10, 3), True),
    ((6, 4, 2, 5), (6, 8, 4), False),         # X left as it is
]
IDS = [f"{s[:3]}->{o}{'-ac' if a else ''}" for s, o, a in CASES]


def _bits_equal(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype), (got.dtype,
                                                             ref.dtype)
    if got.dtype == torch.bfloat16:
        got, ref = got.float(), ref.astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), ref)


def _inputs(shape, bf16, seed=0):
    x = np.random.RandomState(seed).randn(1, *shape).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if bf16:
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    return xj, xt


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,out,ac", CASES, ids=IDS)
def test_forward_is_jax_bit_for_bit(shape, out, ac, bf16):
    xj, xt = _inputs(shape, bf16)
    got = tip.resize_trilinear_chlast(xt, out, ac)
    _bits_equal(got, jip.resize_trilinear_chlast(xj, out, ac))
    integer = not ac and all(o % i == 0 for i, o in zip(shape, out))
    assert got.dtype == (xt.dtype if integer else torch.float32)


@pytest.mark.parametrize("shape,out,ac", [c for c in CASES if not c[2]
                                          and all(o % i == 0 for i, o in
                                                  zip(c[0], c[1]))],
                         ids=[i for i, c in zip(IDS, CASES) if not c[2]
                              and all(o % i == 0 for i, o in
                                      zip(c[0], c[1]))])
def test_bf16_forward_equals_jax_compiled_without_excess_precision(
        shape, out, ac):
    """The integer-ratio blends stay bf16: JAX compiled with
    xla_allow_excess_precision off rounds each op as the port does."""
    xj, xt = _inputs(shape, True, seed=1)
    fn = jax.jit(lambda a: jip.resize_trilinear_chlast(a, out, ac)).lower(
        xj).compile({"xla_allow_excess_precision": False})
    _bits_equal(tip.resize_trilinear_chlast(xt, out, ac), fn(xj))


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,out", [((13, 13, 1, 6), (25, 25, 2)),
                                       ((3, 3, 1, 4), (20, 20, 4)),
                                       ((5, 5, 2, 4), (10, 10, 4))])
def test_channels_first_zxy_is_jax_z_batch_resize(shape, out, bf16):
    """resize_trilinear_zxy on [B, C, X, Y, Z] equals JAX's resize_linear
    on its z-batch layout [B, Z, X, Y, C] over axes (1, 2, 3)."""
    xj, xt = _inputs(shape, bf16, seed=2)
    ref = jip.resize_linear(jnp.transpose(xj, (0, 3, 1, 2, 4)),
                            (out[2], out[0], out[1]), (1, 2, 3))
    got = tip.resize_trilinear_zxy(xt.permute(0, 4, 1, 2, 3), out)
    _bits_equal(got.permute(0, 4, 2, 3, 1).contiguous(), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,axis,r", [((2, 3, 5, 4, 6), 2, 2),
                                          ((2, 3, 5, 4, 6), 3, 4),
                                          ((1, 2, 1, 4, 3), 2, 16),
                                          ((2, 3, 5, 4, 6), 4, 3)])
def test_eval_upsample_writes_the_training_bits(shape, axis, r, dtype):
    """Without a gradient the integer upsample writes its phases into the
    output (_upsample_int_axis_into): the same bits as the composed ops
    autograd runs through in training, -0.0 included."""
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(r)).to(
        dtype)
    x.view(-1)[0] = -0.0
    lean = tip._upsample_int_axis(x, axis, r)
    composed = tip._upsample_int_axis(x.clone().requires_grad_(True), axis,
                                      r).detach()
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(lean.view(ints), composed.view(ints))


def test_bilinear_x16_is_jax_renderer_upsample():
    x = np.random.RandomState(3).rand(1, 2, 4, 11, 3).astype(np.float32)
    got = tip.resize_bilinear_chlast(torch.from_numpy(x), (64, 176))
    _bits_equal(got, jip.resize_bilinear_chlast(jnp.asarray(x), (64, 176)))


@pytest.mark.parametrize("shape,out,ac", CASES, ids=IDS)
def test_gradient_matches_jax_vjp(shape, out, ac):
    x = np.random.RandomState(4).randn(1, *shape).astype(np.float32)
    g = np.random.RandomState(5).randn(1, *out, shape[-1]).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a: jip.resize_trilinear_chlast(a, out, ac),
                     jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    got, = torch.autograd.grad(tip.resize_trilinear_chlast(xt, out, ac), xt,
                               torch.from_numpy(g))
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * scale


def test_non_integer_gradient_sums_in_a_fixed_order(monkeypatch):
    """The non-integer branch's gather is gather_rows: its backward sums
    each source row's cotangents by sorted segment (ops/gather.py), never
    with an index_add_ (atomics on the card); its forward gathers as
    index_select does. Two backward passes give the same bits."""
    from coocc_tpu_torch.ops import gather
    calls = []
    backward = gather._GatherRows.backward

    def counted(ctx, g):
        calls.append(g.shape)
        return backward(ctx, g)

    def no_index_add(*a, **k):
        raise AssertionError("an index_add_ in the resize's backward")
    monkeypatch.setattr(gather._GatherRows, "backward",
                        staticmethod(counted))
    monkeypatch.setattr(torch.Tensor, "index_add_", no_index_add)
    monkeypatch.setattr(torch, "index_add", no_index_add)
    x = torch.randn(1, 6, 13, 13, 1, generator=torch.Generator()
                    .manual_seed(0), requires_grad=True)
    grads = []
    for _ in range(2):
        y = tip.resize_trilinear_zxy(x, (25, 25, 2))
        grads.append(torch.autograd.grad(y, x, torch.ones_like(y))[0])
    assert len(calls) == 8      # lo and hi rows of X and Y, twice
    assert torch.equal(grads[0], grads[1])
    ref = x.detach()
    for ax, n in ((2, 25), (3, 25)):
        lo, hi, w = tip._axis_weights(ref.shape[ax], n, False)
        shape = [1] * 5
        shape[ax] = n
        w = w.reshape(shape)
        ref = ref.index_select(ax, lo) * (1 - w) \
            + ref.index_select(ax, hi) * w
    ref = tip._upsample_int_axis(ref, 4, 2)
    assert torch.equal(tip.resize_trilinear_zxy(x, (25, 25, 2)).detach(),
                       ref)


def test_train_step_calls_no_f_interpolate(monkeypatch):
    """A tiny train step (the flagship's structure: the semantic FPN, the
    occupancy head's level blend, the renderer's x16 upsample) with
    F.interpolate patched to raise."""
    from coocc_tpu_torch.data.synthetic import synthetic_batch, tiny_config
    from coocc_tpu_torch.entry import Trainer

    def no_interpolate(*a, **k):
        raise AssertionError("F.interpolate on the model path")
    monkeypatch.setattr(F, "interpolate", no_interpolate)
    cfg = tiny_config()
    trainer = Trainer(cfg, "cpu", 0, steps_per_epoch=1)
    metrics = trainer.step(synthetic_batch(cfg, batch_size=1, seed=0).to(
        "cpu"))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert "loss_depth_render" in metrics
