"""The port's packed SubM conv (CPU: its plain version) == the JAX kernel's.

`subm_ext_conv` on a CPU tensor takes `subm_ext_conv_plain`: JAX's conv
(bf16-rounded operands, fp32 sums) followed by the epilogue the JAX encoder
applies around it. Both are held against the JAX Pallas kernel in
interpret mode, as tests/test_pallas_subm.py runs it, fed
`_subm_ext_weight(w27, p)`: the conv alone (an all-ones mask) and each
epilogue composed from JAX's own ops (`_PackedSubM`'s mask,
`_PackedBNCore`'s formula, ReLU, + identity, `_PackedBasicBlock`'s order),
at tests/test_pallas_subm.py's shapes plus a p=1, C=128 one and the HD
encoder's stage-0 packing p=8, C=16 (coocc_lidar), for fp32 and bf16
inputs. The kernel's weight panels hold exactly the nonzero blocks of
JAX's extended weight, and its K-blocks address the extended lanes that
JAX's `_shift_ext` builds. The block weights and layout helpers of
nn/sparse_enc_packed.py equal the JAX ones exactly on seeded weights. The
CUDA kernel runs only on the card: chip_smoke.py holds it against the same
plain version there.

K2's gradient (`subm_conv`, the training encoder's conv): on the CPU its
backward takes the plain versions of dX (K2 with the mirrored taps) and dW;
with operands and cotangent that hold bf16 values (so that K2's roundings
are exact) it equals torch.autograd of the plain fp32 ext conv; the
mirrored-tap conv is the conv's adjoint; and it matches jax.vjp of JAX's
XLA route of the same SubM layer (`_conv2d_pb(_shift_ext(x))` times the
mask, nn/sparse_enc_packed.py:431-433) in fp32 (bf16-valued inputs) and
bf16.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.nn import sparse_enc_packed as jpk
from coocc_tpu.ops.pallas.subm_conv import subm_ext_conv as jax_subm_ext_conv

from coocc_tpu_torch.nn import sparse_enc_packed as tpk
from coocc_tpu_torch.ops.subm_conv import (KB, ZERO_TAP, BNAffine,
                                           _panel_index, flip_taps,
                                           gather_taps_transpose, kblocks,
                                           shift_ext, subm_ext_table,
                                           tap_readers,
                                           subm_conv, subm_conv_unrounded,
                                           subm_ext_conv, subm_ext_conv_dx,
                                           subm_ext_conv_plain,
                                           subm_ext_weight, weight_panels)
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

SHAPES = [(1, 3, 12, 16, 32, 4), (2, 2, 9, 11, 64, 2),
          (1, 2, 10, 12, 128, 1), (1, 3, 10, 12, 16, 8)]
# fp32 in: both sum the same bf16 products in fp32, in other orders (outputs
# are O(1)-O(10) over K = 9*(pC+2C) <= 3456 terms). bf16 in: the bf16
# output may round the fp32 sum one ulp apart (JAX test's atol 2e-2).
TOL = {"float32": dict(rtol=1e-5, atol=1e-4),
       "bfloat16": dict(rtol=0, atol=2e-2)}
EPILOGUES = ["mask", "bn_relu", "bn_res_relu"]


@functools.lru_cache(maxsize=None)
def _case(B, bz, X, Y, C, p, dtype):
    """Seeded inputs and the interpret-mode Pallas conv of them (one JAX
    run per shape and dtype, shared by the tests below)."""
    rng = np.random.RandomState(0)
    x = rng.randn(B, bz, X, Y, p * C).astype(np.float32)
    w27 = (0.1 * rng.randn(27, C, C)).astype(np.float32)
    wext = np.array(jpk._subm_ext_weight(jnp.asarray(w27), p))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    conv = jax_subm_ext_conv(jx, jnp.asarray(wext), bz=bz, C=C,
                             interpret=True)
    mcell = rng.rand(B, bz, X, Y, p) < 0.6
    bn = (rng.randn(C).astype(np.float32),                        # mean
          rng.uniform(0.5, 1.5, C).astype(np.float32),            # inv
          rng.randn(C).astype(np.float32))                        # bias
    identity = rng.randn(B, bz, X, Y, p * C).astype(np.float32)
    return x, w27, conv, mcell, bn, identity


def _jax_epilogue(conv, mcell, bn, identity, epilogue, dtype, C):
    """JAX's own ops after `_PackedSubM`'s conv, in the encoder's order."""
    cd = getattr(jnp, dtype)
    mf = jnp.repeat(jnp.asarray(mcell), C, axis=-1).astype(cd)
    y = conv * mf                                         # _PackedSubM
    if epilogue == "mask":
        return y
    p = mcell.shape[-1]
    mean, inv, bias = (jnp.tile(jnp.asarray(v), p).astype(cd) for v in bn)
    y = ((y - mean) * inv + bias) * mf                    # _PackedBNCore
    if epilogue == "bn_relu":
        return jnp.maximum(y, 0)
    return jnp.maximum(y + jnp.asarray(identity).astype(cd), 0) * mf


def _port(x, w27, mcell, bn, identity, epilogue, dtype, p):
    td = getattr(torch, dtype)
    tbn = None if epilogue == "mask" else BNAffine(
        *(torch.from_numpy(v) for v in bn))
    tid = (torch.from_numpy(identity).to(td) if epilogue == "bn_res_relu"
           else None)
    return subm_ext_conv(torch.from_numpy(x).to(td), torch.from_numpy(w27),
                         p, torch.from_numpy(mcell), tbn, tid)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,bz,X,Y,C,p", SHAPES)
def test_subm_ext_conv_matches_jax_kernel(B, bz, X, Y, C, p, dtype):
    """The conv alone: an all-ones mask leaves the Pallas kernel's output."""
    x, w27, ref, mcell, _, _ = _case(B, bz, X, Y, C, p, dtype)
    got = _port(x, w27, np.ones_like(mcell), None, None, "mask", dtype, p)
    assert got.shape == tuple(ref.shape)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dtype])


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,bz,X,Y,C,p", SHAPES)
def test_fused_epilogue_matches_jax_composite(B, bz, X, Y, C, p, dtype,
                                              epilogue):
    """Conv + epilogue in one call == the Pallas conv then JAX's ops.

    fp32: the conv's tolerance above, scaled by max|inv| = 1.5, plus 1e-5
    of the scale for the four rounded epilogue ops. bf16: the JAX side
    rounds the conv, the BN vectors (`astype(x_pb.dtype)`) and every
    epilogue op to bf16, the port keeps them in fp32 and rounds once; each
    rounding is at most half a bf16 ulp, 2^-8 of the magnitude it rounds,
    so the bound is 2^-8 times the sum of the magnitudes rounded (conv,
    mean and conv - mean, each times inv; inv and the product, (conv -
    mean)*inv each; bias; the BN output; the sum with identity; the
    output), plus the fp32 conv tolerance."""
    x, w27, conv, mcell, bn, identity = _case(B, bz, X, Y, C, p, dtype)
    ref = np.asarray(_jax_epilogue(conv, mcell, bn, identity, epilogue,
                                   dtype, C), np.float32)
    got = _port(x, w27, mcell, bn, identity, epilogue, dtype,
                p).float().numpy()
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1.5e-4 + 1e-5 * scale)
        return
    c = np.asarray(conv, np.float32)
    mean, inv, bias = (np.tile(v, p) for v in bn)
    mags = np.abs(c) * (1 if epilogue == "mask" else inv)
    if epilogue != "mask":
        t = (c - mean) * inv
        mags = (mags + inv * (np.abs(mean) + np.abs(c - mean))
                + 2 * np.abs(t) + np.abs(bias) + np.abs(t + bias))
        if epilogue == "bn_res_relu":
            mags = mags + np.abs(t + bias + identity)
    bound = 2.0 ** -8 * (mags + np.abs(ref)) + 1.5 * TOL["float32"]["atol"]
    assert (np.abs(got - ref) <= bound).all(), np.abs(got - ref).max()


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_weight_panels_hold_exactly_the_nonzero_blocks(p):
    """The kernel multiplies only the panels: they hold JAX's extended
    weight at their (tap, lane, column) positions, and every position they
    skip is a structural zero of it."""
    C = 128 // p
    w27 = np.random.RandomState(p).randn(27, C, C).astype(np.float32)
    jw = np.asarray(jpk._subm_ext_weight(jnp.asarray(w27), p)).reshape(-1)
    idx = _panel_index(p, C, C)
    panels = weight_panels(torch.from_numpy(w27), p)
    assert panels.dtype == torch.bfloat16 and len(np.unique(idx)) == len(idx)
    np.testing.assert_array_equal(
        panels.float().numpy(),
        torch.from_numpy(jw[idx]).to(torch.bfloat16).float().numpy())
    skipped = np.ones(jw.size, bool)
    skipped[idx] = False
    assert not jw[skipped].any()
    # the structural zeros: of the (p+2)*p blocks, 3p-2 of the slots' and 2
    # of the carries' are nonzero, so (p-1)/(p+2) of the weight is skipped
    assert skipped.sum() * (p + 2) == jw.size * (p - 1)


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_kblocks_address_jax_extended_lanes(p):
    """K-block i is extended lanes 16i .. 16i+15 of JAX's _shift_ext: lanes
    `lane` .. `lane`+15 of the pack `dg` away, zero past a sample's ends."""
    C = 128 // p
    x = np.random.RandomState(p).randn(2, 3, 4, 5, p * C).astype(np.float32)
    ext = np.asarray(jpk._shift_ext(jnp.asarray(x), C))
    assert len(kblocks(p, C, C)) * KB == ext.shape[-1]
    for i, (lane, dg, _, _) in enumerate(kblocks(p, C, C)):
        want = np.zeros_like(x[..., :KB])
        src = x[..., lane:lane + KB]
        if dg == 0:
            want = src
        elif dg == 1:
            want[:, :-1] = src[:, 1:]
        else:
            want[:, 1:] = src[:, :-1]
        np.testing.assert_array_equal(ext[..., i * KB:(i + 1) * KB], want)


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_block_weights_match_jax(p):
    rng = np.random.RandomState(p)
    C, Z = 128 // p, 8
    w27 = rng.randn(27, C, 2 * C).astype(np.float32)
    tw, jw = torch.from_numpy(w27), jnp.asarray(w27)
    pairs = [
        (subm_ext_weight(tw, p), jpk._subm_ext_weight(jw, p)),
        (tpk.strided_weight(tw, Z), jpk._strided_weight(jw, Z)),
        (tpk.strided_packed_weight(tw, 2 * p, p),
         jpk._strided_packed_weight(jw, 2 * p, p)),
        (tpk.dilate_packed_weight(2 * p, p),
         jpk._dilate_packed_weight(2 * p, p, jnp.float32)),
        (tpk.dilate_weight(Z), jpk._dilate_weight(Z, jnp.float32)),
    ]
    for got, ref in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_tap_weight_is_the_converters_layout():
    """spconv [Cout, kz, ky, kx, Cin] -> [27, Cin, Cout] kx-major, as the
    JAX converter reads a reference checkpoint."""
    from coocc_tpu.train.convert_torch import spconv_w
    conv = tpk.SpConvWeight(4, 8)
    conv.weight.data.copy_(torch.from_numpy(
        np.random.RandomState(1).randn(8, 3, 3, 3, 4).astype(np.float32)))
    np.testing.assert_array_equal(tpk.tap_weight(conv).detach().numpy(),
                                  spconv_w(conv.weight.detach().numpy()))


@pytest.mark.parametrize("C,Z", [(32, 16), (64, 8), (128, 4), (32, 12)])
def test_layout_helpers_match_jax(C, Z):
    rng = np.random.RandomState(C + Z)
    B, X, Y = 2, 5, 6
    p = tpk.pick_pack(C, Z)
    assert p == jpk._pick_pack(C, Z)
    x_lm = rng.randn(B, X, Y, Z * C).astype(np.float32)
    mask = rng.rand(B, X, Y, Z) < 0.5
    x_pb = tpk.lm_to_pb(torch.from_numpy(x_lm), Z, C, p)
    np.testing.assert_array_equal(
        x_pb.numpy(), np.asarray(jpk._lm_to_pb(jnp.asarray(x_lm), Z, C, p)))
    np.testing.assert_array_equal(tpk.pb_to_lm(x_pb).numpy(), x_lm)
    np.testing.assert_array_equal(
        tpk.mask_pb(torch.from_numpy(mask), p).numpy(),
        np.asarray(jpk._mask_pb(jnp.asarray(mask), p)))
    np.testing.assert_array_equal(
        shift_ext(x_pb, C).numpy(),
        np.asarray(jpk._shift_ext(jnp.asarray(x_pb.numpy()), C)))


# ---------------------------------------------------------------------------
# K2's gradient
# ---------------------------------------------------------------------------

def _bf16_valued(a):
    return torch.from_numpy(a).to(torch.bfloat16).float()


@functools.lru_cache(maxsize=None)
def _grad_case(B, bz, X, Y, C, p):
    """Seeded x, w27, cotangent and mask, each holding bf16 values."""
    rng = np.random.RandomState(1)
    x = _bf16_valued(rng.randn(B, bz, X, Y, p * C).astype(np.float32))
    w27 = _bf16_valued((0.1 * rng.randn(27, C, C)).astype(np.float32))
    dy = _bf16_valued(rng.randn(B, bz, X, Y, p * C).astype(np.float32))
    mcell = torch.from_numpy(rng.rand(B, bz, X, Y, p) < 0.6)
    return x, w27, dy, mcell


def _port_grads(x, w27, dy, mcell, p, fn=subm_conv):
    x, w27 = x.clone().requires_grad_(), w27.clone().requires_grad_()
    fn(x, w27, p, mcell).backward(dy)
    return x.grad, w27.grad


@pytest.mark.parametrize("B,bz,X,Y,C,p", SHAPES)
def test_subm_conv_plain_backward_is_autograd_of_the_plain_conv(
        B, bz, X, Y, C, p):
    """On bf16-valued operands and cotangent K2's roundings are exact, so
    the Function's plain backward (dX through the mirrored-tap K2, dW from
    the extended weight's gradient) equals torch.autograd of the plain fp32
    ext conv to fp32 summation order. (Autograd through
    `subm_ext_conv_plain` itself would round dX to bf16 on its way back
    through the operand cast; K2's dX sums in fp32 and rounds only to dY's
    dtype.)"""
    x, w27, dy, mcell = _grad_case(B, bz, X, Y, C, p)
    y = subm_conv(x, w27, p, mcell)
    np.testing.assert_array_equal(
        y.numpy(), subm_ext_conv_plain(x, w27, p, mcell).numpy())
    dx, dw = _port_grads(x, w27, dy, mcell, p)
    rx, rw = _port_grads(x, w27, dy, mcell, p, subm_conv_unrounded)
    for got, ref in ((dx, rx), (dw, rw)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("B,bz,X,Y,C,p", SHAPES)
def test_dx_is_the_conv_with_the_mirrored_taps(B, bz, X, Y, C, p):
    """<dy, conv_w(x)> = <conv_flip(w)(dy), x> for the unmasked SubM conv,
    and subm_ext_conv_dx computes conv_flip(w) (fp32, bf16-valued)."""
    x, w27, dy, _ = _grad_case(B, bz, X, Y, C, p)
    ones = torch.ones_like(_grad_case(B, bz, X, Y, C, p)[3])
    y = subm_conv_unrounded(x, w27, p, ones)
    lhs = float((dy.double() * y.double()).sum())
    dx = subm_ext_conv_dx(dy, w27, p)
    np.testing.assert_allclose(
        dx.numpy(), subm_conv_unrounded(dy, flip_taps(w27), p, ones).numpy(),
        rtol=1e-5, atol=1e-5 * float(dx.abs().max()))
    rhs = float((dx.double() * x.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)
    assert flip_taps(w27).shape == (27, C, C)
    assert torch.equal(flip_taps(w27)[0], w27[26].T)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,bz,X,Y,C,p", SHAPES)
def test_subm_conv_backward_matches_jax_vjp(B, bz, X, Y, C, p, dtype):
    """dX and dW against jax.vjp of JAX's XLA SubM route. fp32 (inputs and
    cotangent hold bf16 values, so K2's roundings are exact): to fp32
    summation order. bf16: JAX rounds the extended dX and each extended
    weight element's sum to bf16 and adds the carries' dX in bf16, the port
    rounds dX once and dW per extended element (then sums in fp32): within
    2^-7 of each output's scale."""
    import jax
    x, w27, dy, mcell = _grad_case(B, bz, X, Y, C, p)
    jd = getattr(jnp, dtype)

    def layer(xj, wj):
        wext = jpk._subm_ext_weight(wj, p)
        y = jpk._conv2d_pb(jpk._shift_ext(xj, C), wext).astype(xj.dtype)
        mf = jnp.repeat(jnp.asarray(mcell.numpy()), C, axis=-1)
        return y * mf.astype(xj.dtype)

    _, vjp = jax.vjp(layer, jnp.asarray(x.numpy()).astype(jd),
                     jnp.asarray(w27.numpy()))
    jdx, jdw = vjp(jnp.asarray(dy.numpy()).astype(jd))
    td = getattr(torch, dtype)
    dx, dw = _port_grads(x.to(td), w27, dy.to(td), mcell, p)
    assert dx.dtype == td and dw.dtype == torch.float32
    for got, ref in ((dx, jdx), (dw, jdw)):
        ref = np.asarray(ref, np.float32)
        scale = np.abs(ref).max()
        tol = 1e-5 * scale if dtype == "float32" else 2.0 ** -7 * scale
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=tol)


def _index_add_taps(g, table, Ci, Co):
    """gather_taps_transpose as it was: an fp32 index_add_ of the blocks
    onto their taps (atomics on the card, so two calls could differ)."""
    n_in, n_out = table.shape
    blocks = g.float().reshape(3, 3, n_in, Ci, n_out, Co).permute(
        0, 1, 2, 4, 3, 5).reshape(3, 3, n_in * n_out, Ci, Co)
    w3 = torch.zeros((3, 3, ZERO_TAP + 1, Ci, Co))
    w3.index_add_(2, torch.from_numpy(table.reshape(-1)), blocks)
    return w3[:, :, :ZERO_TAP].reshape(27, Ci, Co)


# the flagship's p = 4 (C = 32), and the HD encoder's packings (p = 8, 4,
# 2, 1 at C = 16, 32, 64, 128)
@pytest.mark.parametrize("p,C", [(4, 32), (8, 16), (2, 64), (1, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tap_fold_sums_in_a_fixed_order(p, C, dtype):
    """gather_taps_transpose sums each tap's blocks in tap_readers' order:
    equal bit for bit to the old index_add_ fold on the CPU (the same
    order), and two calls repeat."""
    table = subm_ext_table(p)
    g = torch.from_numpy(np.random.RandomState(p * C).standard_normal(
        (3, 3, (p + 2) * C, p * C)).astype(np.float32)).to(dtype)
    got = gather_taps_transpose(g, table, C, C)
    assert got.dtype == torch.float32 and got.shape == (27, C, C)
    assert torch.equal(got, _index_add_taps(g, table, C, C))
    assert torch.equal(got, gather_taps_transpose(g, table, C, C))
    readers = tap_readers(table)
    # every block that reads a tap, once, and the pad past the last block
    for dz in range(3):
        np.testing.assert_array_equal(
            np.sort(readers[dz][readers[dz] < table.size]),
            np.flatnonzero(table.reshape(-1) == dz))
