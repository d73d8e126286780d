"""The port's packed SubM conv (CPU: its plain version) == the JAX kernel's.

`subm_ext_conv` on a CPU tensor takes `subm_ext_conv_plain` (bf16-rounded
operands, fp32 conv2d of shift_ext(x)); it is held against the JAX Pallas
kernel in interpret mode, as tests/test_pallas_subm.py runs it, at that
test's shapes plus a p=1, C=128 one, for fp32 and bf16 inputs. The block
weights and layout helpers of nn/sparse_enc_packed.py equal the JAX ones
exactly on seeded weights. The CUDA kernel runs only on the card:
chip_smoke.py holds it against the same plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.nn import sparse_enc_packed as jpk
from coocc_tpu.ops.pallas.subm_conv import subm_ext_conv as jax_subm_ext_conv

from coocc_tpu_torch.nn import sparse_enc_packed as tpk
from coocc_tpu_torch.ops.subm_conv import shift_ext, subm_ext_conv

SHAPES = [(1, 3, 12, 16, 32, 4), (2, 2, 9, 11, 64, 2),
          (1, 2, 10, 12, 128, 1)]
# fp32 in: both sum the same bf16 products in fp32, in other orders (outputs
# are O(1)-O(10) over K = 9*(pC+2C) <= 3456 terms). bf16 in: the bf16
# output may round the fp32 sum one ulp apart (JAX test's atol 2e-2).
TOL = {"float32": dict(rtol=1e-5, atol=1e-4),
       "bfloat16": dict(rtol=0, atol=2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,bz,X,Y,C,p", SHAPES)
def test_subm_ext_conv_matches_jax_kernel(B, bz, X, Y, C, p, dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(B, bz, X, Y, p * C).astype(np.float32)
    w27 = (0.1 * rng.randn(27, C, C)).astype(np.float32)
    wext = np.array(jpk._subm_ext_weight(jnp.asarray(w27), p))

    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    ref = jax_subm_ext_conv(jx, jnp.asarray(wext), bz=bz, C=C,
                            interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = subm_ext_conv(tx, torch.from_numpy(wext), bz, C)

    assert got.shape == tuple(ref.shape) and got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dtype])


@pytest.mark.parametrize("p", [1, 2, 4])
def test_block_weights_match_jax(p):
    rng = np.random.RandomState(p)
    C, Z = 128 // p, 8
    w27 = rng.randn(27, C, 2 * C).astype(np.float32)
    tw, jw = torch.from_numpy(w27), jnp.asarray(w27)
    pairs = [
        (tpk.subm_ext_weight(tw, p), jpk._subm_ext_weight(jw, p)),
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
