"""The port's PackedLiDAREnc8x == the JAX PackedLiDAREnc8x (tiny shapes).

One set of weights: the port's encoder is seeded (entry.init_weights), its
state_dict goes through the JAX package's convert_sparse_enc8x, and both
encode the same seeded occupancy of a 160x160x32 grid, where every level
packs to pC = 128 lanes (res1 C=32 p=4, res2 C=64 p=2, res3 C=128 p=1).

Two comparisons:
  * the wiring, exactly: with K2's conv swapped for an fp32 conv of
    unrounded operands (K2's epilogue kept, through the module's
    `subm_ext_conv` seam), the port equals the JAX encoder's fp32 XLA route
    to fp32 summation-order error (atol=rtol=1e-4; measured about 1.5e-5
    on outputs of scale 3.7);
  * the kernel path: the port as it runs against the JAX encoder with its
    SubM convolutions through the Pallas kernel in interpret mode
    (COOCC_PALLAS_SUBM=interpret, as tests/test_pallas_subm.py sets it),
    both with bf16 operands and fp32 sums. Nine SubM layers each round
    their inputs to bf16, so an fp32 difference of one ulp upstream flips
    a rounding now and then and the flips compound: the two sides agree
    only to bf16 noise. Measured on these inputs: max |diff| 1.0% (B=1)
    and 1.5% (B=2) of max |out|, mean 3.4e-4 of it, where the JAX kernel
    route differs from the JAX fp32 route by 1.4% (max) and 4.7e-4
    (mean); on other occupancies (3% and 10%, B=1 and 2) up to 2.0% and
    3.8e-4 against the JAX route's 2.2% and 5.1e-4. Bound: max 4%, mean
    1e-3 of max |out|; a wiring fault moves outputs by O(1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.nn.sparse_enc_packed import PackedLiDAREnc8x as JaxPacked
from coocc_tpu.train.convert_torch import (ParamTreeBuilder,
                                           convert_sparse_enc8x)

from coocc_tpu_torch.entry import init_weights
from coocc_tpu_torch.nn import sparse_enc_packed as packed_mod
from coocc_tpu_torch.nn.sparse_enc_dense import DenseLiDAREnc8x
from coocc_tpu_torch.nn.sparse_enc_packed import PackedLiDAREnc8x
from coocc_tpu_torch.ops.subm_conv import (conv2d_nhwc, epilogue_plain,
                                           shift_ext, subm_ext_conv,
                                           subm_ext_weight)
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)

GRID = (160, 160, 32)


def _occupancy(B, density, seed=0):
    return np.random.RandomState(seed).rand(B, *GRID) < density


@pytest.fixture(scope="module")
def encoder():
    return init_weights(PackedLiDAREnc8x(4, 16, 128), seed=5).eval()


def _jax_variables(enc):
    sd = {f"enc.{k}": v.numpy() for k, v in enc.state_dict().items()}
    b = ParamTreeBuilder()
    convert_sparse_enc8x(b, sd, "enc", "enc")
    return {"params": b.params["enc"], "batch_stats": b.batch_stats["enc"]}


def _jax_encode(enc, occ, monkeypatch, subm_mode):
    if subm_mode:
        monkeypatch.setenv("COOCC_PALLAS_SUBM", subm_mode)
    else:
        monkeypatch.delenv("COOCC_PALLAS_SUBM", raising=False)
    jenc = JaxPacked(input_channel=4, base_channel=16, out_channel=128,
                     sparse_shape_xyz=GRID, compute_dtype=jnp.float32)
    ref = jax.jit(lambda v, m: jenc.apply(v, m, train=False))(
        _jax_variables(enc), jnp.asarray(occ))
    return np.asarray(ref).transpose(0, 4, 1, 2, 3)  # -> [B, C, X, Y, Z]


def _fp32_subm(x_pb, w27, p, mcell, bn=None, identity=None):
    """K2 with its conv in fp32 on unrounded operands, its epilogue kept."""
    B, bz, X, Y, pC = x_pb.shape
    ext = shift_ext(x_pb, pC // p).reshape(B * bz, X, Y, -1)
    y = conv2d_nhwc(ext, subm_ext_weight(w27, p)).reshape(B, bz, X, Y, -1)
    return epilogue_plain(y, mcell, bn, identity)


def test_every_k2_input_is_contiguous(encoder, monkeypatch):
    """The kernel reads its inputs densely and raises rather than copy:
    every tensor the encoder hands K2 is contiguous, and a block's two
    convs take its input as the second one's residual."""
    calls = []

    def record(x_pb, w27, p, mcell, bn=None, identity=None):
        calls.append((x_pb, mcell, bn, identity))
        assert x_pb.is_contiguous() and mcell.is_contiguous()
        assert identity is None or identity.is_contiguous()
        return subm_ext_conv(x_pb, w27, p, mcell, bn, identity)

    monkeypatch.setattr(packed_mod, "subm_ext_conv", record)
    with torch.no_grad():
        encoder(torch.from_numpy(_occupancy(1, 0.03, seed=4)))
    assert len(calls) == 13
    modes = [(bn is None, identity is None) for _, _, bn, identity in calls]
    assert modes == [(False, True), (False, False)] * 6 + [(True, True)]
    for i in range(0, 12, 2):
        assert calls[i + 1][3] is calls[i][0]


def test_packed_encoder_wiring_matches_jax_fp32_route(encoder, monkeypatch):
    occ = _occupancy(2, 0.03, seed=3)
    monkeypatch.setattr(packed_mod, "subm_ext_conv", _fp32_subm)
    with torch.no_grad():
        got = encoder(torch.from_numpy(occ)).numpy()
    ref = _jax_encode(encoder, occ, monkeypatch, None)
    assert got.shape == ref.shape == (2, 128, 20, 20, 4)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def jax_kernel_route(encoder):
    """One JAX run at B=2 (its samples are independent: the B=1 case is
    held against the first)."""
    occ = _occupancy(2, 0.03, seed=2)
    with pytest.MonkeyPatch.context() as mp:
        return occ, _jax_encode(encoder, occ, mp, "interpret")


@pytest.mark.parametrize("B", [1, 2])
def test_packed_encoder_matches_jax_kernel_path(encoder, jax_kernel_route,
                                                B):
    occ, ref = jax_kernel_route
    occ, ref = occ[:B], ref[:B]
    with torch.no_grad():
        got = encoder(torch.from_numpy(occ)).numpy()
    assert got.shape == ref.shape == (B, 128, 20, 20, 4)
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(got - ref)
    assert err.max() <= 4e-2 * scale, (err.max(), scale)
    assert err.mean() <= 1e-3 * scale, (err.mean(), scale)


def test_packed_equals_dense_on_one_state_dict(encoder):
    """The two impls share one parameter set (strict load both ways) and
    differ only by K2's bf16 operand rounding."""
    dense = DenseLiDAREnc8x(4, 16, 128).eval()
    dense.load_state_dict(encoder.state_dict(), strict=True)
    PackedLiDAREnc8x(4, 16, 128).load_state_dict(dense.state_dict(),
                                                 strict=True)
    occ = torch.from_numpy(_occupancy(1, 0.03, seed=9))
    with torch.no_grad():
        d = dense(occ)
        p = encoder(occ)
    scale = float(d.abs().max())
    assert scale > 0
    # bf16 operands through 9 SubM layers (measured 2.2% of the scale)
    assert float((p - d).abs().max()) < 4e-2 * scale


def test_empty_cloud_stays_finite(encoder):
    with torch.no_grad():
        out = encoder(torch.zeros((1, *GRID), dtype=torch.bool))
    assert out.shape == (1, 128, 20, 20, 4)
    assert bool(torch.isfinite(out).all()) and float(out.abs().max()) == 0
