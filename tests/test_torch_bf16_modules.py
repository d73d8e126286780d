"""The port's modules in bf16 against their JAX counterparts in bf16 (CPU).

Each case feeds both packages the same seeded inputs and weights. JAX jits
with xla_allow_excess_precision off, so that each of its bf16 ops rounds as
its code says, as eager torch does (XLA's CPU default keeps fp32 across
chains of elementwise ops).

  * lift_splat: bf16 features gathered and upcast, fp32 depth weights and
    sums: fp32 tolerance (1e-5).
  * a Conv3d + BN + ReLU block and a Conv2d (with bias) + BN block: the
    convs sum bf16 products in fp32 and round once on both sides; the BN
    computes in fp32 and rounds once on both sides; the conv's bias enters
    before the rounding here and after it in flax. Bound: two bf16 ulps of
    the conv's scale times the BN gain, and two of the output (measured:
    the Conv3d block equal bit for bit, the Conv2d block within 0.42 of one
    such ulp, 22% of its elements apart).
  * the cascade's samplers (3D trilinear over the children of coarse cells,
    masked multi-camera bilinear) with compute_dtype=bf16: weights rounded
    to bf16 on both sides, products summed in fp32 in other orders, one
    rounding: one bf16 ulp of the output (measured equal bit for bit).
  * the depth net at the flagship's image shapes (one camera of 256x704
    through the flagship's fp32 ResNet-50 and SECONDFPN: [1, 512, 16, 44]),
    where the served flagship's bf16 drift starts: its depth logits reach
    37 with these seeded random weights, and JAX's own bf16 forward moves
    them by up to 17% of that scale (1.4% on average; its DCN samples at
    bf16 positions, its ASPP and blocks round every layer), its context
    features by 1.5% (0.24%). The port is held to twice (max) and 1.5
    times (mean) that drift, per output (measured ratios 0.65 and 0.63 on
    the logits, 0.43 and 0.42 on the context), and its fp32 to JAX's fp32
    at 1e-3.
  * the packed LiDAR encoder in bf16, twice. With the module's two seams
    (`subm_ext_conv`, K2; `epilogue_plain`, the downsamples' BN) swapped
    for the JAX order of bf16 ops, each rounded as JAX rounds it, the port
    is JAX op for op: each op agrees (one conv or block on one input: a
    bf16 rounding flips at 1e-4 of the elements, from fp32 summation
    order), but a flip spreads through the next convs and the flips compound
    over 13 layers: measured max 2.4% and mean 5.8e-4 of the scale; bound
    max 4% and mean 1e-3, the bound tests/test_torch_packed_encoder.py
    holds the fp32 kernel route to (a wiring fault moves outputs by O(1)).
    As it runs, K2's epilogue and the BN compute in fp32 and round once
    where JAX rounds every op: held to twice (max) and 1.5 times (mean)
    JAX's own bf16-vs-fp32 drift, as the model test holds the whole
    forward (measured 1.09 and 1.03 times). The dense twin in bf16 is held
    to the same rule.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.geometry.frustum import gen_dx_bx as jax_gen_dx_bx
from coocc_tpu.nn import layers as jl
from coocc_tpu.nn.depthnet import DepthNet as JaxDepthNet
from coocc_tpu.nn.fpn3d import _ConvNormReLU3D as JaxConvNormReLU3D
from coocc_tpu.nn.sparse_enc_dense import DenseLiDAREnc8x as JaxDense
from coocc_tpu.nn.sparse_enc_packed import PackedLiDAREnc8x as JaxPacked
from coocc_tpu.ops.grid_sample import cascade_sample_3d as jax_cascade_3d
from coocc_tpu.ops.grid_sample import multicam_bilinear_gemm
from coocc_tpu.ops.lift_splat import lift_splat as jax_lift_splat
from coocc_tpu.train.convert_torch import (ParamTreeBuilder,
                                           convert_depthnet,
                                           convert_sparse_enc8x)

from coocc_tpu_torch.config import get_config
from coocc_tpu_torch.data.synthetic import synthetic_batch
from coocc_tpu_torch.entry import FLAGSHIP, init_weights
from coocc_tpu_torch.geometry.frustum import gen_dx_bx, get_mlp_input
from coocc_tpu_torch.nn.depthnet import DepthNet
from coocc_tpu_torch.nn import sparse_enc_packed as packed_mod
from coocc_tpu_torch.nn.fpn3d import ConvModule3d
from coocc_tpu_torch.nn.layers import BatchNorm, Conv2d
from coocc_tpu_torch.nn.sparse_enc_dense import DenseLiDAREnc8x
from coocc_tpu_torch.nn.resnet2d import ResNet
from coocc_tpu_torch.nn.second_fpn import SECONDFPN
from coocc_tpu_torch.nn.sparse_enc_packed import PackedLiDAREnc8x
from coocc_tpu_torch.ops.grid_sample import (cascade_sample_3d,
                                             multicam_bilinear)
from coocc_tpu_torch.ops.lift_splat import lift_splat
from coocc_tpu_torch.ops.subm_conv import (ext_conv_plain, masked,
                                           subm_ext_weight)
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)

BF16_ULP = 2.0 ** -7   # one bf16 ulp is at most this fraction of |value|
JIT = dict(compiler_options={"xla_allow_excess_precision": False})


def _jit(fn):
    return jax.jit(fn, **JIT)


def _f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _bf16(rng, *shape, scale=1.0):
    """Seeded values already rounded to bf16: (numpy fp32, torch bf16)."""
    t = torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))
    t = t.to(torch.bfloat16)
    return t.float().numpy(), t


def test_lift_splat_bf16_features_match_jax():
    rng = np.random.RandomState(0)
    B, N, D, fH, fW, C = 1, 2, 6, 4, 5, 8
    bounds = ((-4.0, 4.0, 1.0), (-4.0, 4.0, 1.0), (-2.0, 2.0, 1.0))
    dp = rng.rand(B, N, D, fH, fW).astype(np.float32)
    feat_np, feat_t = _bf16(rng, B, N, fH, fW, C)
    geom = rng.uniform(-5, 5, (B, N, D, fH, fW, 3)).astype(np.float32)
    ref = jax_lift_splat(jnp.asarray(dp),
                         jnp.asarray(feat_np).astype(jnp.bfloat16),
                         jnp.asarray(geom), *jax_gen_dx_bx(*bounds))
    got = lift_splat(torch.from_numpy(dp), feat_t, torch.from_numpy(geom),
                     *gen_dx_bx(*bounds))
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32
    assert float(np.abs(_f32(ref)).max()) > 0
    np.testing.assert_allclose(got.numpy(), _f32(ref), atol=1e-5, rtol=1e-5)


def _bn_state(rng, C):
    return {"scale": rng.rand(C).astype(np.float32) + 0.5,
            "bias": (rng.randn(C) * 0.1).astype(np.float32),
            "mean": (rng.randn(C) * 0.3).astype(np.float32),
            "var": rng.rand(C).astype(np.float32) * 1.5 + 0.2}


def _load_bn(bn: BatchNorm, st):
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(st["scale"]))
        bn.bias.copy_(torch.from_numpy(st["bias"]))
        bn.running_mean.copy_(torch.from_numpy(st["mean"]))
        bn.running_var.copy_(torch.from_numpy(st["var"]))


def _jax_bn(st):
    return ({"bn": {"scale": st["scale"], "bias": st["bias"]}},
            {"bn": {"mean": st["mean"], "var": st["var"]}})


def _check_conv_bn(got, ref, conv_scale, gain):
    """Two bf16 ulps of the output and of the conv's scale times the BN's
    gain (the two sides may round the conv apart by one ulp)."""
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    got, ref = got.float().numpy(), _f32(ref)
    err = np.abs(got - ref)
    bound = 2 * BF16_ULP * (np.maximum(np.abs(got), np.abs(ref))
                            + conv_scale * gain)
    assert np.abs(ref).max() > 0
    assert (err <= bound).all(), (err.max(), conv_scale, gain)


def test_conv3d_bn_relu_block_bf16_matches_jax():
    rng = np.random.RandomState(1)
    B, X, Y, Z, Ci, Co = 1, 6, 5, 4, 16, 24
    x_np, x_t = _bf16(rng, B, X, Y, Z, Ci)
    w = (rng.randn(3, 3, 3, Ci, Co) / np.sqrt(27 * Ci)).astype(np.float32)
    st = _bn_state(rng, Co)
    params, stats = _jax_bn(st)
    variables = {"params": {"conv": {"conv": {"kernel": w}}, "bn": params},
                 "batch_stats": {"bn": stats}}
    jmod = JaxConvNormReLU3D(Co, 3, 1, dtype=jnp.bfloat16)
    ref = _jit(lambda v, x: jmod.apply(v, x, train=False))(
        variables, jnp.asarray(x_np).astype(jnp.bfloat16))
    mod = ConvModule3d(Ci, Co, 3, 1).eval()
    with torch.no_grad():
        mod.conv.weight.copy_(torch.from_numpy(w.transpose(4, 3, 0, 1, 2)))
    _load_bn(mod.bn, st)
    with torch.no_grad():
        got = mod(x_t.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        conv = mod.conv(x_t.permute(0, 4, 1, 2, 3).float())
    gain = float((st["scale"] / np.sqrt(st["var"] + 1e-5)).max())
    _check_conv_bn(got, ref, float(conv.abs().max()), gain)


class _JaxConvBN2d(fnn.Module):
    dtype: object = None

    @fnn.compact
    def __call__(self, x):
        x = jl.Conv2d(24, (3, 3), (2, 2), 1, use_bias=True, dtype=self.dtype,
                      name="conv")(x)
        return jl.BatchNorm(use_running_average=True, dtype=self.dtype,
                            name="bn")(x)


def test_conv2d_bias_bn_block_bf16_matches_jax():
    rng = np.random.RandomState(2)
    x_np, x_t = _bf16(rng, 2, 9, 11, 16)
    w = (rng.randn(3, 3, 16, 24) / np.sqrt(9 * 16)).astype(np.float32)
    b = (rng.randn(24) * 0.3).astype(np.float32)
    st = _bn_state(rng, 24)
    params, stats = _jax_bn(st)
    variables = {"params": {"conv": {"conv": {"kernel": w, "bias": b}},
                            "bn": params},
                 "batch_stats": {"bn": stats}}
    ref = _jit(_JaxConvBN2d(jnp.bfloat16).apply)(
        variables, jnp.asarray(x_np).astype(jnp.bfloat16))
    conv = Conv2d(16, 24, 3, 2, 1).eval()
    bn = BatchNorm(24).eval()
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(b))
    _load_bn(bn, st)
    with torch.no_grad():
        y = conv(x_t.permute(0, 3, 1, 2))
        got = bn(y).permute(0, 2, 3, 1)
    gain = float((st["scale"] / np.sqrt(st["var"] + 1e-5)).max())
    _check_conv_bn(got, ref, float(y.float().abs().max()), gain)


def _check_one_ulp(got, ref):
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    got, ref = got.float().numpy(), _f32(ref)
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(got - ref)
    assert (err <= BF16_ULP * np.maximum(np.abs(got), np.abs(ref))
            + 1e-6 * scale).all(), err.max()


def test_cascade_sample_3d_bf16_matches_jax():
    rng = np.random.RandomState(3)
    X, Y, Z, C, r = 10, 9, 4, 16, 2
    vol_np, vol_t = _bf16(rng, X, Y, Z, C)
    coarse = np.stack([rng.randint(0, n, 300) for n in (X, Y, Z)],
                      -1).astype(np.int32)
    final = (X * r, Y * r, Z * r)
    ref = _jit(lambda v, c: jax_cascade_3d(
        v, c, r, final, compute_dtype=jnp.bfloat16))(
        jnp.asarray(vol_np).astype(jnp.bfloat16), jnp.asarray(coarse))
    cell = np.stack(np.meshgrid(*[np.arange(r)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    fine = (coarse[:, None] * r + cell[None]).reshape(-1, 3)
    got = cascade_sample_3d(vol_t, torch.from_numpy(fine), final)
    _check_one_ulp(got, ref)


def test_multicam_bilinear_bf16_matches_jax():
    rng = np.random.RandomState(4)
    N, H, W, C, P = 3, 6, 11, 16, 500
    imgs = rng.randn(N, H, W, C).astype(np.float32)
    uv = rng.uniform(-1.2, 1.2, (N, P, 2)).astype(np.float32)
    mask = rng.rand(N, P) > 0.3
    ref = _jit(lambda i, g, m: multicam_bilinear_gemm(
        i, g, m, align_corners=True, compute_dtype=jnp.bfloat16,
        chunk=None))(jnp.asarray(imgs), jnp.asarray(uv), jnp.asarray(mask))
    got = multicam_bilinear(torch.from_numpy(imgs), torch.from_numpy(uv),
                            torch.from_numpy(mask), torch.bfloat16)
    _check_one_ulp(got, ref)


def test_depthnet_bf16_at_flagship_image_shape_within_jax_drift():
    cfg = get_config(FLAGSHIP)
    lss = cfg.lss
    D = cfg.grid.num_depth_bins
    batch = synthetic_batch(cfg, batch_size=1, seed=0)
    backbone = init_weights(ResNet(50), seed=1).eval()
    neck = init_weights(SECONDFPN(backbone.out_channels,
                                  cfg.img_neck.out_channels,
                                  cfg.img_neck.upsample_strides),
                        seed=2).eval()
    net = init_weights(DepthNet(lss.numC_input, lss.numC_input,
                                lss.numC_Trans, D, lss.cam_channels),
                       seed=3).eval()
    with torch.no_grad():
        img = torch.from_numpy(batch.imgs[0, :1]).permute(0, 3, 1, 2)
        x = neck(backbone(img))                      # [1, 512, 16, 44]
        mlp = get_mlp_input(*(torch.from_numpy(a) for a in (
            batch.rots, batch.trans, batch.intrins, batch.post_rots,
            batch.post_trans, batch.bda)))[0, :1]         # camera 0
        port = {dt: net(x.to(dt), mlp).float().numpy()
                for dt in (torch.float32, torch.bfloat16)}
    assert x.shape == (1, 512, 16, 44)
    b = ParamTreeBuilder()
    convert_depthnet(b, {f"dn.{k}": v.numpy()
                         for k, v in net.state_dict().items()}, "dn", "dn")
    variables = {"params": b.params["dn"], "batch_stats": b.batch_stats["dn"]}
    ref = {}
    for dt, jdt in ((torch.float32, None), (torch.bfloat16, jnp.bfloat16)):
        jnet = JaxDepthNet(mid_channels=lss.numC_input,
                           context_channels=lss.numC_Trans, depth_channels=D,
                           cam_channels=lss.cam_channels, dtype=jdt)
        fn = lambda v, x, m: jnet.apply(v, x, m, train=False)  # noqa: E731
        xj = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
        out = (_jit(fn) if jdt else jax.jit(fn))(
            variables, xj.astype(jdt) if jdt else xj, jnp.asarray(mlp.numpy()))
        ref[dt] = _f32(out).transpose(0, 3, 1, 2)
    for name, sl in (("depth logits", slice(0, D)),
                     ("context", slice(D, None))):
        tb, jb, jf = (a[:, sl] for a in (port[torch.bfloat16],
                                         ref[torch.bfloat16],
                                         ref[torch.float32]))
        np.testing.assert_allclose(port[torch.float32][:, sl], jf,
                                   atol=1e-3, rtol=1e-3, err_msg=name)
        own = np.abs(jb - jf)
        diff = np.abs(tb - jb)
        assert own.max() > 0, name
        assert diff.max() <= 2.0 * own.max(), (name, diff.max(), own.max())
        assert diff.mean() <= 1.5 * own.mean(), (name, diff.mean(),
                                                 own.mean())


# ---------------------------------------------------------------------------
# the packed encoder
# ---------------------------------------------------------------------------

GRID = (160, 160, 32)


@pytest.fixture(scope="module")
def encoder():
    return init_weights(PackedLiDAREnc8x(4, 16, 128, torch.bfloat16),
                        seed=5).eval()


def _jax_encode(encoder, jax_cls, occ):
    """The JAX encoder class on one occupancy, the port encoder's weights,
    in bf16 and in fp32 -> {"bf16", "fp32"}: [B, C, X, Y, Z]."""
    sd = {f"enc.{k}": v.numpy() for k, v in encoder.state_dict().items()}
    b = ParamTreeBuilder()
    convert_sparse_enc8x(b, sd, "enc", "enc")
    variables = {"params": b.params["enc"],
                 "batch_stats": b.batch_stats["enc"]}
    out = {}
    for name, cd in (("bf16", jnp.bfloat16), ("fp32", jnp.float32)):
        jenc = jax_cls(input_channel=4, base_channel=16, out_channel=128,
                       sparse_shape_xyz=GRID, compute_dtype=cd)
        fn = lambda v, m: jenc.apply(v, m, train=False)  # noqa: E731
        ref = (_jit(fn) if name == "bf16" else jax.jit(fn))(
            variables, jnp.asarray(occ))
        out[name] = np.asarray(ref).transpose(0, 4, 1, 2, 3)
    return out


@pytest.fixture(scope="module")
def jax_encodings(encoder):
    """JAX's packed encoder (XLA SubM route) on one occupancy in bf16 and
    in fp32."""
    occ = np.random.RandomState(6).rand(1, *GRID) < 0.03
    return occ, _jax_encode(encoder, JaxPacked, occ)


def _jax_order_epilogue(y, mcell, bn=None, identity=None):
    """JAX's _PackedSubM mask, _PackedBNCore and block tail in y's dtype,
    each op rounded to it (mean, inv and bias cast first)."""
    dt = y.dtype
    y = masked(y, mcell)
    if bn is None:
        return y
    p = mcell.shape[-1]
    mean, inv, bias = (v.repeat(p).to(dt) for v in bn)
    y = masked((y - mean) * inv + bias, mcell)
    if identity is None:
        return torch.relu(y)
    return masked(torch.relu(y + identity), mcell)


def _jax_order_subm(x_pb, w27, p, mcell, bn=None, identity=None):
    """JAX's XLA SubM: the bf16 conv (bf16 weight, fp32 sums, one rounding)
    and its epilogue in JAX's bf16 ops."""
    y = ext_conv_plain(x_pb, subm_ext_weight(w27, p), x_pb.shape[1],
                       x_pb.shape[-1] // p)
    return _jax_order_epilogue(y, mcell, bn, identity)


def test_packed_encoder_bf16_wiring_matches_jax_op_for_op(
        encoder, jax_encodings, monkeypatch):
    occ, ref = jax_encodings
    monkeypatch.setattr(packed_mod, "subm_ext_conv", _jax_order_subm)
    monkeypatch.setattr(packed_mod, "epilogue_plain", _jax_order_epilogue)
    with torch.no_grad():
        got = encoder(torch.from_numpy(occ)).numpy()
    ref = ref["bf16"]
    assert got.shape == ref.shape == (1, 128, 20, 20, 4)
    scale = np.abs(ref).max()
    err = np.abs(got - ref)
    assert scale > 0
    assert err.max() <= 4e-2 * scale, (err.max(), scale)
    assert err.mean() <= 1e-3 * scale, (err.mean(), scale)


def test_packed_encoder_bf16_within_jax_own_drift(encoder, jax_encodings):
    occ, ref = jax_encodings
    with torch.no_grad():
        got = encoder(torch.from_numpy(occ))
    assert got.dtype == torch.float32  # the encoder returns fp32, as JAX's
    port = np.abs(got.numpy() - ref["bf16"])
    own = np.abs(ref["bf16"] - ref["fp32"])
    assert own.max() > 0
    assert port.max() <= 2.0 * own.max(), (port.max(), own.max())
    assert port.mean() <= 1.5 * own.mean(), (port.mean(), own.mean())


def test_dense_encoder_bf16_within_jax_own_drift(encoder):
    """pts.impl="dense" in bf16: the stem (the conv of the mask) rounds to
    bf16 and every layer after it is fp32, on both sides (JAX's masked BN
    promotes to its fp32 statistics). Held to the drift rule above."""
    dense = DenseLiDAREnc8x(4, 16, 128, torch.bfloat16).eval()
    dense.load_state_dict(encoder.state_dict(), strict=True)
    occ = np.random.RandomState(7).rand(1, *GRID) < 0.03
    ref = _jax_encode(dense, JaxDense, occ)
    with torch.no_grad():
        got = dense(torch.from_numpy(occ))
    assert got.dtype == torch.float32
    port = np.abs(got.numpy() - ref["bf16"])
    own = np.abs(ref["bf16"] - ref["fp32"])
    assert own.max() > 0
    assert port.max() <= 2.0 * own.max(), (port.max(), own.max())
    assert port.mean() <= 1.5 * own.mean(), (port.mean(), own.mean())
