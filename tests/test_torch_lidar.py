"""The LiDAR-only model family (coocc_lidar: COOCC_Ray_L) in the port,
against the JAX package at tiny shapes (CPU).

(a) `ops/voxelize.py:voxelize` against JAX's `voxelize` (fast path) and
    its numpy oracle, on clustered clouds where both the 10-point cap and
    the voxel cap bind: ids and mask equal, means within 1e-6 (measured
    equal: both sum each voxel's points in their sorted order).
(b) `PackedEncoderHD` against JAX's from one set of variables, on a 16x16
    grid with the real Z0 = 65 and widths 16/32/64/128, so that it packs
    p = 8, 4, 2, 1 at bz = 9, runs the z-padding-0 third downsample and the
    7 padded slots of the last pack: fp32 within 1e-4 (atol and rtol, the
    wiring bound of tests/test_torch_packed_encoder.py) with K2's seam
    (`sparse_enc_packed.subm_ext_conv`) swapped for an fp32 conv of
    unrounded operands, as JAX's fp32 XLA route computes; bf16 (K2's plain
    version as it runs) within 2x (max) and 1.5x (mean) of JAX's own
    bf16-vs-fp32 drift.
(c) SECOND3D + SECOND3DFPN (the (1, s, s) transposed convs at s = 2 and 4
    among them) against JAX's: every stage and the FPN's output in fp32
    within 1e-4 of the output's max |x|.
(d) The whole tiny LiDAR-only model, built from tiny_config(use_camera=
    False) with .replace in both packages (neither tiny_config changes;
    tests/test_torch_configs.py:lidar_tiny): a 64x64x65 LiDAR grid (64 z
    cells of a 65-cell grid, as coocc_lidar's 8 m at 0.125 m), the coarse
    8x8x8 grid of a 16x16x16 occupancy, SECOND3D at one conv a stage after
    the strided one, OccHead without the cascade. Every `stop_at` prefix:
    fp32 within 5e-3
    with K2's seam swapped as in (b), bf16 by the drift rule with equal
    dtypes and the coarse argmax within 2x JAX's own share of flips; K2's
    16 calls a forward (4 at Co = 16), conv_input not among them; the
    state_dict round trip through convert_coocc_ray; eval_step's hists
    equal to JAX's make_eval_step on JAX's forward.
JAX's compiles run in threads inside the module-scoped fixtures, as
tests/test_torch_configs.py runs them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from coocc_tpu.nn.second3d import SECOND3D as JaxSECOND3D
from coocc_tpu.nn.second3d import SECOND3DFPN as JaxSECOND3DFPN
from coocc_tpu.nn.sparse_enc_packed_hd import PackedEncoderHD as JaxHD
from coocc_tpu.nn.sparse_enc_packed_hd import (_dilate_packed_weight_z,
                                               _strided_packed_weight_z)
from coocc_tpu.ops.sparse_conv import SparseTensor as JaxSparseTensor
from coocc_tpu.ops.voxelize import voxelize as jax_voxelize
from coocc_tpu.ops.voxelize import voxelize_oracle
from coocc_tpu.parallel.train_step import make_eval_step
from coocc_tpu.train.convert_torch import (ParamTreeBuilder,
                                           convert_coocc_ray,
                                           convert_second3d,
                                           convert_second3d_fpn,
                                           convert_sparse_encoder_hd)

from test_torch_configs import (HD, _Forward, _fp32_subm, _in_threads,
                                _pairs, lidar_configs)
from test_torch_model import TOL, _run_both

from coocc_tpu_torch.config import get_config
from coocc_tpu_torch.config.base import SECOND3DConfig
from coocc_tpu_torch.convert import state_dict_from_jax
from coocc_tpu_torch.data.synthetic import synthetic_batch
from coocc_tpu_torch.entry import build_model, init_weights
from coocc_tpu_torch.models.coocc_ray import STAGES
from coocc_tpu_torch.nn import sparse_enc_packed
from coocc_tpu_torch.nn.second3d import SECOND3D, SECOND3DFPN
from coocc_tpu_torch.nn.sparse_enc_packed_hd import PackedEncoderHD
from coocc_tpu_torch.ops.sparse_conv import SparseTensor
from coocc_tpu_torch.ops.voxelize import delinearize, linearize, voxelize
from coocc_tpu_torch.parallel.train_step import eval_step
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

# ---------------------------------------------------------------------------
# (a) the voxelizer
# ---------------------------------------------------------------------------

VOX_GRID = (16, 16, 13)
VOX_RANGE = (-4.0, -4.0, -1.0, 4.0, 4.0, 0.625)
VOX_SIZE = (0.5, 0.5, 0.125)


def _cloud(seed, n=3000, clusters=60):
    """Points around a few centres, some outside the range, 10% padding."""
    rs = np.random.RandomState(seed)
    centres = rs.uniform([-4.5, -4.5, -1.2], [4.5, 4.5, 0.8], (clusters, 3))
    pts = np.zeros((n, 5), np.float32)
    pts[:, :3] = centres[rs.randint(0, clusters, n)] \
        + rs.normal(0, 0.15, (n, 3))
    pts[:, 3:] = rs.rand(n, 2)
    return pts, rs.rand(n) < 0.9


@pytest.mark.parametrize("seed,max_voxels", [(0, 200), (1, 120), (2, 5000)])
def test_voxelize_matches_jax_and_the_oracle(seed, max_voxels):
    pts, mask = _cloud(seed)
    got = voxelize(torch.from_numpy(pts), torch.from_numpy(mask), VOX_RANGE,
                   VOX_SIZE, VOX_GRID, max_voxels, 10, 4)
    ref = jax_voxelize(jnp.asarray(pts), jnp.asarray(mask), VOX_RANGE,
                       VOX_SIZE, VOX_GRID, max_voxels, 10, 4)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_allclose(got.features.numpy(),
                               np.asarray(ref.features), rtol=1e-6,
                               atol=1e-6)
    # the oracle's sequential semantics, its own cap off: the fast path
    # keeps the max_voxels smallest ids
    o_ids, o_feats = voxelize_oracle(pts[mask], VOX_RANGE, VOX_SIZE,
                                     VOX_GRID, 10 ** 9, 10, 4)
    k = got.mask.numpy()
    n = int(k.sum())
    assert n == min(len(o_ids), max_voxels)
    np.testing.assert_array_equal(got.ids.numpy()[k], o_ids[:n])
    np.testing.assert_allclose(got.features.numpy()[k], o_feats[:n],
                               rtol=1e-6, atol=1e-6)
    assert not got.features.numpy()[~k].any()
    # both caps bind where the case means them to
    assert (len(o_ids) > max_voxels) == (max_voxels < 5000)
    c = np.floor((pts[mask, :3] - np.array(VOX_RANGE[:3])) /
                 np.array(VOX_SIZE)).astype(np.int64)
    inside = ((c >= 0) & (c < VOX_GRID)).all(1)
    _, per_voxel = np.unique(c[inside], axis=0, return_counts=True)
    assert per_voxel.max() > 10


def test_delinearize_inverts_linearize():
    rs = np.random.RandomState(3)
    xyz = torch.from_numpy(rs.randint(0, 13, (50, 3)))
    np.testing.assert_array_equal(
        delinearize(linearize(xyz, (16, 16, 13)), (16, 16, 13)).numpy(),
        xyz.numpy())


# ---------------------------------------------------------------------------
# (b) the HD encoder
# ---------------------------------------------------------------------------

ENC_GRID = (16, 16, 65)
ENC_RANGE = (-4.0, -4.0, -1.0, 4.0, 4.0, 7.0)
ENC_SIZE = (0.5, 0.5, 0.125)


@pytest.mark.parametrize("padz", [0, 1])
@pytest.mark.parametrize("p_in", [2, 4, 8])
def test_strided_packed_weights_match_jax(p_in, padz):
    from coocc_tpu_torch.nn.sparse_enc_packed import (dilate_packed_weight,
                                                      strided_packed_weight)
    C = 128 // p_in
    w27 = np.random.RandomState(p_in).randn(27, C, 2 * C).astype(np.float32)
    np.testing.assert_array_equal(
        strided_packed_weight(torch.from_numpy(w27), p_in, p_in // 2,
                              padz).numpy(),
        np.asarray(_strided_packed_weight_z(jnp.asarray(w27), p_in,
                                            p_in // 2, padz)))
    np.testing.assert_array_equal(
        dilate_packed_weight(p_in, p_in // 2, padz=padz).numpy(),
        np.asarray(_dilate_packed_weight_z(p_in, p_in // 2, padz,
                                           jnp.float32)))


def _sparse_input(B):
    """The voxelized clouds of seeds 0..B-1 on ENC_GRID, as numpy."""
    vs = []
    for b in range(B):
        rs = np.random.RandomState(10 + b)
        n = 1500
        pts = np.zeros((n, 5), np.float32)
        pts[:, :3] = rs.uniform(ENC_RANGE[:3], ENC_RANGE[3:], (n, 3))
        pts[:, 3:] = rs.rand(n, 2)
        vs.append(voxelize(torch.from_numpy(pts), torch.ones(n, dtype=bool),
                           ENC_RANGE, ENC_SIZE, ENC_GRID, 1200, 10, 4))
    return [torch.stack(t).numpy() for t in zip(*vs)]


@pytest.fixture(scope="module")
def encoders():
    """{dtype: (JAX's output, the port's)} [B, X, Y, Z, C] as fp32 numpy
    for a B=2 input: fp32 (K2's seam swapped for the unrounded conv) and
    bf16 (as it runs), the JAX fp32 and bf16 sides in threads."""
    ids, feats, mask = _sparse_input(2)
    enc = init_weights(PackedEncoderHD(sparse_shape_xyz=ENC_GRID), 5).eval()
    sd = {f"enc.{k}": v.numpy() for k, v in enc.state_dict().items()}
    b = ParamTreeBuilder()
    convert_sparse_encoder_hd(b, sd, "enc", "enc")
    variables = {"params": b.params["enc"],
                 "batch_stats": b.batch_stats["enc"]}
    sp = JaxSparseTensor(jnp.asarray(ids.astype(np.int32)),
                         jnp.asarray(feats), jnp.asarray(mask))
    out = {}

    def jax_run(name, jdt):
        jenc = JaxHD(sparse_shape_xyz=ENC_GRID,
                     compute_dtype=jdt or jnp.float32)
        opts = {"xla_allow_excess_precision": False} if jdt else None
        fn = jax.jit(lambda v, s: jenc.apply(v, s, train=False),
                     compiler_options=opts)
        out[name] = np.asarray(fn(variables, sp), np.float32)

    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("COOCC_PALLAS_SUBM", raising=False)   # JAX's XLA route
        mp.setattr(sparse_enc_packed, "subm_ext_conv", _fp32_subm)
        _in_threads(jax_run, [("fp32", None), ("bf16", jnp.bfloat16)])
        port = {}
        for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            enc.compute_dtype = dt
            with torch.no_grad():
                y = enc(SparseTensor(*(torch.from_numpy(a) for a in (
                    ids, feats, mask))))
            assert y.dtype == torch.float32
            port[name] = y.permute(0, 2, 3, 4, 1).numpy()
    assert set(out) == {"fp32", "bf16"}
    return {k: (out[k], port[k]) for k in out}


def test_hd_encoder_fp32_matches_jax(encoders):
    ref, got = encoders["fp32"]
    assert got.shape == ref.shape == (2, 2, 2, 8, 128)
    assert np.abs(ref).max() > 0
    # active cells in the deepest level's eight z slots of both samples
    assert (np.abs(ref).sum(-1) > 0).sum() > 8
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_hd_encoder_bf16_within_jax_drift(encoders):
    jb, tb = encoders["bf16"]
    jf = encoders["fp32"][0]
    own, port = np.abs(jb - jf), np.abs(tb - jb)
    assert own.max() > 0
    assert port.max() <= 2.0 * own.max(), (port.max(), own.max())
    assert port.mean() <= 1.5 * own.mean(), (port.mean(), own.mean())


def test_hd_packs_like_the_real_config():
    """p = 8, 4, 2, 1 at bz = 9 (128 lanes at every stage) for Z0 = 65, and
    the encoder's output grid Z 65 -> 33 -> 17 -> 8."""
    for shape in (ENC_GRID, HD, get_config("coocc_lidar").pts
                  .sparse_shape_xyz):
        enc = PackedEncoderHD(sparse_shape_xyz=shape)
        p0, bz = enc._pack0()
        assert (p0, bz) == (8, 9)
        assert [p0 >> i for i in range(4)] == [128 // c for c in
                                               (16, 32, 64, 128)]


# ---------------------------------------------------------------------------
# (c) SECOND3D + SECOND3DFPN
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def second3d():
    """JAX's and the port's [SECOND3D stages..., FPN] on one [1, 4, 8, 8,
    128] (Z, Y, X, C) input, fp32, channels-last numpy."""
    cfg = SECOND3DConfig()
    bb = init_weights(SECOND3D(cfg.in_channels, cfg.out_channels,
                               cfg.layer_nums, cfg.layer_strides), 3).eval()
    neck = init_weights(SECOND3DFPN(cfg.out_channels, cfg.fpn_out_channels,
                                    cfg.fpn_upsample_strides), 4).eval()
    x = np.random.RandomState(5).randn(1, 4, 8, 8, 128).astype(np.float32)
    with torch.no_grad():
        feats = bb(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
        port = [t.permute(0, 2, 3, 4, 1).numpy()
                for t in feats + [neck(feats)]]
    sd = {**{f"bb.{k}": v.numpy() for k, v in bb.state_dict().items()},
          **{f"neck.{k}": v.numpy() for k, v in neck.state_dict().items()}}
    b = ParamTreeBuilder()
    convert_second3d(b, sd, "bb", "bb", cfg.layer_nums)
    convert_second3d_fpn(b, sd, "neck", "neck", cfg.fpn_upsample_strides,
                         extra_num_conv=cfg.fpn_extra_num_conv)
    var = {k: {"params": b.params[k], "batch_stats": b.batch_stats[k]}
           for k in ("bb", "neck")}

    @jax.jit
    def run(v, x):
        f = JaxSECOND3D().apply(v["bb"], x)
        return list(f) + [JaxSECOND3DFPN().apply(v["neck"], f)]
    ref = [np.asarray(t) for t in run(var, jnp.asarray(x))]
    return ref, port


@pytest.mark.parametrize("i", [0, 1, 2, 3], ids=["stage0", "stage1",
                                                 "stage2", "fpn"])
def test_second3d_and_fpn_match_jax(second3d, i):
    ref, got = second3d[0][i], second3d[1][i]
    assert got.shape == ref.shape
    assert got.shape[:4] == ((1, 4, 8 >> i, 8 >> i) if i < 3
                             else (1, 4, 8, 8))
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got - ref).max() <= 1e-4 * scale, \
        (np.abs(got - ref).max(), scale)


# ---------------------------------------------------------------------------
# (d) the whole tiny model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs():
    """{dtype: _run_both's result} for the tiny LiDAR-only model, every
    prefix from one JAX compile of the full forward per dtype, the two in
    threads; fp32 with K2's seam swapped (module note)."""
    out = {}

    def run(dtype):
        try:
            out[dtype] = _run_both(*lidar_configs(), STAGES + (None,),
                                   capture=True, bf16=dtype == "bf16")
        except BaseException as e:  # re-raised below
            out[dtype] = e
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("COOCC_PALLAS_SUBM", raising=False)
        mp.setattr(sparse_enc_packed, "subm_ext_conv", _fp32_subm)
        _in_threads(run, [("fp32",), ("bf16",)])
    for res in out.values():
        if isinstance(res, BaseException):
            raise res
    return out


@pytest.mark.parametrize("stop", STAGES[1:])
def test_fp32_prefix_matches_jax(runs, stop):
    pairs = _pairs(runs["fp32"], stop)
    assert pairs
    for key, a, b in pairs:
        assert a.shape == b.shape, key
        assert np.abs(b).max() > 0, f"{key} is all zero"
        np.testing.assert_allclose(b, a, err_msg=f"{stop}/{key}", **TOL)


def test_fp32_full_outputs_match_jax(runs):
    j, t = runs["fp32"][None]
    assert set(j) == set(t) == {"occ"}
    assert t["occ"].shape == (1, 8, 8, 8, 17)
    np.testing.assert_allclose(t["occ"], j["occ"], **TOL)


@pytest.mark.parametrize("stop,key,level", [
    ("pts", "pts_voxel", None), ("fuse", "voxel_feats", None)]
    + [("sem", "semantic", i) for i in range(4)] + [(None, "occ", None)])
def test_bf16_matches_jax_bf16_within_its_own_drift(runs, stop, key, level):
    jb, tb = runs["bf16"][stop]
    jf = runs["fp32"][stop][0]
    tb, jb, jf = tb[key], jb[key], jf[key]
    if level is not None:
        tb, jb, jf = tb[level], jb[level], jf[level]
    assert tb.shape == jb.shape == jf.shape
    port, own = np.abs(tb - jb), np.abs(jb - jf)
    assert own.max() > 0
    assert port.max() <= 2.0 * own.max(), (port.max(), own.max())
    assert port.mean() <= 1.5 * own.mean(), (port.mean(), own.mean())


def test_bf16_prefix_dtypes_and_argmax_match_jax(runs):
    res = runs["bf16"]
    for stop in STAGES[1:] + (None,):
        dtypes = res["dtypes"][stop]
        assert dtypes, stop
        for key, (jd, td) in dtypes.items():
            assert jd == td, (stop, key)
    j, t = res[None]
    jf = runs["fp32"][None][0]
    am = [o["occ"].argmax(-1) for o in (t, j, jf)]
    port = float((am[0] != am[1]).mean())
    own = float((am[1] != am[2]).mean())
    assert port <= 2.0 * own + 0.002, (port, own)


def test_k2_calls_of_a_forward(monkeypatch):
    """16 K2 calls a forward, 4 per stage at p = 8, 4, 2, 1 (Co = 16, 32,
    64, 128), each input contiguous; conv_input (32 lanes) is not one."""
    cfg = lidar_configs()[1]
    model = build_model(cfg, "cpu", seed=7)
    calls = []
    k2 = sparse_enc_packed.subm_ext_conv

    def record(x_pb, w27, p, mcell, bn=None, identity=None):
        assert x_pb.is_contiguous() and mcell.is_contiguous()
        assert identity is None or identity.is_contiguous()
        calls.append((p, w27.shape[2], identity is not None))
        return k2(x_pb, w27, p, mcell, bn, identity)
    monkeypatch.setattr(sparse_enc_packed, "subm_ext_conv", record)
    model(synthetic_batch(cfg, batch_size=1, seed=3).to("cpu"),
          stop_at="pts")
    assert calls == [(128 // c, c, r) for c in (16, 32, 64, 128)
                     for _ in range(2) for r in (False, True)]


def test_lidar_state_dict_round_trip():
    """The HD encoder's and SECOND3D's reference names through JAX's
    convert_coocc_ray and back; no image or fuser keys."""
    jcfg, cfg = lidar_configs()
    sd = build_model(cfg, "cpu", seed=11).state_dict()
    assert any(k.startswith("pts_middle_encoder.encoder_layers.") for k in sd)
    assert any(k.startswith("pts_backbone.blocks.") for k in sd)
    assert not any(k.startswith(("img_", "occ_fuser")) for k in sd)
    variables = convert_coocc_ray({k: v.numpy() for k, v in sd.items()},
                                  jcfg)
    back = state_dict_from_jax(variables, cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_eval_step_hists_equal_jax(runs, monkeypatch):
    """The port's eval_step on its own forward (K2's seam swapped, as the
    fixture's) against JAX's make_eval_step on JAX's forward: SC_hist,
    SSC_hist (the coarse occ upsampled to 16x16x16) and lidarseg_hist."""
    monkeypatch.setattr(sparse_enc_packed, "subm_ext_conv", _fp32_subm)
    jcfg, cfg = lidar_configs()
    model = build_model(cfg, "cpu", seed=7)   # the fixture's weights
    got = eval_step(model, synthetic_batch(cfg, batch_size=1, seed=3)
                    .to("cpu"), cfg)
    jbatch = jax_synthetic_batch(jcfg, batch_size=1, seed=3)
    jbatch = jax.tree.map(lambda x: None if x is None else jnp.asarray(x),
                          jbatch, is_leaf=lambda x: x is None)
    j_full = runs["fp32"][None][0]
    ref = make_eval_step(_Forward, jcfg)(
        {k: jnp.asarray(v) for k, v in j_full.items()}, jbatch)
    hists = sorted(k for k in ref if "hist" in k)
    assert hists == sorted(k for k in got if "hist" in k) == [
        "SC_hist", "SSC_hist", "lidarseg_hist"]
    for k in hists:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
