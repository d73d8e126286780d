"""The port's Swin backbone (coocc_tpu_torch/nn/swin.py) against the JAX
package's (coocc_tpu/nn/swin.py) on the CPU.

  * the index and mask tables (`_rel_pos_index`, `_shift_attn_mask`, on
    grids that are window multiples) equal JAX's exactly, and the window
    partition and its reverse equal JAX's and round-trip;
  * WindowMSA with and without a seam mask, and a SwinTransformer whose
    stage 0 pads 16x48 tokens to 21x49 under an active shift (window 7),
    in fp32 within atol = rtol = 2e-4 (tests/test_golden_swin.py's
    tolerance), and in bf16 within 2x (max) and 1.5x (mean) of JAX's own
    bf16-vs-fp32 drift (the repo's bf16 rule; JAX compiled with
    xla_allow_excess_precision off);
  * its gradient (sum(out * cot), through the bias table's fixed-order
    gather) against jax.grad in fp32, each leaf within 1e-4 of its scale;
  * the converters: the port's state_dict through `convert.swin_to_jax`
    and back unchanged, every leaf the shape JAX's init gives, and JAX's
    `convert_swin` of golden_refs.TorchSwinT carried into the port
    (`convert.module_state_dict_from_jax`) giving TorchSwinT's outputs
    within 2e-4, and the port's names and PatchMerging permutation equal to
    JAX's `convert_swin` on the port's own state_dict;
  * the real-shape fingerprint `coocc_tpu_torch/parity/swin_real.npz`:
    JAX's Swin-T on one 256x704 camera (every stage pads: 64x176 ->
    70x182, 32x88 -> 35x91, 16x44 -> 21x49, 8x22 -> 14x28) in fp32 from
    `parity.swin_inputs`' numpy weights, sampled as the other fingerprints
    are. Gated (COOCC_TORCH_REAL=1) the test recomputes both sides, holds
    the CPU port within 2e-4 (max) and 1e-5 (mean) of each output's scale
    and rewrites the file (about 20 s); ungated it checks the committed
    file: its size, its digests against the weights and image the port
    draws here, and the distances it records.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.nn import swin as jswin
from coocc_tpu.train.convert_torch import ParamTreeBuilder, convert_swin

from coocc_tpu_torch import parity
from coocc_tpu_torch.convert import module_state_dict_from_jax, swin_to_jax
from coocc_tpu_torch.entry import init_flax, init_weights
from coocc_tpu_torch.nn import swin
from golden_refs import TorchSwinT
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

TOL = dict(atol=2e-4, rtol=2e-4)
JIT16 = dict(compiler_options={"xla_allow_excess_precision": False})
# a twin whose stage 0 (16 x 48 tokens at 64 x 192) pads to 21 x 49
KW = dict(embed_dims=16, window_size=7, depths=(2, 2, 1, 1),
          num_heads=(2, 2, 4, 4))
IMAGE = (2, 64, 192)


def _f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _drift_ok(port, j16, j32):
    port, own = np.abs(port - j16), np.abs(j16 - j32)
    assert own.max() > 0
    assert port.max() <= 2.0 * own.max(), (port.max(), own.max())
    assert port.mean() <= 1.5 * own.mean(), (port.mean(), own.mean())


def _jax_tree(sd, depths, out_indices=(0, 1, 2, 3)):
    return swin_to_jax({f"m.{k}": v for k, v in sd.items()}, depths,
                       out_indices, prefix="m")["params"]


@pytest.mark.parametrize("wh,ww", [(3, 4), (7, 7), (2, 5)])
def test_rel_pos_index_equals_jax(wh, ww):
    np.testing.assert_array_equal(swin._rel_pos_index(wh, ww),
                                  jswin._rel_pos_index(wh, ww))


@pytest.mark.parametrize("H,W,ws,shift", [(8, 8, 4, 2), (21, 49, 7, 3),
                                          (14, 28, 7, 3), (70, 182, 7, 3),
                                          (12, 8, 4, 1)])
def test_shift_mask_equals_jax(H, W, ws, shift):
    np.testing.assert_array_equal(
        swin._shift_attn_mask(H, W, ws, shift).numpy(),
        jswin._shift_attn_mask(H, W, ws, shift))


def test_window_partition_equals_jax_and_round_trips(rng):
    x = rng.randn(2, 8, 12, 5).astype(np.float32)
    wins = swin._window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(
        wins.numpy(), np.asarray(jswin._window_partition(jnp.asarray(x), 4)))
    back = swin._window_reverse(wins, 4, 2, 8, 12)
    np.testing.assert_array_equal(back.numpy(), x)


def _msa_case(rng, masked):
    C, nh, ws = 16, 2, 4
    mod = init_weights(swin.WindowMSA(C, nh, ws), 2).eval()
    x = rng.randn(6, ws * ws, C).astype(np.float32)
    mask = jswin._shift_attn_mask(8, 12, ws, 2) if masked else None
    p = jax.tree.map(np.asarray, {
        "qkv": {"kernel": mod.qkv.weight.detach().numpy().T,
                "bias": mod.qkv.bias.detach().numpy()},
        "proj": {"kernel": mod.proj.weight.detach().numpy().T,
                 "bias": mod.proj.bias.detach().numpy()},
        "relative_position_bias_table":
            mod.relative_position_bias_table.detach().numpy()})
    return mod, x, mask, p


@pytest.mark.parametrize("masked", [False, True])
def test_window_msa_matches_jax(rng, masked):
    mod, x, mask, p = _msa_case(rng, masked)
    out = {}
    for name, dt, jdt in (("fp32", torch.float32, jnp.float32),
                          ("bf16", torch.bfloat16, jnp.bfloat16)):
        jm = jswin.WindowMSA(16, 2, 4, dtype=jdt)
        fn = jax.jit(lambda p, x, m: jm.apply({"params": p}, x, m),
                     **(JIT16 if name == "bf16" else {}))
        ref = fn(p, jnp.asarray(x).astype(jdt),
                 None if mask is None else jnp.asarray(mask))
        with torch.no_grad():
            got = mod(torch.from_numpy(x).to(dt), None if mask is None
                      else torch.from_numpy(mask))
        assert str(got.dtype)[6:] == ref.dtype.name
        out[name] = (got.float().numpy(), _f32(ref))
    np.testing.assert_allclose(*out["fp32"], **TOL)
    _drift_ok(out["bf16"][0], out["bf16"][1], out["fp32"][1])


@pytest.fixture(scope="module")
def twin():
    """The port's twin with seeded weights, its JAX params, an image
    batch, JAX's fp32 and bf16 outputs and the port's."""
    model = init_weights(swin.SwinTransformer(**KW), 3).eval()
    params = _jax_tree(model.state_dict(), KW["depths"])
    x = np.random.RandomState(0).randn(IMAGE[0], IMAGE[1], IMAGE[2],
                                       3).astype(np.float32)
    out = {}
    for name, dt, jdt in (("fp32", torch.float32, None),
                          ("bf16", torch.bfloat16, jnp.bfloat16)):
        jm = jswin.SwinTransformer(**KW, dtype=jdt)
        fn = jax.jit(lambda p, x: jm.apply({"params": p}, x),
                     **(JIT16 if jdt else {}))
        ref = fn(params, jnp.asarray(x).astype(jdt or jnp.float32))
        with torch.no_grad():
            got = model(torch.from_numpy(x).permute(0, 3, 1, 2).to(dt))
        out[name] = ([o.permute(0, 2, 3, 1).float().numpy() for o in got],
                     [_f32(r) for r in ref], [str(o.dtype)[6:] for o in got],
                     [r.dtype.name for r in ref])
    return model, params, x, out


def test_twin_pads_every_stage_under_a_shift(twin):
    """16 x 48 -> 21 x 49 and 8 x 24 -> 14 x 28 under window 7."""
    model = twin[0]
    for i, (H, W) in enumerate([(16, 48), (8, 24), (4, 12), (2, 6)]):
        assert H % 7 or W % 7, i
    assert [b.attn.shift for s in model.stages for b in s.blocks] \
        == [0, 3, 0, 3, 0, 0]


def test_swin_fp32_matches_jax(twin):
    got, ref, gdt, rdt = twin[3]["fp32"]
    assert [g.shape for g in got] == [(2, 16, 48, 16), (2, 8, 24, 32),
                                      (2, 4, 12, 64), (2, 2, 6, 128)]
    assert gdt == rdt == ["float32"] * 4
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **TOL)


def test_swin_bf16_within_jax_own_drift(twin):
    got, ref, gdt, rdt = twin[3]["bf16"]
    assert gdt == rdt == ["bfloat16"] * 4
    for g, r, r32 in zip(got, ref, twin[3]["fp32"][1]):
        _drift_ok(g, r, r32)


def test_swin_gradients_match_jax(twin):
    """The backward (the bias tables' gathers through gather_rows, the
    written-out LayerNorm, GELU and softmax) against jax.grad."""
    model, params, x, _ = twin
    cots = [np.random.RandomState(i).randn(*o.shape).astype(np.float32)
            for i, o in enumerate(twin[3]["fp32"][1])]
    jm = jswin.SwinTransformer(**KW)

    def loss(p):
        outs = jm.apply({"params": p}, jnp.asarray(x))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))
    jgrads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params))
    model.train()
    model.zero_grad()
    outs = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    sum((o.permute(0, 2, 3, 1) * torch.from_numpy(c)).sum()
        for o, c in zip(outs, cots)).backward()
    model.eval()
    grads = {k: p.grad for k, p in model.named_parameters()}
    grads.update({k: v for k, v in model.state_dict().items()
                  if k.endswith("relative_position_index")})
    ported = _jax_tree(grads, KW["depths"])
    flat = jax.tree_util.tree_flatten_with_path
    pg = dict(flat(ported)[0])
    leaves = flat(jgrads)[0]
    assert len(leaves) == len(pg) > 40
    for path, ref in leaves:
        scale = np.abs(ref).max()
        assert scale > 0, path
        assert np.abs(pg[path] - ref).max() <= 1e-4 * scale, (
            jax.tree_util.keystr(path), np.abs(pg[path] - ref).max(), scale)


def test_converter_round_trips_and_matches_jax_init(twin):
    model, params = twin[:2]
    sd = model.state_dict()
    back = module_state_dict_from_jax(model, {"params": params})
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    # jitted: flax's eager init dispatches every op of the forward
    init = jax.jit(jswin.SwinTransformer(**KW).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 192, 3)))["params"]
    assert jax.tree.structure(init) == jax.tree.structure(params)
    assert jax.tree.all(jax.tree.map(lambda a, b: a.shape == b.shape,
                                     init, params))


def test_port_to_jax_equals_jax_convert_swin(twin):
    """swin_to_jax on the port's state_dict (its names are the reference
    checkpoint's) == JAX's own convert_swin on it."""
    model, params = twin[:2]
    b = ParamTreeBuilder()
    convert_swin(b, {f"m.{k}": v.numpy() for k, v in
                     model.state_dict().items()}, "m", "swin",
                 depths=KW["depths"])
    flat = jax.tree_util.tree_flatten_with_path
    ref = dict(flat(b.params["swin"])[0])
    got = flat(params)[0]
    assert set(ref) == {p for p, _ in got}
    for path, v in got:
        np.testing.assert_array_equal(v, ref[path])


def test_torch_swin_through_jax_converter_into_port(rng):
    """golden_refs.TorchSwinT -> JAX's convert_swin -> the port: its
    outputs equal TorchSwinT's within 2e-4."""
    torch.manual_seed(0)
    depths, heads = (2, 2), (2, 4)
    tm = TorchSwinT(embed=16, ws=4, depths=depths, heads=heads,
                    out_indices=(0, 1))
    with torch.no_grad():
        for p in tm.parameters():
            p.copy_(0.1 * torch.randn_like(p))
    tm.eval()
    x = rng.randn(2, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x))
    b = ParamTreeBuilder()
    convert_swin(b, {"m." + k: v.numpy() for k, v in
                     tm.state_dict().items()}, "m", "swin", depths=depths,
                 out_indices=(0, 1))
    port = swin.SwinTransformer(embed_dims=16, window_size=4, depths=depths,
                                num_heads=heads, out_indices=(0, 1)).eval()
    port.load_state_dict(module_state_dict_from_jax(
        port, {"params": b.params["swin"]}))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **TOL)


def test_init_flax_draws_flax_initializers_for_swin():
    """entry.init_flax on the backbone: LayerNorms at scale 1 and bias 0,
    the bias tables flax's truncated_normal(0.02) (|x| <= 0.04), Linear
    and conv biases 0."""
    model = init_flax(swin.SwinTransformer(**KW), 0)
    tables = [m.relative_position_bias_table for m in model.modules()
              if isinstance(m, swin.WindowMSA)]
    assert len(tables) == 6
    t = torch.cat([x.detach().reshape(-1) for x in tables])
    assert t.abs().max() <= 0.04 and 0.012 < float(t.std()) < 0.02
    for m in model.modules():
        if isinstance(m, torch.nn.LayerNorm):
            assert bool((m.weight == 1).all() and (m.bias == 0).all())
        elif isinstance(m, torch.nn.Linear) and m.bias is not None:
            assert bool((m.bias == 0).all())


# ---------------------------------------------------------------------------
# the real-shape fingerprint
# ---------------------------------------------------------------------------

GATE = os.environ.get("COOCC_TORCH_REAL", "") == "1"
REAL_MAX, REAL_MEAN = 2e-4, 1e-5


@pytest.mark.skipif(not GATE, reason="set COOCC_TORCH_REAL=1 (slow)")
def test_swin_real_shape_matches_jax_and_writes_the_fingerprint():
    model, x = parity.swin_inputs("cpu")
    params = _jax_tree(model.state_dict(), (2, 2, 6, 2))
    jm = jswin.SwinTransformer()
    ref = jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        params, jnp.asarray(x.permute(0, 2, 3, 1).numpy()))
    jout = {f"swin{i}": np.asarray(r) for i, r in enumerate(ref)}
    assert [o.shape[1:3] for o in jout.values()] == [
        (64, 176), (32, 88), (16, 44), (8, 22)]
    fp = parity.entries(jout, parity.swin_outputs(model, x), "fp32", 1)
    fp["state_digest"] = np.array(parity.state_digest(model))
    fp["input_digest"] = np.array(parity.digest({"x": x.numpy()}))
    for k in parity.SWIN_OUTPUTS:
        dmax, dmean = fp[f"fp32/{k}/port"]
        assert dmax <= REAL_MAX and dmean <= REAL_MEAN, (k, dmax, dmean)
    np.savez_compressed(parity.path(parity.SWIN), **fp)


def test_swin_fingerprint_is_small_and_complete():
    assert os.path.getsize(parity.path(parity.SWIN)) < 256 << 10
    fp = parity.load(parity.SWIN)
    for k in parity.SWIN_OUTPUTS:
        assert fp[f"fp32/{k}/idx"].shape == (parity.N_SAMPLE,)
        assert fp[f"fp32/{k}/val"].shape == (parity.N_SAMPLE,)
        assert float(fp[f"fp32/{k}/scale"]) > 0
    assert [fp[f"fp32/swin{i}/csum"].shape for i in range(4)] == [
        (96,), (192,), (384,), (768,)]


def test_swin_fingerprint_digests_match_the_ports_weights_and_input():
    fp = parity.load(parity.SWIN)
    model, x = parity.swin_inputs("cpu")
    assert parity.state_digest(model) == str(fp["state_digest"])
    assert parity.digest({"x": x.numpy()}) == str(fp["input_digest"])


def test_swin_fingerprint_recorded_distances_hold_their_bounds():
    fp = parity.load(parity.SWIN)
    for k in parity.SWIN_OUTPUTS:
        dmax, dmean = fp[f"fp32/{k}/port"]
        assert dmax <= REAL_MAX and dmean <= REAL_MEAN, (k, dmax, dmean)
