"""The packed LiDAR encoder's routes for grids whose levels pack fewer than
128 lanes: the lane-major stride-2 downsample (JAX takes it where the pack
rows do not halve, p != 2 * p_out) and the narrow-lane SubM conv (where p*C
is not a multiple of 128, JAX computes the SubM conv through XLA, not its
Pallas kernel), against the JAX package on the CPU.

Which grids reach them depends on the LiDAR grid's depth Z0 (`pick_pack`):

    Z0                    res1          down2       res2          down3
    64, 80, 40, 48, 24    p=4, 128      packed      p=2, 128      packed
    36                    p=3,  96      lane-major  p=1,  64      lane-major
    20                    p=2,  64      packed      p=1,  64      lane-major
    12                    p=3,  96      lane-major  p=1,  64      lane-major

res3 and conv_out are 128 lanes wide at every depth (C = 128, p = 1), and
take K2. `test_routes_follow_the_grid_depth` reads the table off the port's
encoder on the meta device, at 800 x 800 x Z0.

The tiny twins at 32 x 32 x 12 and 32 x 32 x 20 (B = 2, seeded occupancy)
reach both lane-major downsamples and the 96- and 64-lane SubM. One set of
weights (the port's seeded init through JAX's convert_sparse_enc8x):
  * eval in fp32, against JAX's PackedLiDAREnc8x under COOCC_STRIDED_MODE
    hybrid (its default), lm and packed (layouts of one function), with
    JAX's SubM on its XLA route and K2's seam swapped for the fp32 conv of
    unrounded operands (the narrow route is unrounded fp32 on both sides
    already): within 1e-4 of the output's scale;
  * eval in bf16 (compute_dtype bf16 on both sides; K2's plain version and
    JAX's XLA route both take bf16 operands with fp32 sums): within 2x
    (max) and 1.5x (mean) of JAX's own bf16-vs-fp32 drift, the rule of
    tests/test_torch_model.py;
  * a train step in fp32 (batch statistics; K2's training seam on the fp32
    conv of unrounded operands): the output and the moved statistics within
    1e-4 of each one's scale, each parameter's gradient of sum(out * noise)
    within 1e-3 of its scale, the bounds of
    tests/test_torch_gather_encoders.py (a).
JAX compiles in threads beside the port's runs.
"""
import functools
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.nn.sparse_enc_packed import PackedLiDAREnc8x as JaxPacked
from coocc_tpu.train.convert_torch import (ParamTreeBuilder,
                                           convert_sparse_enc8x)

from test_torch_packed_encoder import _fp32_subm as fp32_k2

from coocc_tpu_torch.entry import init_weights
from coocc_tpu_torch.nn import sparse_enc_packed
from coocc_tpu_torch.nn.sparse_enc_packed import PackedLiDAREnc8x
from coocc_tpu_torch.ops.subm_conv import subm_conv_unrounded
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

GRIDS = {"z12": (32, 32, 12), "z20": (32, 32, 20)}
FORMS = ("hybrid", "lm", "packed")     # COOCC_STRIDED_MODE
JIT16 = dict(compiler_options={"xla_allow_excess_precision": False})
_ENV_LOCK = threading.Lock()


def _variables(sd):
    """The port's state_dict (weights, or gradients by name) as JAX's
    variables."""
    b = ParamTreeBuilder()
    convert_sparse_enc8x(b, {f"enc.{k}": v.numpy() for k, v in sd.items()},
                         "enc", "enc")
    return {"params": b.params["enc"], "batch_stats": b.batch_stats["enc"]}


def _jax_compile(fn, mode, *args):
    """jit fn traced under COOCC_STRIDED_MODE=mode (JAX reads it while it
    traces), compiled outside the lock."""
    with _ENV_LOCK:
        old = os.environ.pop("COOCC_STRIDED_MODE", None)
        os.environ["COOCC_STRIDED_MODE"] = mode
        try:
            lowered = fn.lower(*args)
        finally:
            os.environ.pop("COOCC_STRIDED_MODE")
            if old is not None:
                os.environ["COOCC_STRIDED_MODE"] = old
    return lowered.compile()


def _jax_side(grid, variables, occ, cot):
    """JAX's fp32 eval under each form, its bf16 eval, and its fp32 train
    step (output, moved statistics, gradient of sum(out * cot)), numpy in
    JAX's layout."""
    os.environ.pop("COOCC_PALLAS_SUBM", None)
    occ = jnp.asarray(occ)
    res = {}
    mod = JaxPacked(input_channel=4, sparse_shape_xyz=grid)
    for mode in FORMS:
        fn = jax.jit(functools.partial(mod.apply, train=False))
        res[mode] = np.asarray(_jax_compile(fn, mode, variables, occ)(
            variables, occ))
    mod16 = JaxPacked(input_channel=4, sparse_shape_xyz=grid,
                      compute_dtype=jnp.bfloat16)
    fn16 = jax.jit(functools.partial(mod16.apply, train=False), **JIT16)
    res["bf16"] = np.asarray(_jax_compile(fn16, "hybrid", variables, occ)(
        variables, occ)).astype(np.float32)

    def train(params):
        out, upd = mod.apply({**variables, "params": params}, occ,
                             train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd["batch_stats"])
    step = jax.jit(jax.value_and_grad(train, has_aux=True))
    (_, (out, stats)), grads = _jax_compile(step, "hybrid",
                                            variables["params"])(
        variables["params"])
    res["train"] = jax.tree.map(np.asarray, (out, stats, grads))
    return res


def _port_side(grid, occ, seed):
    """The port's fp32 eval (K2's seam on the fp32 conv of unrounded
    operands), bf16 eval, and fp32 train step, in JAX's layout."""
    enc = init_weights(PackedLiDAREnc8x(4), seed).eval()
    sd = {k: v.clone() for k, v in enc.state_dict().items()}
    x = torch.from_numpy(occ)

    def cl(t):
        return t.detach().permute(0, 2, 3, 4, 1).float().numpy()
    res = {"sd": sd}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sparse_enc_packed, "subm_ext_conv", fp32_k2)
        mp.setattr(sparse_enc_packed, "subm_conv", subm_conv_unrounded)
        with torch.no_grad():
            res["fp32"] = cl(enc(x))
        enc.train()
        out = enc(x)
        cot = np.random.RandomState(seed).randn(
            *out.permute(0, 2, 3, 4, 1).shape).astype(np.float32)
        (out * torch.from_numpy(cot).permute(0, 4, 1, 2, 3)).sum().backward()
    res["cot"] = cot
    # the gradients by the state_dict's names (zeros where the port has
    # none: the stem's unused conv and GroupNorm scale, as JAX's)
    grads = {k: p.grad.clone() for k, p in enc.named_parameters()
             if p.grad is not None}
    res["train"] = (cl(out), {k: v.detach().clone()
                              for k, v in enc.state_dict().items()},
                    {k: grads.get(k, torch.zeros_like(v))
                     for k, v in sd.items()})
    enc16 = PackedLiDAREnc8x(4, compute_dtype=torch.bfloat16).eval()
    enc16.load_state_dict(sd)
    with torch.no_grad():
        res["bf16"] = cl(enc16(x))
    return res


@pytest.fixture(scope="module")
def lane_major_runs():
    """{grid name: (JAX's side, the port's side)}; JAX's compiles run in
    threads beside the port's work."""
    out, threads = {}, []
    for i, (name, grid) in enumerate(GRIDS.items()):
        occ = np.random.RandomState(20 + i).rand(2, *grid) < 0.1
        port = _port_side(grid, occ, seed=7 + i)
        out[name] = [None, port]

        def run(name=name, grid=grid, occ=occ, port=port):
            try:
                out[name][0] = _jax_side(grid, _variables(port["sd"]), occ,
                                         port["cot"])
            except BaseException as e:  # re-raised below
                out[name][0] = e
        threads.append(threading.Thread(target=run))
        threads[-1].start()
    for t in threads:
        t.join()
    for j, _ in out.values():
        if isinstance(j, BaseException):
            raise j
    return out


def _close(got, ref, rel, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = np.abs(ref).max()
    assert scale > 0, what
    err = np.abs(got - ref).max()
    assert err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("grid", GRIDS)
def test_fp32_eval_matches_jax_in_every_layout(lane_major_runs, grid, form):
    jax_side, port = lane_major_runs[grid]
    _close(port["fp32"], jax_side[form], 1e-4, form)


@pytest.mark.parametrize("grid", GRIDS)
def test_bf16_eval_within_jax_own_drift(lane_major_runs, grid):
    jax_side, port = lane_major_runs[grid]
    j32, j16, p16 = jax_side["hybrid"], jax_side["bf16"], port["bf16"]
    assert p16.shape == j16.shape
    own = np.abs(j16 - j32) / np.abs(j32).max()
    err = np.abs(p16 - j16) / np.abs(j16).max()
    assert own.max() > 0
    assert err.max() <= 2.0 * own.max(), (err.max(), own.max())
    assert err.mean() <= 1.5 * own.mean(), (err.mean(), own.mean())


@pytest.mark.parametrize("grid", GRIDS)
def test_train_step_matches_jax(lane_major_runs, grid):
    jax_side, port = lane_major_runs[grid]
    jout, jstats, jgrads = jax_side["train"]
    pout, psd, pgrads = port["train"]
    _close(pout, jout, 1e-4, "train output")
    flat_p = dict(jax.tree_util.tree_flatten_with_path(
        _variables(psd)["batch_stats"])[0])
    flat_j = jax.tree_util.tree_flatten_with_path(jstats)[0]
    assert len(flat_j) == len(flat_p) > 10
    for path, ref in flat_j:
        _close(flat_p[path], ref, 1e-4, jax.tree_util.keystr(path))
    pg = dict(jax.tree_util.tree_flatten_with_path(
        _variables(pgrads)["params"])[0])
    flat_g = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat_g) == len(pg)
    for path, ref in flat_g:
        if np.abs(ref).max() == 0:
            assert np.abs(pg[path]).max() == 0, jax.tree_util.keystr(path)
            continue
        _close(pg[path], ref, 1e-3, jax.tree_util.keystr(path))


# Z0: (lanes of res1's SubM, of res2's, res3's and conv_out's; down2's and
# down3's route), the module note's table
ROUTES = {64: ((128, 128, 128), ("packed", "packed")),
          80: ((128, 128, 128), ("packed", "packed")),
          40: ((128, 128, 128), ("packed", "packed")),
          48: ((128, 128, 128), ("packed", "packed")),
          24: ((128, 128, 128), ("packed", "packed")),
          36: ((96, 64, 128), ("lane-major", "lane-major")),
          20: ((64, 64, 128), ("packed", "lane-major")),
          12: ((96, 64, 128), ("lane-major", "lane-major"))}


@pytest.mark.parametrize("z0", ROUTES)
def test_routes_follow_the_grid_depth(monkeypatch, z0):
    """Every SubM of a 128-lane level takes K2's seam and the rest the
    narrow route, and each downsample its layout, at 800 x 800 x Z0 in
    eval and in training (shapes only: the meta device)."""
    lanes, downs = ROUTES[z0]
    calls = []

    def k2(x_pb, w27, p, mcell, bn=None, identity=None):
        calls.append(("k2", x_pb.shape[-1]))
        return torch.empty(x_pb.shape[:-1] + (p * w27.shape[-1],),
                           dtype=x_pb.dtype, device=x_pb.device)

    def k2_train(x_pb, w27, p, mcell):
        return k2(x_pb, w27, p, mcell)

    def narrow(x_pb, w27, p, mcell):
        calls.append(("narrow", x_pb.shape[-1]))
        return torch.empty(x_pb.shape[:-1] + (p * w27.shape[-1],),
                           dtype=x_pb.dtype, device=x_pb.device)

    def down(fn, route):
        def record(*a, **k):
            calls.append((route, None))
            return fn(*a, **k)
        return record
    monkeypatch.setattr(sparse_enc_packed, "subm_ext_conv", k2)
    monkeypatch.setattr(sparse_enc_packed, "subm_conv", k2_train)
    monkeypatch.setattr(sparse_enc_packed, "subm_conv_narrow", narrow)
    monkeypatch.setattr(sparse_enc_packed, "strided_packed_weight",
                        down(sparse_enc_packed.strided_packed_weight,
                             "packed"))
    monkeypatch.setattr(sparse_enc_packed, "strided_weight",
                        down(sparse_enc_packed.strided_weight,
                             "lane-major"))
    with torch.device("meta"):
        enc = PackedLiDAREnc8x(4)
        occ = torch.empty(1, 800, 800, z0, dtype=torch.bool)
    want = [("lane-major", None)]                  # the stem
    for lvl, width in enumerate(lanes):
        route = "k2" if width == 128 else "narrow"
        if lvl:
            want.append((downs[lvl - 1], None))
        want += [(route, width)] * 4
    want.append(("k2", 128))                       # conv_out
    for training in (False, True):
        calls.clear()
        out = enc.train(training)(occ)
        assert calls == want, (training, calls)
        assert tuple(out.shape) == (1, 128, 100, 100, z0 // 2 // 2 // 2)
