"""Training on the LiDAR encoder's other routes, against the JAX package on
the CPU (tiny shapes).

(a) One train step of the tiny flagship on pts.impl 'gather' (the
    gather-GEMM SparseLiDAREnc8x; its voxel cap binds at the first strided
    level) and on 'dense' (DenseLiDAREnc8x: the masked BatchNorm over each
    level's active cells, the level-0 collapse), and of the tiny
    coocc_lidar twin on 'gather' (SparseEncoderHD's rulebook form), each
    against JAX's `value_and_grad` of the same loss from one set of
    weights, at tests/test_torch_train.py's bounds: the raw loss terms to
    rtol 1e-4, the outputs the losses read within 1e-3 of their scale, the
    same refined cells, every moved statistic within 1e-3 of its scale
    (and moved), and the gradients within JAX's own conditioning (per leaf
    10x JAX's change under a 1e-5 weight perturbation, or 10% of the
    leaf's scale; the median leaf within 6%, the 90th percentile within
    20%). Dropout is off on both sides; the cascade reads JAX's priorities.
(b) The gather encoder's data-parallel step: `SparseLiDAREnc8x` in
    training on 2 gloo ranks (each on its own sample, the masked
    BatchNorms synced by `bn_sync_group`) against JAX's under `shard_map`
    on 2 CPU devices with `bn_sync_axis` (its MaskedBatchNorm psums n and
    the sums): each rank's output within 1e-4 of its scale, the moved
    statistics (equal on both ranks) and the ranks' mean gradient (JAX's
    pmean) within 1e-3 of each one's scale - and the synced statistics
    differ from each rank's own.
(c) The dense twin's train step in bf16 (ROADMAP C13): DenseLiDAREnc8x
    with compute_dtype=bfloat16 in training, the gradient of sum(out *
    cot), against JAX's `value_and_grad` of the same (compiled with
    xla_allow_excess_precision off). Its first BatchNorm reads the bf16
    stem and takes bf16 sums, means and variances, as JAX's
    MaskedBatchNorm does; held at (a)'s bounds: the output and every moved
    statistic within 1e-3 of their scale, each gradient leaf within 10%
    of its scale, the median leaf within 6%, the 90th percentile within
    20% (measured: output 5.2e-6; the largest gradient departure 1.5%, on
    the stem GroupNorm's bias, JAX's backward rounding each op to bf16).
JAX's compiles run in threads beside the port's steps.
"""
from concurrent.futures import ThreadPoolExecutor

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from coocc_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from coocc_tpu.data.synthetic import tiny_config as jax_tiny_config
from coocc_tpu.losses import ssc as jax_ssc
from coocc_tpu.models.coocc_ray import CoOccRay as JaxCoOccRay
from coocc_tpu.models.losses import compute_losses as jax_compute_losses
from coocc_tpu.nn.layers import bn_sync_axis
from coocc_tpu.nn.sparse_enc_dense import DenseLiDAREnc8x as JaxDense
from coocc_tpu.nn.sparse_enc import SparseLiDAREnc8x as JaxEnc8x
from coocc_tpu.ops.sparse_conv import SparseTensor as JaxSparseTensor
from coocc_tpu.parallel.mesh import P, make_mesh
from coocc_tpu.train.convert_torch import (ParamTreeBuilder,
                                           convert_coocc_ray,
                                           convert_sparse_enc8x)

from test_torch_configs import lidar_configs
from test_torch_gather_encoders import _voxels
from test_torch_model import _with_impl
from test_torch_train import _leaf_errors, _np, _port_step, _raw, _to_port
from test_torch_train_configs import _jax_bce

from coocc_tpu_torch.data.synthetic import tiny_config
from coocc_tpu_torch.entry import build_model, init_weights
from coocc_tpu_torch.nn.layers import bn_sync_group
from coocc_tpu_torch.nn.sparse_enc import SparseLiDAREnc8x
from coocc_tpu_torch.nn.sparse_enc_dense import DenseLiDAREnc8x
from coocc_tpu_torch.nn.sparse_encoder_hd import SparseEncoderHD
from coocc_tpu_torch.ops.sparse_conv import SparseTensor
from coocc_tpu_torch.parallel.distributed import spawn_ranks
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

SEED, BATCH_SEED = 7, 3


def _configs(name):
    """(JAX's, the port's) tiny config of a route."""
    if name == "lidar_gather":
        return tuple(_with_impl(c, "gather") for c in lidar_configs())
    impl = {"gather": "gather", "dense": "dense"}[name]
    return _with_impl(jax_tiny_config(), impl), _with_impl(tiny_config(),
                                                           impl)


NAMES = ("gather", "dense", "lidar_gather")
ENCODER = {"gather": SparseLiDAREnc8x, "dense": DenseLiDAREnc8x,
           "lidar_gather": SparseEncoderHD}
OUTPUTS = {"gather": ("occ", "fine_logits", "depth_prob", "voxel_feats",
                      "render_depth", "render_rgb"),
           "lidar_gather": ("occ", "voxel_feats", "render_depth")}
OUTPUTS["dense"] = OUTPUTS["gather"]


def _jax_side(name, jcfg, cfg, variables):
    """JAX's fp32 value_and_grad of the train loss (dropout off) and its
    yardstick (the same with the weights perturbed by 1e-5 relative,
    twice) -> (raw terms, outputs, port-named grads and statistics,
    [port-named grads perturbed])."""
    batch = jax.tree.map(lambda x: None if x is None else jnp.asarray(x),
                         jax_synthetic_batch(jcfg, batch_size=1,
                                             seed=BATCH_SEED),
                         is_leaf=lambda x: x is None)
    model = JaxCoOccRay(cfg=jcfg)
    rng = jax.random.PRNGKey(0)
    keep = OUTPUTS[name] + ("fine_coords", "fine_valid")

    def loss_fn(params, stats):
        outs, mutated = model.apply(
            {"params": params, "batch_stats": stats}, batch, train=True,
            fine_rng=jax.random.fold_in(rng, 2),
            rngs={"dropout": jax.random.fold_in(rng, 1)},
            mutable=["batch_stats"])
        losses = jax_compute_losses(outs, batch, jcfg)
        total = sum(v for k, v in losses.items() if k.startswith("loss"))
        raw = jax_compute_losses(outs, batch, _raw(jcfg))
        return total, (raw, mutated["batch_stats"],
                       {k: outs[k] for k in keep if k in outs})

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, (raw, stats, outs)), grads = fn(variables["params"],
                                        variables["batch_stats"])
    noise = []
    rs = np.random.RandomState(0)
    for _ in range(2):
        pert = jax.tree.map(lambda p: p * (1 + 1e-5 * rs.choice(
            [-1, 1], size=np.shape(p)).astype(np.float32)),
            variables["params"])
        (_, (_, s, _)), g = fn(pert, variables["batch_stats"])
        noise.append(_to_port(g, s, cfg))
    return raw, outs, _to_port(grads, stats, cfg), noise


@pytest.fixture(scope="module")
def steps():
    """{name: {"cfg", "sd", "jax", "noise", "port"}}: JAX's three compiles
    in threads, the port's steps in this one."""
    out = {}
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(3) as pool:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jax_ssc, "_bce", _jax_bce)
        jobs = {}
        for name in NAMES:
            jcfg, cfg = _configs(name)
            sd = build_model(cfg, "cpu", seed=SEED).state_dict()
            variables = convert_coocc_ray(
                {k: v.numpy() for k, v in sd.items()}, jcfg)
            n = int(np.prod(jcfg.lss_grid_size))
            prio = torch.from_numpy(np.array(jax.random.uniform(
                jax.random.fold_in(jax.random.fold_in(
                    jax.random.PRNGKey(0), 2), 0), (n,))))[None]
            out[name] = {"cfg": cfg, "sd": sd, "prio": prio}
            jobs[name] = pool.submit(_jax_side, name, jcfg, cfg, variables)
        for name in NAMES:
            o = out[name]
            model = build_model(o["cfg"], "cpu")
            assert type(model.pts_middle_encoder) is ENCODER[name]
            o["port"] = _port_step(o["cfg"], o["sd"], o["prio"], None, False)
        for name in NAMES:
            raw, outs, ported, noise = jobs[name].result()
            out[name].update(jax=(raw, outs, ported), noise=noise)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_raw_loss_terms_match_jax(steps, name):
    raw, jraw = steps[name]["port"][0], steps[name]["jax"][0]
    assert set(raw) == set(jraw)
    for k in jraw:
        np.testing.assert_allclose(_np(raw[k]), _np(jraw[k]), rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_outputs_and_refined_cells_match_jax(steps, name):
    outs, jouts = steps[name]["port"][1], steps[name]["jax"][1]
    for key in OUTPUTS[name]:
        ref, got = _np(jouts[key]), _np(outs[key])
        assert got.shape == ref.shape, key
        scale = np.abs(ref).max()
        assert scale > 0, key
        assert np.abs(got - ref).max() <= 1e-3 * scale, key
    if "fine_coords" in jouts:
        np.testing.assert_array_equal(outs["fine_coords"].numpy(),
                                      np.asarray(jouts["fine_coords"]))
        np.testing.assert_array_equal(outs["fine_valid"].numpy(),
                                      np.asarray(jouts["fine_valid"]))


@pytest.mark.parametrize("name", NAMES)
def test_moved_statistics_match_jax(steps, name):
    stats, ref = steps[name]["port"][3], steps[name]["jax"][2]
    enc = [k for k in stats if k.startswith("pts_middle_encoder")]
    assert len(enc) >= 30
    for k, v in stats.items():
        r = ref[k].numpy()
        assert np.abs(v.numpy() - r).max() <= 1e-3 * np.abs(r).max(), k
        assert not np.array_equal(v.numpy(), steps[name]["sd"][k].numpy()), k


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax_within_its_own_conditioning(steps, name):
    grads, ref = steps[name]["port"][2], steps[name]["jax"][2]
    errs = _leaf_errors(grads, ref)
    noise = {k: max(float(np.abs(n[k].numpy() - ref[k].numpy()).max())
                    for n in steps[name]["noise"]) for k in errs}
    bad = [(k, e / max(s, 1e-30), noise[k] / max(s, 1e-30))
           for k, (e, s) in errs.items()
           if e > max(10 * noise[k], 0.1 * s)]
    assert not bad, bad
    rel = np.array([e / s for e, s in errs.values() if s > 0])
    assert np.median(rel) <= 0.06, np.median(rel)
    assert np.quantile(rel, 0.9) <= 0.2, np.quantile(rel, 0.9)
    enc = [k for k, (e, s) in errs.items()
           if k.startswith("pts_middle_encoder") and s > 0]
    assert len(enc) >= 20, "the encoder's parameters took gradients"


# ---------------------------------------------------------------------------
# (b) the data-parallel step of the gather encoder
# ---------------------------------------------------------------------------

W, GRID, CAP = 2, (32, 32, 16), 3000


def _dp_inputs():
    ids, feats, mask = _voxels(GRID, B=W)
    enc = init_weights(SparseLiDAREnc8x(4, sparse_shape_xyz=GRID), 9)
    cot = np.random.RandomState(9).randn(W, *(s // 8 for s in GRID),
                                         128).astype(np.float32)
    return (ids.astype(np.int64), feats, mask), enc.state_dict(), cot


def _dp_rank(inputs, sd, cot):
    """One rank: the encoder in training on its sample under the group's
    masked BatchNorms, the gradient of sum(out * cot) averaged over the
    ranks (as the train step averages it). Rank 0 returns the numbers."""
    torch.set_num_threads(2)
    rank, group = dist.get_rank(), dist.group.WORLD
    enc = SparseLiDAREnc8x(4, sparse_shape_xyz=GRID)
    enc.load_state_dict(sd)
    enc.train()
    sp = SparseTensor(*(torch.from_numpy(a[rank:rank + 1]) for a in inputs))
    with bn_sync_group(group):
        out = enc(sp, CAP)
    (out * torch.from_numpy(cot[rank:rank + 1]).permute(
        0, 4, 1, 2, 3)).sum().backward()
    grads = {k: p.grad for k, p in enc.named_parameters()
             if p.grad is not None}
    for g in grads.values():
        dist.all_reduce(g, group=group)
        g /= W
    stats = {k: v for k, v in enc.state_dict().items() if "running" in k}
    # the rank-local statistics, for the check that syncing moved them
    local = SparseLiDAREnc8x(4, sparse_shape_xyz=GRID)
    local.load_state_dict(sd)
    local.train()
    with torch.no_grad():
        local(sp, CAP)
    return {"out": out.detach().permute(0, 2, 3, 4, 1).numpy(),
            "grads": {k: v.numpy() for k, v in grads.items()},
            "stats": {k: v.numpy() for k, v in stats.items()},
            "local": {k: v.numpy() for k, v in local.state_dict().items()
                      if "running" in k}}


def _jax_dp(inputs, variables, cot):
    """JAX's side, composed as make_train_step(mesh=...) composes it
    (coocc_tpu/parallel/train_step.py:66-100): shard_map over
    value_and_grad under bn_sync_axis, the gradients and statistics
    pmean'd. -> (each device's output, statistics, gradients)."""
    mod = JaxEnc8x(input_channel=4, sparse_shape_xyz=GRID, capacity=CAP)
    mesh = make_mesh(W)

    def per_device(params, ids, feats, mask, c):
        sp = JaxSparseTensor(ids, feats, mask)

        def loss(params):
            out, upd = mod.apply({**variables, "params": params}, sp,
                                 train=True, mutable=["batch_stats"])
            return jnp.sum(out * c), (out, upd["batch_stats"])
        with bn_sync_axis("data"):
            (_, (out, stats)), grads = jax.value_and_grad(
                loss, has_aux=True)(params)
        return out, jax.lax.pmean(stats, "data"), jax.lax.pmean(grads,
                                                                "data")
    fn = jax.jit(jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(P(), P("data"), P("data"), P("data"), P("data")),
        out_specs=(P("data"), P(), P()), check_vma=False))
    ids, feats, mask = inputs
    return jax.tree.map(np.asarray, fn(
        variables["params"], jnp.asarray(ids.astype(np.int32)),
        jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(cot)))


@pytest.fixture(scope="module")
def dp():
    inputs, sd, cot = _dp_inputs()
    # copies: pickling a tensor for the ranks moves its storage to shared
    # memory, under any numpy view of it
    b = ParamTreeBuilder()
    convert_sparse_enc8x(b, {f"enc.{k}": v.numpy().copy()
                             for k, v in sd.items()}, "enc", "enc")
    variables = {"params": b.params["enc"],
                 "batch_stats": b.batch_stats["enc"]}
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(_jax_dp, inputs, variables, cot)
        ranks = spawn_ranks(_dp_rank, W, "gloo", (inputs, sd, cot))
        jout, jstats, jgrads = job.result()

    def port_tree(state):
        b = ParamTreeBuilder()
        full = {f"enc.{k}": v for k, v in sd.items()}
        full.update({f"enc.{k}": v for k, v in state.items()})
        convert_sparse_enc8x(b, {k: np.asarray(v) for k, v in full.items()},
                             "enc", "enc")
        return b
    return ranks, (jout, jstats, jgrads), port_tree


def _close(got, ref, rel, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    assert got.shape == ref.shape and scale > 0, what
    assert np.abs(got - ref).max() <= rel * scale, (
        what, np.abs(got - ref).max(), scale)


def test_gather_dp_step_matches_jax_shard_map(dp):
    ranks, (jout, jstats, jgrads), port_tree = dp
    for r, res in enumerate(ranks):
        _close(res["out"][0], jout[r], 1e-4, f"rank {r} output")
    for k in ranks[0]["stats"]:
        np.testing.assert_array_equal(ranks[0]["stats"][k],
                                      ranks[1]["stats"][k])
    flat = jax.tree_util.tree_flatten_with_path
    stats = dict(flat(port_tree(ranks[0]["stats"]).batch_stats["enc"])[0])
    for path, ref in flat(jstats)[0]:
        _close(stats[path], ref, 1e-3, jax.tree_util.keystr(path))
    # zeros where the port's parameter took no gradient (the stem's)
    grads = {k: ranks[0]["grads"].get(k, np.zeros(v.shape, np.float32))
             for k, v in SparseLiDAREnc8x(4, sparse_shape_xyz=GRID)
             .named_parameters()}
    pg = dict(flat(port_tree(grads).params["enc"])[0])
    for path, ref in flat(jgrads)[0]:
        if np.abs(ref).max() == 0:
            continue
        _close(pg[path], ref, 1e-3, jax.tree_util.keystr(path))
    # syncing moved the statistics off each rank's own
    differ = [k for k in ranks[0]["stats"]
              if not np.allclose(ranks[0]["stats"][k], ranks[0]["local"][k],
                                 rtol=1e-4, atol=0)]
    assert len(differ) >= 20, differ



# ---------------------------------------------------------------------------
# (c) the dense twin's bf16 train step (C13)
# ---------------------------------------------------------------------------

DENSE_GRID = (64, 64, 32)


def _enc_tree(sd, state=None):
    """The encoder's port-named state (with `state`'s entries over sd's)
    -> JAX's {"params", "batch_stats"} trees (convert_sparse_enc8x)."""
    full = {f"enc.{k}": v.numpy() for k, v in sd.items()}
    full.update({f"enc.{k}": v.numpy() for k, v in (state or {}).items()})
    b = ParamTreeBuilder()
    convert_sparse_enc8x(b, full, "enc", "enc")
    return {"params": b.params["enc"], "batch_stats": b.batch_stats["enc"]}


def _jax_dense_bf16(variables, occ, cot):
    jenc = JaxDense(input_channel=4, base_channel=16, out_channel=128,
                    sparse_shape_xyz=DENSE_GRID, compute_dtype=jnp.bfloat16)
    c = jnp.asarray(cot.transpose(0, 2, 3, 4, 1))

    def loss(params):
        out, upd = jenc.apply({**variables, "params": params},
                              jnp.asarray(occ), train=True,
                              mutable=["batch_stats"])
        return jnp.sum(out * c), (out, upd["batch_stats"])
    fn = jax.jit(jax.value_and_grad(loss, has_aux=True),
                 compiler_options={"xla_allow_excess_precision": False})
    (_, (out, stats)), grads = fn(variables["params"])
    return jax.tree.map(np.asarray, (out, stats, grads))


@pytest.fixture(scope="module")
def dense_bf16():
    enc = init_weights(DenseLiDAREnc8x(4, 16, 128, torch.bfloat16), 5)
    sd = {k: v.clone() for k, v in enc.state_dict().items()}
    occ = np.random.RandomState(7).rand(1, *DENSE_GRID) < 0.05
    cot = np.random.RandomState(8).randn(
        1, 128, *(s // 8 for s in DENSE_GRID)).astype(np.float32)
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(_jax_dense_bf16, _enc_tree(sd), occ, cot)
        enc.train()
        out = enc(torch.from_numpy(occ))
        (out * torch.from_numpy(cot)).sum().backward()
        ref = job.result()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in enc.named_parameters()}
    stats = {k: v for k, v in enc.state_dict().items() if "running" in k}
    return sd, out.detach(), stats, grads, ref


def test_dense_bf16_step_matches_jax(dense_bf16):
    sd, out, stats, grads, (jout, jstats, jgrads) = dense_bf16
    assert out.dtype == torch.float32
    _close(out.permute(0, 2, 3, 4, 1).numpy(), jout, 1e-3, "output")
    flat = jax.tree_util.tree_flatten_with_path
    moved = dict(flat(_enc_tree(sd, stats)["batch_stats"])[0])
    before = dict(flat(_enc_tree(sd)["batch_stats"])[0])
    for path, ref in flat(jstats)[0]:
        _close(moved[path], ref, 1e-3, jax.tree_util.keystr(path))
        assert not np.array_equal(moved[path], before[path]), path
    pg = dict(flat(_enc_tree(sd, grads)["params"])[0])
    rel = []
    for path, ref in flat(jgrads)[0]:
        scale = np.abs(ref).max()
        if scale == 0:
            continue
        rel.append(np.abs(pg[path] - ref).max() / scale)
        assert rel[-1] <= 0.1, (jax.tree_util.keystr(path), rel[-1])
    assert len(rel) >= 30
    assert np.median(rel) <= 0.06, np.median(rel)
    assert np.quantile(rel, 0.9) <= 0.2, np.quantile(rel, 0.9)
