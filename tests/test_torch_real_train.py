"""The flagship's gather route and one of its train steps at real shapes,
against the JAX package (gated, cached), and the committed fingerprints the
card is held to: `coocc_tpu_torch/parity/flagship_gather_real.npz`
(parity.GATHER) and `flagship_train_real.npz` (parity.TRAIN).

Both build coocc_multi_r50_256x704 at its own shapes from the fingerprint
weights (`parity.numpy_weights(seed=0)`) and run synthetic_batch(seed=0),
B = 1, in fp32 and bf16 (JAX's bf16 compiled with
xla_allow_excess_precision off).

GATHER: the flagship with pts.impl="gather" (the gather-GEMM
SparseLiDAREnc8x) to its pts prefix (`stop_at="pts"`). The eval cap of
120,000 sites binds at the first strided level as JAX's does (about 370,000
sites before it). The file holds JAX's pts_voxel as the forward
fingerprints do (a seeded sample, channel sums, scale; `parity.entries`),
the sites each strided level kept, from both packages (`parity.kept_sites`;
equal, the rulebooks being built from integer ids), the CPU port's
distances and JAX's own bf16-vs-fp32 drift. Bounds here: fp32 within 1e-4
(max) and 1e-5 (mean) of the scale (both packages sum fp32 products in
other orders; no bf16 rounding on this route), bf16 by the C9 rule
(`parity.check_drift`).

TRAIN: one train step of the flagship (`parity.train`): dropout off on
both sides, the training cascade's priorities JAX's own draw (stored in
the file), JAX's gradients and moved statistics under the port's names
(`state_dict_from_jax`). The file holds the raw loss terms, samples of the
outputs the losses read and of pts_voxel, of every moved statistic and
every gradient leaf, each one's max |x|, sum and sum of |x|, the refined
cells' digest, the CPU port's distances and JAX's own bf16-vs-fp32 drift
(`parity.train.distances`). The CPU port's fp32 and bf16 steps are held
by the C9 rule (`parity.train.holds` against JAX's own drift: each output
and loss term within 2x, each leaf, statistic and sum within a ceiling of
CEILING x, the leaves and statistics pooled within 1.5x at the median and
2.5x at the 90th percentile; the module note of `parity.train` says what
this cannot see), the fp32 one's refined cells equal to JAX's.

JAX's side runs first, in a process of its own (`python
tests/test_torch_real_train.py <gather|train> <dtype> <path>`, stopped
past COOCC_REAL_MEMORY_GIB, 48 by default), and is cached in
tests/_cache/; the child's peak resident memory is printed. JAX's
full-width value_and_grad peaked at 33.1 GiB (fp32) and 29.1 GiB (bf16)
resident on 8 Xeon cores; its gather prefix at 3.8 and 3.9 GiB. Run one
at a time:

    COOCC_TORCH_REAL=1 python -m pytest tests/test_torch_real_train.py \\
        -q -k gather

The ungated cases check the committed files: their size, their digests
against the weights and batch the port draws here, the recorded distances
within their bounds, the kept sites equal between the packages.
"""
import dataclasses
import functools
import os
import resource
import subprocess
import sys

import numpy as np
import pytest
import torch

from coocc_tpu_torch import parity
from coocc_tpu_torch.data.synthetic import synthetic_batch
from coocc_tpu_torch.parity import train as ptrain
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_cache")
GATE = os.environ.get("COOCC_TORCH_REAL", "") == "1"
DTYPES = {"fp32": None, "bf16": torch.bfloat16}
MAX_BYTES = 1 << 20
GATHER_FP32 = (1e-4, 1e-5)


def _jax_gather(bf16: bool):
    """JAX's pts prefix of the flagship on pts.impl="gather" (fp32 numpy)
    and the sites each strided level kept, [levels, B]."""
    import jax
    import jax.numpy as jnp
    from coocc_tpu.config import get_config as jax_get_config
    from coocc_tpu.models.coocc_ray import CoOccRay as JaxCoOccRay
    from coocc_tpu.train.convert_torch import convert_coocc_ray
    cfg = parity.fingerprint_config(parity.GATHER)
    model = parity.fingerprint_model(cfg, "cpu")
    jcfg = jax_get_config(parity.FLAGSHIP)
    jcfg = dataclasses.replace(jcfg, pts=dataclasses.replace(
        jcfg.pts, impl="gather"))
    variables = convert_coocc_ray(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    del model
    jmodel = JaxCoOccRay(cfg=jcfg, dtype=jnp.bfloat16 if bf16 else None)
    downs = ("down1", "down2", "down3")
    fn = functools.partial(
        jmodel.apply, train=False, stop_at="pts", mutable=["intermediates"],
        capture_intermediates=lambda m, _: m.name in downs)
    jit = functools.partial(
        jax.jit, compiler_options={"xla_allow_excess_precision": False}) \
        if bf16 else jax.jit
    batch = jax.tree.map(
        lambda x: None if x is None else jnp.asarray(x),
        synthetic_batch(cfg, batch_size=1, seed=0),
        is_leaf=lambda x: x is None)
    outs, state = jit(fn)(variables, batch)
    enc = state["intermediates"]["pts_middle_encoder"]
    kept = np.stack([np.asarray(enc[d]["__call__"][0].mask.sum(-1))
                     for d in downs]).astype(np.int64)
    return {"pts_voxel": np.asarray(outs["pts_voxel"].astype(jnp.float32)),
            "kept": kept}


def _watch_memory(limit_gib: float):
    """A daemon thread that reads this process's resident memory every 0.2
    s and ends it (exit 3) past limit_gib: the machine's memory is shared.
    -> a callable giving the peak seen, in GiB."""
    import threading
    import time
    peak = [0.0]

    def rss():
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 2 ** 20
        return 0.0

    def watch():
        while True:
            peak[0] = max(peak[0], rss())
            if peak[0] > limit_gib:
                print(f"resident memory {peak[0]:.1f} GiB is past "
                      f"{limit_gib} GiB: stopped", flush=True)
                os._exit(3)
            time.sleep(0.2)
    threading.Thread(target=watch, daemon=True).start()
    return lambda: max(peak[0], rss())


def _jax_train(bf16: bool):
    """JAX's train step of the flagship (dropout off, the cascade's
    priorities its own draw), as the port's parity.train.step_arrays lays
    it out, flattened to "<group>/<name>" numpy arrays, with the
    priorities and the process's peak resident memory."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    from coocc_tpu.config import get_config as jax_get_config
    from coocc_tpu.models.coocc_ray import CoOccRay as JaxCoOccRay
    from coocc_tpu.models.losses import compute_losses as jax_losses
    from coocc_tpu.train.convert_torch import convert_coocc_ray
    from coocc_tpu_torch.convert import state_dict_from_jax
    from coocc_tpu_torch.parity import train as ptrain
    peak = _watch_memory(float(os.environ.get("COOCC_REAL_MEMORY_GIB",
                                              "48")))
    cfg = parity.fingerprint_config(parity.TRAIN)
    model = parity.fingerprint_model(cfg, "cpu")
    params = [k for k, _ in model.named_parameters()]
    jcfg = jax_get_config(parity.FLAGSHIP)
    variables = convert_coocc_ray(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    del model
    fnn.Dropout.__call__ = lambda self, x, *a, **k: x       # dropout off
    batch = jax.tree.map(
        lambda x: None if x is None else jnp.asarray(x),
        synthetic_batch(cfg, batch_size=1, seed=0),
        is_leaf=lambda x: x is None)
    jmodel = JaxCoOccRay(cfg=jcfg, dtype=jnp.bfloat16 if bf16 else None)
    rng = jax.random.PRNGKey(0)
    raw_cfg = dataclasses.replace(jcfg, loss_norm=False)

    def loss_fn(p, stats):
        outs, mutated = jmodel.apply(
            {"params": p, "batch_stats": stats}, batch, train=True,
            fine_rng=jax.random.fold_in(rng, 2),
            rngs={"dropout": jax.random.fold_in(rng, 1)},
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda m, _: m.name == "pts_middle_encoder")
        losses = jax_losses(outs, batch, jcfg)
        total = sum(v for k, v in losses.items() if k.startswith("loss"))
        keep = {k: outs[k] for k in ptrain.TRAIN_OUTPUTS + ptrain.CASCADE
                if outs.get(k) is not None}
        keep["pts_voxel"] = mutated["intermediates"]["pts_middle_encoder"][
            "__call__"][0]
        return total, (jax_losses(outs, batch, raw_cfg),
                       mutated["batch_stats"], keep)
    jit = functools.partial(
        jax.jit, compiler_options={"xla_allow_excess_precision": False}) \
        if bf16 else jax.jit
    (_, (raw, stats, outs)), grads = jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"],
                                variables["batch_stats"])
    sd = state_dict_from_jax(jax.tree.map(
        np.asarray, {"params": grads, "batch_stats": stats}), cfg)
    n = int(np.prod(jcfg.lss_grid_size))
    res = {"priorities": np.asarray(jax.random.uniform(jax.random.fold_in(
        jax.random.fold_in(rng, 2), 0), (n,)))[None]}
    for k in ptrain.CASCADE:
        v = outs.pop(k)
        res[f"cascade/{k}"] = np.asarray(
            v.astype(jnp.float32) if k == "fine_logits" else v)
    res.update({f"loss/{k}": np.float64(v) for k, v in raw.items()})
    res.update({f"out/{k}": np.asarray(v.astype(jnp.float32))
                for k, v in outs.items()})
    res.update({f"stat/{k}": v.numpy() for k, v in sd.items()
                if "running" in k})
    res.update({f"grad/{k}": sd[k].float().numpy() for k in params})
    res["peak_gib"] = np.float64(peak())
    return res


def _unflat(z):
    """The child's flat arrays -> step_arrays' layout."""
    res = {g: {} for g in ("loss", "cascade") + ptrain.GROUPS}
    for k, v in z.items():
        if "/" in k:
            g, name = k.split("/", 1)
            res[g][name] = float(v) if g == "loss" else v
    return res


JAX_SIDES = {"gather": _jax_gather, "train": _jax_train}


def _cached_jax(kind: str, name: str, digest: str):
    """JAX's side of `kind` in dtype `name`, computed in a child process the
    first time (its peak resident memory printed) and cached."""
    path = os.path.join(CACHE, f"torch_real_{kind}_{name}_{digest}.npz")
    if not os.path.exists(path):
        os.makedirs(CACHE, exist_ok=True)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        subprocess.run([sys.executable, os.path.abspath(__file__), kind,
                        name, path], check=True, timeout=3600, cwd=root,
                       env={**os.environ, "PYTHONPATH": root})
        peak = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
        print(f"JAX's {kind} {name} side: peak resident memory of the "
              f"largest child so far {peak / 2 ** 20:.1f} GiB")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.skipif(not GATE, reason="set COOCC_TORCH_REAL=1 (slow)")
def test_gather_route_matches_jax_and_writes_the_fingerprint():
    """Writes parity.path(parity.GATHER)."""
    cfg = parity.fingerprint_config(parity.GATHER)
    batch_np = synthetic_batch(cfg, batch_size=1, seed=0)
    batch = batch_np.to("cpu")
    fp = {"batch_digest": np.array(parity.batch_digest(batch_np))}
    runs = {}
    for name, dtype in DTYPES.items():
        model = parity.fingerprint_model(cfg, "cpu", dtype)
        sdig = parity.state_digest(model)
        fp["state_digest"] = np.array(sdig)
        jax_out = _cached_jax("gather", name, sdig[:12])
        port_out = parity.capture(model, batch, "pts")
        del model
        runs[name] = (jax_out, port_out)
        fp.update(parity.entries({"pts_voxel": jax_out["pts_voxel"]},
                                 port_out, name, 1))
        fp[f"{name}/kept/jax"] = jax_out["kept"]
        fp[f"{name}/kept/port"] = port_out["kept"]
    own = parity.distances(fp, "fp32", runs["bf16"][0], 1)
    for key, dists in own.items():
        fp[f"bf16/{key}/own"] = np.array(dists)
    np.savez_compressed(parity.path(parity.GATHER), **fp)
    _gather_holds(parity.load(parity.GATHER))


def _gather_holds(fp):
    """The recorded distances within their bounds, the kept sites equal."""
    for key in ("pts_voxel", "pts_voxel_csum"):
        dmax, dmean = fp[f"fp32/{key}/port"]
        assert dmax <= GATHER_FP32[0] and dmean <= GATHER_FP32[1], \
            (key, dmax, dmean)
        pmax, pmean = fp[f"bf16/{key}/port"]
        omax, omean = fp[f"bf16/{key}/own"]
        assert pmax <= max(2.0 * omax, parity.FLOOR_MAX) and \
            pmean <= max(1.5 * omean, parity.FLOOR_MEAN), \
            (key, pmax, omax, pmean, omean)
    for prefix in DTYPES:
        np.testing.assert_array_equal(fp[f"{prefix}/kept/port"],
                                      fp[f"{prefix}/kept/jax"])


@pytest.mark.skipif(not GATE, reason="set COOCC_TORCH_REAL=1 (slow)")
def test_train_step_matches_jax_and_writes_the_fingerprint():
    """Writes parity.path(parity.TRAIN)."""
    cfg = parity.fingerprint_config(parity.TRAIN)
    batch_np = synthetic_batch(cfg, batch_size=1, seed=0)
    batch = batch_np.to("cpu")
    fp = {"batch_digest": np.array(parity.batch_digest(batch_np))}
    jax_res, port_res = {}, {}
    for name, dtype in DTYPES.items():
        model = parity.fingerprint_model(cfg, "cpu", dtype)
        sdig = parity.state_digest(model)
        fp["state_digest"] = np.array(sdig)
        z = _cached_jax("train", name, sdig[:12])
        print(f"JAX's {name} train step: peak resident memory "
              f"{float(z['peak_gib']):.1f} GiB")
        fp.setdefault("priorities", z["priorities"])
        np.testing.assert_array_equal(z["priorities"], fp["priorities"])
        jax_res[name] = _unflat(z)
        del z
        port_res[name] = ptrain.step_arrays(
            model, batch, torch.from_numpy(fp["priorities"]))
        del model
        fp.update(ptrain.entries(jax_res[name], name, fp))
    for name in DTYPES:
        fp[f"{name}/port"] = ptrain.distances(fp, name, port_res[name])
    fp["bf16/own"] = ptrain.distances(fp, "fp32", jax_res["bf16"])
    np.savez_compressed(parity.path(parity.TRAIN), **fp)
    _train_holds(parity.load(parity.TRAIN))


def _train_holds(fp):
    """The CPU port's recorded distances: bf16 by the C9 rule
    (`parity.train.holds` against JAX's own drift), fp32 too, since its
    one bf16 rounding is K2's operands; in fp32 95% of JAX's refined cells
    in common (the training cascade refines predicted cells: K2's rounding
    flips a few coarse argmaxes, as tests/test_torch_real_shapes.py
    bounds it)."""
    names = ptrain.rows(fp)
    for prefix in DTYPES:
        bad = [r for r in ptrain.holds(names, fp[f"{prefix}/port"],
                                       fp["bf16/own"], "bf16") if not r[3]]
        assert not bad, (prefix, bad)
    assert fp["fp32/port"][names.index("cells")][0] <= 0.05


def _fingerprint(name):
    assert os.path.exists(parity.path(name)), \
        "run the gated test to write it"
    return parity.load(name)


def test_gather_fingerprint_is_small_and_complete():
    fp = _fingerprint(parity.GATHER)
    assert os.path.getsize(parity.path(parity.GATHER)) < MAX_BYTES
    cfg = parity.fingerprint_config(parity.GATHER)
    for prefix in DTYPES:
        assert fp[f"{prefix}/pts_voxel/val"].shape == (parity.N_SAMPLE,)
        assert np.isfinite(fp[f"{prefix}/pts_voxel/val"]).all()
        assert not any(k.startswith(f"{prefix}/img_voxel") for k in fp)
        kept = fp[f"{prefix}/kept/jax"]
        # three strided levels of one sample, the first capped
        assert kept.shape == (3, 1)
        assert kept[0, 0] == cfg.pts.max_voxels_test


def test_gather_fingerprint_digests_match_the_ports_weights_and_batch():
    """The gather model draws the packed flagship's weights: the same
    parameters in the same order."""
    fp = _fingerprint(parity.GATHER)
    cfg = parity.fingerprint_config(parity.GATHER)
    assert parity.batch_digest(synthetic_batch(cfg, batch_size=1, seed=0)) \
        == str(fp["batch_digest"])
    model = parity.fingerprint_model(cfg, "cpu")
    assert parity.state_digest(model) == str(fp["state_digest"]) == str(
        parity.load(parity.FLAGSHIP)["state_digest"])


def test_gather_recorded_distances_hold_their_bounds():
    _gather_holds(_fingerprint(parity.GATHER))


def test_train_fingerprint_is_small_and_complete():
    fp = _fingerprint(parity.TRAIN)
    assert os.path.getsize(parity.path(parity.TRAIN)) < MAX_BYTES
    cfg = parity.fingerprint_config(parity.TRAIN)
    assert fp["priorities"].shape == (1, int(np.prod(cfg.lss_grid_size)))
    assert set(fp["out/names"]) == set(ptrain.TRAIN_OUTPUTS)
    names = ptrain.rows(fp)
    for prefix in DTYPES:
        for g in ptrain.GROUPS:
            n = len(fp[f"{g}/names"])
            assert fp[f"{prefix}/{g}/stats"].shape == (n, 3)
            assert fp[f"{prefix}/{g}/val"].shape == fp[f"{g}/idx"].shape
            assert np.isfinite(fp[f"{prefix}/{g}/val"]).all()
        assert np.isfinite(fp[f"{prefix}/loss/val"]).all()
        assert fp[f"{prefix}/port"].shape == (len(names), 2)
        # the refined cells, and whole child blocks of some of them
        assert 0 < len(fp[f"{prefix}/cells"]) <= cfg.occ_head.fine_topk
        assert fp[f"{prefix}/fine/val"].shape == (ptrain.FINE_ROWS,
                                                  cfg.num_classes)
    assert fp["bf16/own"].shape == (len(names), 2)


def test_train_fingerprint_names_every_parameter_and_statistic():
    """Every gradient leaf and moved statistic of the port's flagship, by
    its state_dict name."""
    fp = _fingerprint(parity.TRAIN)
    from coocc_tpu_torch.models.coocc_ray import CoOccRay
    with torch.device("meta"):
        model = CoOccRay(parity.fingerprint_config(parity.TRAIN))
    assert list(fp["grad/names"]) == sorted(
        k for k, _ in model.named_parameters())
    assert list(fp["stat/names"]) == sorted(
        k for k, _ in model.named_buffers() if "running" in k)


def test_train_fingerprint_digests_match_the_ports_weights_and_batch():
    fp = _fingerprint(parity.TRAIN)
    cfg = parity.fingerprint_config(parity.TRAIN)
    assert parity.batch_digest(synthetic_batch(cfg, batch_size=1, seed=0)) \
        == str(fp["batch_digest"])
    assert str(fp["state_digest"]) == str(
        parity.load(parity.FLAGSHIP)["state_digest"])


def test_train_recorded_distances_hold_their_bounds():
    _train_holds(_fingerprint(parity.TRAIN))


def test_train_check_flags_a_wrong_step():
    """`parity.train.holds`: distances of 0 pass the fp32 rule, and every
    gradient leaf's sample off by its whole scale fails it."""
    fp = _fingerprint(parity.TRAIN)
    names = ptrain.rows(fp)
    ref = np.zeros((len(names), 2))
    zero = ptrain.holds(names, ref, fp["fp32/port"], "fp32")
    assert all(r[3] for r in zero)
    got = ref.copy()
    got[[i for i, n in enumerate(names) if n.startswith("grad/")
         and not n.endswith(":sum")], 0] = 1.0
    assert not all(r[3] for r in ptrain.holds(names, got, fp["fp32/port"],
                                              "fp32"))


def _largest(prefix, fp, names, kind):
    """The `kind` row ("stat" sample or "sum") with the largest yardstick
    of the `prefix` rule: the hardest one to catch."""
    ref = fp["fp32/port"] if prefix == "fp32" else fp["bf16/own"]
    rows = [i for i, n in enumerate(names) if n.endswith(":sum")
            == (kind == "sum") and n.startswith(("grad/", "stat/")
                                                if kind == "sum" else "stat/")
            and ref[i, 0] * ptrain.CEILING < 1.0]
    return names[max(rows, key=lambda i: ref[i, 0])]


# planted faults, each confined to one place: a row picked by name (or by
# _largest) and the distance it reads (max, mean): a leaf off by its whole
# scale at the max and half of it on average, a sum off by its sum of |x|
PLANTED = {
    "the LiDAR encoder's leaves": (
        lambda fp, names, prefix: [n for n in names if n.startswith(
            "grad/pts_middle_encoder.") and not n.endswith(":sum")],
        (1.0, 0.5)),
    "the occupancy head's leaves": (
        lambda fp, names, prefix: [n for n in names if n.startswith(
            "grad/pts_bbox_head.") and not n.endswith(":sum")],
        (1.0, 0.5)),
    "one statistic": (
        lambda fp, names, prefix: [_largest(prefix, fp, names, "stat")],
        (1.0, 0.5)),
    "one sum": (
        lambda fp, names, prefix: [_largest(prefix, fp, names, "sum")],
        (1.0, 0.0)),
}


@pytest.mark.parametrize("prefix", DTYPES)
@pytest.mark.parametrize("fault", PLANTED)
def test_train_check_flags_a_fault_in_one_place(fault, prefix):
    """`parity.train.holds` with every row at its yardstick (which holds)
    but one module's gradient leaves, one statistic or one sum (the one
    with the largest yardstick below 1 / CEILING) planted wrong: the rule
    fails, and a row of the planted items is among those it flags (the
    per-item ceiling, not only the pooled quantiles)."""
    fp = _fingerprint(parity.TRAIN)
    names = ptrain.rows(fp)
    ref = fp["fp32/port"] if prefix == "fp32" else fp["bf16/own"]
    assert all(r[3] for r in ptrain.holds(names, ref, ref, prefix))
    pick, dist = PLANTED[fault]
    planted = set(pick(fp, names, prefix))
    got = ref.copy()
    got[[i for i, n in enumerate(names) if n in planted]] = dist
    flagged = {r[0] for r in ptrain.holds(names, got, ref, prefix)
               if not r[3]}
    assert flagged & planted, (fault, prefix, flagged)


def _child(kind, name, path):
    """The child process: JAX's side of `kind` in dtype `name`, saved to
    path."""
    out = JAX_SIDES[kind](name == "bf16")
    np.savez(path, **out)


if __name__ == "__main__":
    import conftest  # noqa: F401 (JAX on the CPU)
    _child(*sys.argv[1:4])
