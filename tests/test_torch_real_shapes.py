"""The port's flagship forward == JAX's at real shapes, fp32 and bf16, and
the committed fingerprint the card is held to (gated, cached).

Both packages build coocc_multi_r50_256x704 at its own shapes (6x256x704
images, the 800x800x64 LiDAR grid, the 100x100x8 coarse grid, the
200x200x16 fine grid with the eval cap of 20,000) from one state_dict,
`parity.numpy_weights(seed=0)`, and run synthetic_batch(seed=0) on the CPU:
the port through the plain versions of K1 and K2, JAX through its XLA SubM
route (no COOCC_PALLAS_SUBM: interpret-mode Pallas at these shapes would
take hours). Each side runs one full forward per dtype and reads every
prefix from it (JAX by capture_intermediates, the port by forward hooks).
JAX's bf16 side is CoOccRay(cfg, dtype=bfloat16) compiled with
xla_allow_excess_precision off, as tests/test_torch_model.py compiles it.

The gated test writes coocc_tpu_torch/parity/flagship_real.npz (see the
module note there), caches JAX's outputs in tests/_cache/, and holds the
port: fp32 every prefix within 4% (max) and 1e-3 (mean) of the output's
scale, the bound of the packed encoder's bf16-rounded SubM operands
(tests/test_torch_packed_encoder.py; the port's K2 rounds them, JAX's fp32
XLA route does not), with 95% of the refined cells in common; bf16 within
2x (max) and 1.5x (mean) of JAX's own bf16-vs-fp32 drift at the sampled
elements. Run (202 s wall on 8 Xeon cores, JAX's two compiles and
forwards included, 8 GB of memory at its peak; a rerun reads JAX's side
from the cache):

    COOCC_TORCH_REAL=1 python -m pytest tests/test_torch_real_shapes.py -q

The ungated cases check the committed file: its size, its digests against
the weights and batch the port draws here, and the distances it records.
"""
import functools
import os

import numpy as np
import pytest
import torch

from coocc_tpu_torch import parity
from coocc_tpu_torch.config import get_config
from coocc_tpu_torch.data.synthetic import synthetic_batch
from coocc_tpu_torch.entry import FLAGSHIP

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_cache")
GATE = os.environ.get("COOCC_TORCH_REAL", "") == "1"
DTYPES = {"fp32": None, "bf16": torch.bfloat16}


def _jax_outputs(cfg, model, batch_np, bf16):
    """JAX's full forward at real shapes, every prefix captured on the way,
    as the port's `parity.capture` names them (fp32 numpy)."""
    import jax
    import jax.numpy as jnp
    from coocc_tpu.config import get_config as jax_get_config
    from coocc_tpu.models.coocc_ray import CoOccRay as JaxCoOccRay
    from coocc_tpu.train.convert_torch import convert_coocc_ray
    jcfg = jax_get_config(FLAGSHIP)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = convert_coocc_ray(sd, jcfg)
    dtype = jnp.bfloat16 if bf16 else None
    jmodel = JaxCoOccRay(cfg=jcfg, dtype=dtype)
    names = ("img_view_transformer", "pts_middle_encoder", "occ_fuser",
             "semantic_neck")
    fn = functools.partial(
        jmodel.apply, train=False, mutable=["intermediates"],
        capture_intermediates=lambda m, _: m.name in names)
    jit = functools.partial(
        jax.jit, compiler_options={"xla_allow_excess_precision": False}) \
        if bf16 else jax.jit
    jbatch = jax.tree.map(lambda x: None if x is None else jnp.asarray(x),
                          batch_np, is_leaf=lambda x: x is None)
    outs, state = jit(fn)(variables, jbatch)
    cap = {k: v["__call__"][0] for k, v in state["intermediates"].items()}
    res = {"img_voxel": cap["img_view_transformer"][0],
           "pts_voxel": cap["pts_middle_encoder"].astype(
               dtype or jnp.float32),
           "voxel_feats": cap["occ_fuser"]}
    for i, t in enumerate(cap["semantic_neck"]):
        res[f"semantic{i}"] = t.transpose(0, 2, 3, 1, 4)
    res.update({k: outs[k] for k in ("occ", "fine_logits", "fine_coords",
                                     "fine_valid", "fine_overflow")})
    return {k: np.asarray(v.astype(jnp.float32)) if jnp.issubdtype(
        v.dtype, jnp.floating) else np.asarray(v) for k, v in res.items()}


def _cached_jax(cfg, model, batch_np, name, digests):
    path = os.path.join(CACHE, f"torch_real_jax_{name}_{digests}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    out = _jax_outputs(cfg, model, batch_np, name == "bf16")
    os.makedirs(CACHE, exist_ok=True)
    np.savez(path, **out)
    return out


@pytest.mark.skipif(not GATE, reason="set COOCC_TORCH_REAL=1 (slow)")
def test_real_shapes_match_jax_and_write_the_fingerprint():
    cfg = get_config(FLAGSHIP)
    batch_np = synthetic_batch(cfg, batch_size=1, seed=0)
    batch = batch_np.to("cpu")
    fp = {"batch_digest": np.array(parity.batch_digest(batch_np))}
    runs = {}
    for name, dtype in DTYPES.items():
        model = parity.fingerprint_model(cfg, "cpu", dtype)
        sdig = parity.state_digest(model)
        fp["state_digest"] = np.array(sdig)
        jax_out = _cached_jax(cfg, model, batch_np, name, sdig[:12])
        port_out = parity.capture(model, batch)
        runs[name] = (jax_out, port_out)
        fp.update(parity.entries(jax_out, port_out, name))
        del model
    # JAX's own bf16-vs-fp32 drift at the fp32 samples
    own = parity.distances(fp, "fp32", runs["bf16"][0])
    for key, (dmax, dmean) in own.items():
        fp[f"bf16/{key}/own"] = np.array([dmax, dmean])
    np.savez_compressed(parity.PATH, **fp)
    assert os.path.getsize(parity.PATH) < 1 << 20

    for key in parity.OUTPUTS + ("fine_logits",):
        dmax, dmean = fp[f"fp32/{key}/port"]
        assert dmax <= 4e-2 and dmean <= 1e-3, (key, dmax, dmean)
    assert fp["fp32/cells/port"][0] <= 0.05
    # the bf16 port against JAX's bf16, at JAX bf16's samples, within its
    # own drift from fp32
    for key in parity.OUTPUTS:
        pmax, pmean = fp[f"bf16/{key}/port"]
        omax, omean = fp[f"bf16/{key}/own"]
        assert pmax <= 2.0 * omax and pmean <= 1.5 * omean, \
            (key, pmax, omax, pmean, omean)


def _fingerprint():
    assert os.path.exists(parity.PATH), "run the gated test to write it"
    return parity.load()


def test_fingerprint_is_small_and_complete():
    fp = _fingerprint()
    assert os.path.getsize(parity.PATH) < 1 << 20
    for prefix in DTYPES:
        for key in parity.OUTPUTS:
            assert fp[f"{prefix}/{key}/val"].shape == (parity.N_SAMPLE,)
            assert np.isfinite(fp[f"{prefix}/{key}/val"]).all()
        assert fp[f"{prefix}/cells"].shape == (20000, 3)
        assert fp[f"{prefix}/fine/val"].shape == (8 * parity.N_FINE, 17)


def test_fingerprint_digests_match_the_ports_weights_and_batch():
    """The weights come from numpy (parity.numpy_weights), so any torch
    version draws these bits; the card checks the same digests first."""
    fp = _fingerprint()
    cfg = get_config(FLAGSHIP)
    assert parity.batch_digest(synthetic_batch(cfg, batch_size=1, seed=0)) \
        == str(fp["batch_digest"])
    model = parity.fingerprint_model(cfg, "cpu")
    assert parity.state_digest(model) == str(fp["state_digest"])


@pytest.mark.parametrize("prefix", list(DTYPES))
def test_recorded_distances_hold_their_bounds(prefix):
    """The CPU port's recorded distances: fp32 within the packed encoder's
    bf16 bound; bf16 within 2x (max) / 1.5x (mean) of JAX's own drift."""
    fp = _fingerprint()
    for key in parity.OUTPUTS:
        dmax, dmean = fp[f"{prefix}/{key}/port"]
        if prefix == "fp32":
            assert dmax <= 4e-2 and dmean <= 1e-3, (key, dmax, dmean)
        else:
            omax, omean = fp[f"bf16/{key}/own"]
            assert dmax <= 2.0 * omax and dmean <= 1.5 * omean, key
