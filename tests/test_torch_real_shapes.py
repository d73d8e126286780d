"""The port's forward == JAX's at real shapes, fp32 and bf16, and the
committed fingerprints the card is held to (gated, cached), for the
flagship coocc_multi_r50_256x704, for coocc_multi_r101_openoccupancy, for
the LiDAR-only coocc_lidar, for the stereo flagship
coocc_multi_r50_256x704_stereo (the flagship's shapes, the previous
keyframe's 6 images and the BEVStereo depth net at 3 EM rounds), and for
coocc_kitti's img and pts prefixes (one 384x1280 camera through R50 with
KITTI's 3x4 intrinsics, 350,000 points on the 512x512x64 LiDAR grid): its
forward cannot go past them, in JAX nor in the port
(tests/test_torch_kitti.py).

Both packages build the config at its own shapes (the flagship: 6x256x704
images, the 800x800x64 LiDAR grid, the 100x100x8 coarse grid, the
200x200x16 fine grid; OpenOccupancy: 6x896x1600 images through ResNet-101,
the 1024x1024x80 LiDAR grid, the 128x128x10 coarse grid, cascade ratio 4
onto the 512x512x40 grid; both with the eval cap of 20,000 coarse cells;
coocc_lidar: 350,000 points voxelized onto the 800x800x65 grid at the
120,000-voxel eval cap, the HD encoder, SECOND3D and its FPN, the
100x100x8 coarse grid, no cascade) from one state_dict, `parity.numpy_weights(seed=0)`, and run
synthetic_batch(seed=0) on the CPU: the port through the plain versions of
K1 and K2, JAX through its XLA SubM route (no COOCC_PALLAS_SUBM:
interpret-mode Pallas at these shapes would take hours). Each side runs one
full forward per dtype and reads every prefix from it (JAX by
capture_intermediates, the port by forward hooks). JAX's bf16 side is
CoOccRay(cfg, dtype=bfloat16) compiled with xla_allow_excess_precision off,
as tests/test_torch_model.py compiles it.

The gated test writes the config's file in coocc_tpu_torch/parity/ (see
the module note there), caches JAX's outputs in tests/_cache/, and holds
the port: fp32 every prefix within 4% (max) and 1e-3 (mean) of the output's
scale, the bound of the packed encoder's bf16-rounded SubM operands
(tests/test_torch_packed_encoder.py; the port's K2 rounds them, JAX's fp32
XLA route does not), with 95% of the refined cells in common; bf16 within
2x (max) and 1.5x (mean) of JAX's own bf16-vs-fp32 drift at the sampled
elements. That yardstick sees no fp32 difference between the packages,
and for OpenOccupancy (parity.FP32_SLACK) the fp32 sides already differ by
more: its fp32 img_voxel is 5.1e-5 of the scale from JAX's on average, twice
JAX's own bf16 drift there (2.4e-5), because 11 of its 1.53M frustum
points fall in another 0.8 m voxel (XLA's and torch's fp32 geometry round
apart; none at the flagship's 1.0 m voxels) and its depth logits reach
1,092 with these random weights (fp32 port and JAX 0.55 apart at most).
Its bf16 bound adds the CPU port's fp32 distance to JAX's drift. The
file also records the port's own bf16-vs-fp32 drift (`port_own`, the same
distances against the port's fp32 outputs), for reading, not bound: after
the LiDAR encoder the port's fp32 rounds K2's operands to bf16 and JAX's
does not, so the two drifts differ in kind there (img_voxel: 1.00x / 1.22x
of JAX's; voxel_feats 2.04x / 1.26x). Run one config at a time (a rerun
reads JAX's side from the cache):

    COOCC_TORCH_REAL=1 python -m pytest tests/test_torch_real_shapes.py \
        -q -k openoccupancy

The flagship took 202 s wall on 8 Xeon cores (JAX's two compiles and
forwards included) and 8 GB of memory at its peak. OpenOccupancy: JAX's
fp32 forward alone (its compile included) took 262 s and 12.2 GB at its
peak (measured first, in a process of its own); the whole case 825 s and
14.2 GB (ps samples), 252 s and 11.8 GB with JAX's side cached.
coocc_lidar: see `LIDAR_COST`. coocc_kitti's prefixes: 67 s wall with
JAX's side computed (48 s cached), 8 Xeon cores.

The ungated cases check the committed files: their size, their digests
against the weights and batch the port draws here, and the distances they
record.
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
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)

OPENOCC = "coocc_multi_r101_openoccupancy"
LIDAR = "coocc_lidar"
STEREO = "coocc_multi_r50_256x704_stereo"
KITTI = "coocc_kitti"
CONFIGS = (FLAGSHIP, OPENOCC, LIDAR, STEREO, KITTI)
MAX_BYTES = {FLAGSHIP: 1 << 20, OPENOCC: 2 << 20, LIDAR: 1 << 20,
             STEREO: 1 << 20, KITTI: 1 << 20}
IDS = {FLAGSHIP: "", OPENOCC: "openoccupancy-", LIDAR: "lidar-",
       STEREO: "stereo-", KITTI: "kitti-"}
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_cache")
GATE = os.environ.get("COOCC_TORCH_REAL", "") == "1"
DTYPES = {"fp32": None, "bf16": torch.bfloat16}


def _jax_outputs(cfg, model, batch_np, bf16):
    """JAX's full forward of config `cfg` at real shapes, every prefix
    captured on the way, as the port's `parity.capture` names them (fp32
    numpy); for the configs of parity.PREFIX_ONLY that prefix's outputs
    alone."""
    import jax
    import jax.numpy as jnp
    from coocc_tpu.config import get_config as jax_get_config
    from coocc_tpu.models.coocc_ray import CoOccRay as JaxCoOccRay
    from coocc_tpu.train.convert_torch import convert_coocc_ray
    jcfg = jax_get_config(cfg.name)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    if jcfg.lss is not None and jcfg.lss.stereo:
        # JAX's converter has no stereo names (tests/test_torch_stereo.py)
        from coocc_tpu.train import convert_torch
        from test_torch_stereo import _jax_variables, _skip_mono
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(convert_torch, "convert_depthnet",
                       _skip_mono(convert_torch.convert_depthnet))
            variables = _jax_variables(sd, jcfg)
    else:
        variables = convert_coocc_ray(sd, jcfg)
    dtype = jnp.bfloat16 if bf16 else None
    jmodel = JaxCoOccRay(cfg=jcfg, dtype=dtype)
    names = ("img_view_transformer", "pts_middle_encoder", "pts_neck",
             "occ_fuser", "semantic_neck")
    fn = functools.partial(
        jmodel.apply, train=False, mutable=["intermediates"],
        capture_intermediates=lambda m, _: m.name in names)
    jit = functools.partial(
        jax.jit, compiler_options={"xla_allow_excess_precision": False}) \
        if bf16 else jax.jit
    jbatch = jax.tree.map(lambda x: None if x is None else jnp.asarray(x),
                          batch_np, is_leaf=lambda x: x is None)
    stop = parity.PREFIX_ONLY.get(cfg.name)
    if stop is not None:
        outs = jit(functools.partial(jmodel.apply, train=False,
                                     stop_at=stop))(variables, jbatch)
        return {k: np.asarray(v.astype(jnp.float32))
                for k, v in outs.items() if v is not None}
    outs, state = jit(fn)(variables, jbatch)
    cap = {k: v["__call__"][0] for k, v in state["intermediates"].items()}
    res = {}
    if "img_view_transformer" in cap:
        res["img_voxel"] = cap["img_view_transformer"][0]
    # after the HD encoder the pts prefix is SECOND3DFPN's output on the
    # (Z, Y, X) conv axes (coocc_ray.py:236); without the fuser the
    # semantic stack reads it
    res["pts_voxel"] = (cap["pts_neck"].transpose(0, 3, 2, 1, 4)
                        if "pts_neck" in cap
                        else cap["pts_middle_encoder"]).astype(
                            dtype or jnp.float32)
    res["voxel_feats"] = cap.get("occ_fuser", res["pts_voxel"])
    for i, t in enumerate(cap["semantic_neck"]):
        res[f"semantic{i}"] = t.transpose(0, 2, 3, 1, 4)
    res.update({k: outs[k] for k in ("occ", "fine_logits", "fine_coords",
                                     "fine_valid", "fine_overflow")
                if k in outs})
    return {k: np.asarray(v.astype(jnp.float32)) if jnp.issubdtype(
        v.dtype, jnp.floating) else np.asarray(v) for k, v in res.items()}


def _cached_jax(cfg, model, batch_np, name, digests):
    tag = "" if cfg.name == FLAGSHIP else f"{cfg.name}_"
    path = os.path.join(CACHE, f"torch_real_jax_{tag}{name}_{digests}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    out = _jax_outputs(cfg, model, batch_np, name == "bf16")
    os.makedirs(CACHE, exist_ok=True)
    np.savez(path, **out)
    return out


@pytest.mark.skipif(not GATE, reason="set COOCC_TORCH_REAL=1 (slow)")
@pytest.mark.parametrize("config", CONFIGS)
def test_real_shapes_match_jax_and_write_the_fingerprint(config):
    """Writes parity.path(config); run one config at a time (-k)."""
    cfg = get_config(config)
    ratio = cfg.occ_head.cascade_ratio
    batch_np = synthetic_batch(cfg, batch_size=1, seed=0)
    batch = batch_np.to("cpu")
    fp = {"batch_digest": np.array(parity.batch_digest(batch_np))}
    runs = {}
    for name, dtype in DTYPES.items():
        model = parity.fingerprint_model(cfg, "cpu", dtype)
        sdig = parity.state_digest(model)
        fp["state_digest"] = np.array(sdig)
        jax_out = _cached_jax(cfg, model, batch_np, name, sdig[:12])
        port_out = parity.capture(model, batch,
                                  parity.PREFIX_ONLY.get(config))
        runs[name] = (jax_out, port_out)
        fp.update(parity.entries(jax_out, port_out, name, ratio))
        del model
    # JAX's own bf16-vs-fp32 drift at the fp32 samples, and the port's,
    # measured the same way against the port's fp32 outputs
    own = parity.distances(fp, "fp32", runs["bf16"][0], ratio)
    port32 = parity.entries(runs["fp32"][1], runs["fp32"][1], "port32",
                            ratio)
    port_own = parity.distances(port32, "port32", runs["bf16"][1], ratio)
    for key, (dmax, dmean) in own.items():
        fp[f"bf16/{key}/own"] = np.array([dmax, dmean])
        fp[f"bf16/{key}/port_own"] = np.array(port_own[key])
    fp.update(_full_drifts(runs))
    np.savez_compressed(parity.path(config), **fp)
    assert os.path.getsize(parity.path(config)) < MAX_BYTES[config]

    cascade = "fp32/cells" in fp
    for key in parity.outputs_of(runs["fp32"][0]) + (
            ("fine_logits",) if cascade else ()):
        dmax, dmean = fp[f"fp32/{key}/port"]
        assert dmax <= 4e-2 and dmean <= 1e-3, (key, dmax, dmean)
    assert not cascade or fp["fp32/cells/port"][0] <= 0.05
    _bf16_holds(fp, config)


def _full_drifts(runs):
    """Over every element of each output: (max, mean) of |port bf16 - JAX
    bf16| relative to JAX bf16's max |x| ("bf16/<key>/port_full") and of
    JAX's own |bf16 - fp32| relative to JAX fp32's ("bf16/<key>/own_full"),
    the readings the tiny-shape tests hold."""
    (j32, _), (j16, p16) = runs["fp32"], runs["bf16"]
    fp = {}
    for key in parity.outputs_of(j32):
        own = np.abs(j16[key] - j32[key]) / np.abs(j32[key]).max()
        port = np.abs(p16[key] - j16[key]) / np.abs(j16[key]).max()
        fp[f"bf16/{key}/own_full"] = np.array([own.max(), own.mean()])
        fp[f"bf16/{key}/port_full"] = np.array([port.max(), port.mean()])
    return fp


def _bf16_holds(fp, config):
    """The bf16 port against JAX's bf16: within 2x (max) and 1.5x (mean)
    of JAX's own bf16-vs-fp32 drift, plus, for the configs in
    parity.FP32_SLACK, the CPU port's fp32 distance to JAX (the triangle |p16 - j16| <=
    |p16 - p32| + |p32 - j32| + |j32 - j16|, with the port's own drift as
    large as JAX's). Over every element where the fingerprint records it
    ("_full", the tiny-shape tests' reading; fingerprints written since
    coocc_kitti's), else at JAX bf16's samples. A heavy-tailed output
    makes the sampled max a draw: coocc_kitti's bf16 img_voxel reads 2.38x
    JAX's own max at the 2,048 samples and 0.47x over all 33.5M elements
    (mean 0.96x and 0.91x)."""
    for key in _outputs(fp):
        full = "_full" if f"bf16/{key}/own_full" in fp else ""
        pmax, pmean = fp[f"bf16/{key}/port{full}"]
        omax, omean = fp[f"bf16/{key}/own{full}"]
        fmax, fmean = fp[f"fp32/{key}/port"] \
            if config in parity.FP32_SLACK else (0.0, 0.0)
        assert pmax <= 2.0 * omax + fmax and pmean <= 1.5 * omean + fmean, \
            (key, pmax, omax, fmax, pmean, omean, fmean)


def _outputs(fp):
    """The OUTPUTS a fingerprint holds."""
    return tuple(k for k in parity.OUTPUTS if f"fp32/{k}/val" in fp)


def _fingerprint(config):
    assert os.path.exists(parity.path(config)), \
        "run the gated test to write it"
    return parity.load(config)


def _small_and_complete(config):
    fp = _fingerprint(config)
    assert os.path.getsize(parity.path(config)) < MAX_BYTES[config]
    cfg = get_config(config)
    ratio = cfg.occ_head.cascade_ratio
    for prefix in DTYPES:
        for key in _outputs(fp):
            assert fp[f"{prefix}/{key}/val"].shape == (parity.N_SAMPLE,)
            assert np.isfinite(fp[f"{prefix}/{key}/val"]).all()
        if config in parity.PREFIX_ONLY:
            # the img and pts prefixes: no argmax, no cascade
            assert _outputs(fp) == ("img_voxel", "pts_voxel")
            assert not any(k.startswith((f"{prefix}/argmax",
                                         f"{prefix}/cells")) for k in fp)
            continue
        if not cfg.use_camera:
            # the LiDAR-only model: no image branch, no cascade
            assert _outputs(fp) == parity.OUTPUTS[1:]
            assert not any(k.startswith((f"{prefix}/cells",
                                         f"{prefix}/fine")) for k in fp)
            continue
        assert fp[f"{prefix}/cells"].shape == (
            cfg.occ_head.max_coarse_occupied, 3)
        coords = fp[f"{prefix}/fine/coords"]
        assert fp[f"{prefix}/fine/val"].shape == (parity.N_FINE_ROWS,
                                                  cfg.num_classes)
        # the sampled rows are whole child blocks of refined cells
        blocks = coords.reshape(-1, ratio ** 3, 3)
        assert (blocks // ratio == blocks[:, :1] // ratio).all()
        assert {tuple(c) for c in (blocks[:, 0] // ratio).tolist()} <= {
            tuple(c) for c in fp[f"{prefix}/cells"].tolist()}


def test_fingerprint_is_small_and_complete():
    _small_and_complete(FLAGSHIP)


def test_openocc_fingerprint_is_small_and_complete():
    _small_and_complete(OPENOCC)


def test_lidar_fingerprint_is_small_and_complete():
    _small_and_complete(LIDAR)


def test_stereo_fingerprint_is_small_and_complete():
    _small_and_complete(STEREO)


def test_kitti_fingerprint_is_small_and_complete():
    _small_and_complete(KITTI)


def _digests_match(config):
    """The weights come from numpy (parity.numpy_weights), so any torch
    version draws these bits; the card checks the same digests first."""
    fp = _fingerprint(config)
    cfg = get_config(config)
    assert parity.batch_digest(synthetic_batch(cfg, batch_size=1, seed=0)) \
        == str(fp["batch_digest"])
    model = parity.fingerprint_model(cfg, "cpu")
    assert parity.state_digest(model) == str(fp["state_digest"])


def test_fingerprint_digests_match_the_ports_weights_and_batch():
    _digests_match(FLAGSHIP)


def test_openocc_fingerprint_digests_match_the_ports_weights_and_batch():
    _digests_match(OPENOCC)


def test_lidar_fingerprint_digests_match_the_ports_weights_and_batch():
    _digests_match(LIDAR)


def test_stereo_fingerprint_digests_match_the_ports_weights_and_batch():
    _digests_match(STEREO)


def test_kitti_fingerprint_digests_match_the_ports_weights_and_batch():
    """The batch's digest covers KITTI's 3x4 intrinsics."""
    _digests_match(KITTI)


@pytest.mark.parametrize("config,prefix", [
    pytest.param(config, prefix, id=f"{IDS[config]}{prefix}")
    for config in CONFIGS for prefix in DTYPES])
def test_recorded_distances_hold_their_bounds(config, prefix):
    """The CPU port's recorded distances: fp32 within the packed encoder's
    bf16 bound; bf16 as `_bf16_holds` says."""
    fp = _fingerprint(config)
    for key in _outputs(fp):
        dmax, dmean = fp[f"{prefix}/{key}/port"]
        if prefix == "fp32":
            assert dmax <= 4e-2 and dmean <= 1e-3, (key, dmax, dmean)
    if prefix == "bf16":
        _bf16_holds(fp, config)
