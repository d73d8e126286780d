"""The port's eval forward == the JAX CoOccRay, stage by stage (tiny config).

One set of weights: the port's model is seeded, its state_dict goes through
the JAX package's convert_coocc_ray, and both sides run
synthetic_batch(tiny_config, seed=3). The JAX side runs once per module
(module-scoped fixtures), as jitted prefixes.

With pts.impl="dense" pinned on both sides (fp32 throughout), each `stop_at`
prefix (img, pts, fuse, sem, coarse) and the full outputs are compared at
atol=rtol=5e-3 (the tolerance of test_golden_full_model.py; sums in other
orders). The cascade runs once at the tiny config's own cap (512 coarse
cells, fewer than are occupied, so the id-order cap is exercised) and once
uncapped. JAX jits four prefixes: pts, fuse, sem and the full forward.

The default pts.impl ("auto", the z-packed encoder) runs on both sides with
its SubM convolutions at bf16 operands and fp32 sums (JAX through its Pallas
kernel in interpret mode, COOCC_PALLAS_SUBM=interpret), for the pts prefix
and the full outputs (one JAX jit: pts_voxel is the encoder's output
captured in the full forward). The full outputs hold at 5e-3.
pts_voxel does not: the encoder's nine bf16-rounded SubM layers turn fp32
summation-order differences into bf16 rounding flips that compound
(tests/test_torch_packed_encoder.py), measured max |diff| 0.87% of max
|pts_voxel| and mean 2.3e-4 of it, with 1% of the elements outside 5e-3.
It is held to the encoder test's bf16 bound (max 4%, mean 1e-3 of the
scale); the fuser and the semantic stack average the noise out again.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coocc_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from coocc_tpu.data.synthetic import tiny_config as jax_tiny_config
from coocc_tpu.models.coocc_ray import CoOccRay as JaxCoOccRay
from coocc_tpu.train.convert_torch import convert_coocc_ray

from coocc_tpu_torch.data.synthetic import synthetic_batch, tiny_config
from coocc_tpu_torch.entry import build_model
from coocc_tpu_torch.models.coocc_ray import STAGES, CoOccRay

TOL = dict(atol=5e-3, rtol=5e-3)


def _uncapped(cfg):
    n_coarse = int(np.prod([s // 2 for s in cfg.occ_size]))
    return dataclasses.replace(cfg, occ_head=dataclasses.replace(
        cfg.occ_head, max_coarse_occupied=n_coarse))


def _with_impl(cfg, impl):
    return dataclasses.replace(cfg, pts=dataclasses.replace(cfg.pts,
                                                            impl=impl))


def _dense(cfg):
    return _with_impl(cfg, "dense")


def _run_both(jax_cfg, torch_cfg, stops, pts_from_full=False):
    model = build_model(torch_cfg, "cpu", seed=7)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = convert_coocc_ray(sd, jax_cfg)
    batch_np = jax_synthetic_batch(jax_cfg, batch_size=1, seed=3)
    jbatch = jax.tree.map(lambda x: None if x is None else jnp.asarray(x),
                          batch_np, is_leaf=lambda x: x is None)
    jmodel = JaxCoOccRay(cfg=jax_cfg)
    tbatch = synthetic_batch(torch_cfg, batch_size=1, seed=3).to("cpu")
    jax_out = {}

    def jax_prefix(stop):
        if stop not in jax_out:
            # jitted: one compile per prefix costs less than eager dispatch
            fn = functools.partial(jmodel.apply, train=False, stop_at=stop)
            if stop is None and pts_from_full:
                # the encoder's output captured on the way through the full
                # forward is the "pts" prefix's pts_voxel: one compile less
                fn = functools.partial(
                    fn, mutable=["intermediates"],
                    capture_intermediates=lambda m, _: m.name ==
                    "pts_middle_encoder")
                j, state = jax.jit(fn)(variables, jbatch)
                enc = state["intermediates"]["pts_middle_encoder"]
                jax_out["pts"] = {"pts_voxel": np.asarray(enc["__call__"][0])}
            else:
                j = jax.jit(fn)(variables, jbatch)
            jax_out[stop] = jax.tree.map(np.asarray, j)
        return jax_out[stop]

    out = {}
    for stop in stops:
        # JAX's "img" output is the img_voxel of its "pts" prefix and its
        # "coarse" output the occ of the full forward (coocc_ray.py:265-271,
        # occ_head.py:264-267): those two stages compile no prefix of their own
        if stop == "img":
            j = {"img_voxel": jax_prefix("pts")["img_voxel"]}
        elif stop == "coarse":
            j = {"occ": jax_prefix(None)["occ"]}
        else:
            j = dict(jax_prefix(stop))
        if stop == "sem":
            # the JAX semantic stack returns its z-batch layout [B, Z, X, Y, C]
            j["semantic"] = [a.transpose(0, 2, 3, 1, 4) for a in j["semantic"]]
        t = model(tbatch, stop_at=stop)
        out[stop] = (j,
                     {k: [x.numpy() for x in v] if isinstance(v, list)
                      else v.numpy() for k, v in t.items()})
    return out


@pytest.fixture(scope="module")
def capped():
    return _run_both(_dense(jax_tiny_config()), _dense(tiny_config()),
                     STAGES + (None,))


@pytest.fixture(scope="module")
def uncapped():
    return _run_both(_dense(_uncapped(jax_tiny_config())),
                     _dense(_uncapped(tiny_config())), (None,))


@pytest.fixture(scope="module")
def packed():
    assert jax_tiny_config().pts.impl == tiny_config().pts.impl == "auto"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("COOCC_PALLAS_SUBM", "interpret")
        return _run_both(jax_tiny_config(), tiny_config(), (None, "pts"),
                         pts_from_full=True)


@pytest.mark.parametrize("stop", STAGES)
def test_stage_matches_jax(capped, stop):
    j, t = capped[stop]
    assert set(t) == set(j)
    for key in j:
        for a, b in zip(np.atleast_1d(j[key]) if key != "semantic"
                        else j[key], t[key] if key == "semantic"
                        else np.atleast_1d(t[key])):
            assert a.shape == b.shape, key
            assert np.abs(b).max() > 0, f"{key} is all zero"
            np.testing.assert_allclose(b, a, err_msg=f"{stop}/{key}", **TOL)


def _fine_by_coord(out):
    return {tuple(c): l for c, l, v in zip(out["fine_coords"][0],
                                           out["fine_logits"][0],
                                           out["fine_valid"][0]) if v}


@pytest.mark.parametrize("which", ["capped", "uncapped"])
def test_full_outputs_match_jax(capped, uncapped, which):
    j, t = (capped if which == "capped" else uncapped)[None]
    np.testing.assert_allclose(t["occ"], j["occ"], **TOL)
    np.testing.assert_array_equal(t["fine_valid"], j["fine_valid"])
    np.testing.assert_array_equal(t["fine_overflow"], j["fine_overflow"])
    got, ref = _fine_by_coord(t), _fine_by_coord(j)
    assert len(ref) > 0 and set(got) == set(ref)
    for c in ref:
        np.testing.assert_allclose(got[c], ref[c], err_msg=str(c), **TOL)
    if which == "capped":
        assert int(j["fine_overflow"][0]) > 0, "the cap was not exercised"


def test_packed_default_pts_matches_jax_kernel_path(packed):
    j, t = packed["pts"]
    ref, got = j["pts_voxel"], t["pts_voxel"]
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(got - ref)
    assert err.max() <= 4e-2 * scale, (err.max(), scale)
    assert err.mean() <= 1e-3 * scale, (err.mean(), scale)


def test_packed_default_full_outputs_match_jax(packed):
    j, t = packed[None]
    np.testing.assert_allclose(t["occ"], j["occ"], **TOL)
    np.testing.assert_array_equal(t["fine_valid"], j["fine_valid"])
    np.testing.assert_array_equal(t["fine_overflow"], j["fine_overflow"])
    got, ref = _fine_by_coord(t), _fine_by_coord(j)
    assert len(ref) > 0 and set(got) == set(ref)
    for c in ref:
        np.testing.assert_allclose(got[c], ref[c], err_msg=str(c), **TOL)


@pytest.mark.parametrize("impl,encoder", [
    ("auto", "PackedLiDAREnc8x"), ("packed", "PackedLiDAREnc8x"),
    ("dense", "DenseLiDAREnc8x"), ("gather", None), ("packed_ztap", None)])
def test_pts_impl_resolves_like_jax(impl, encoder):
    """'auto' is 'packed' for SparseLiDAREnc8x (JAX coocc_ray.py:130-133);
    what is not ported raises."""
    cfg = tiny_config()
    if impl == "packed_ztap":
        cfg = dataclasses.replace(cfg, pts=dataclasses.replace(
            cfg.pts, impl="packed", ztap_levels=(1,)))
    else:
        cfg = _with_impl(cfg, impl)
    if encoder is None:
        with pytest.raises(NotImplementedError):
            CoOccRay(cfg)
    else:
        model = CoOccRay(cfg)
        assert type(model.pts_middle_encoder).__name__ == encoder


def test_batch_of_two_runs_per_sample():
    """B > 1 runs the per-sample steps in a loop: each sample of a B=2 batch
    gives what it gives alone (to 1e-4: batched convolutions sum in another
    order)."""
    cfg = tiny_config()
    model = build_model(cfg, "cpu", seed=7)
    pair = synthetic_batch(cfg, batch_size=2, seed=4).to("cpu")
    both = model(pair)
    # the second sample: an indexing slip in a per-sample loop shows there
    one = model(type(pair)(*(None if a is None else a[1:2] for a in pair)))
    for key, v in one.items():
        np.testing.assert_allclose(both[key][1:2].numpy(), v.numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=key)
