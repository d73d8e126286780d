"""The port's eval forward == the JAX CoOccRay, stage by stage (tiny config).

One set of weights: the port's model is seeded, its state_dict goes through
the JAX package's convert_coocc_ray, and both sides run
synthetic_batch(tiny_config, seed=3). Each `stop_at` prefix (img, pts, fuse,
sem, coarse) and the full outputs are compared at atol=rtol=5e-3 (the
tolerance of test_golden_full_model.py; fp32 on both sides, sums in other
orders). The cascade runs once at the tiny config's own cap (512 coarse
cells, fewer than are occupied, so the id-order cap is exercised) and once
uncapped. The JAX side runs once per module (module-scoped fixtures), as
four jitted prefixes: pts, fuse, sem and the full forward.
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
from coocc_tpu_torch.models.coocc_ray import STAGES

TOL = dict(atol=5e-3, rtol=5e-3)


def _uncapped(cfg):
    n_coarse = int(np.prod([s // 2 for s in cfg.occ_size]))
    return dataclasses.replace(cfg, occ_head=dataclasses.replace(
        cfg.occ_head, max_coarse_occupied=n_coarse))


def _run_both(jax_cfg, torch_cfg, stops):
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
            j = jax.jit(functools.partial(jmodel.apply, train=False,
                                          stop_at=stop))(variables, jbatch)
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
    return _run_both(jax_tiny_config(), tiny_config(), STAGES + (None,))


@pytest.fixture(scope="module")
def uncapped():
    return _run_both(_uncapped(jax_tiny_config()), _uncapped(tiny_config()),
                     (None,))


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
