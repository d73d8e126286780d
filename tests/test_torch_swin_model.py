"""CoOccRay with the Swin backbone (img_backbone.type="SwinTransformer"),
the port against the JAX package on the CPU, on a tiny twin of the
flagship: window 7, embed 16, depths (2, 2, 1, 1), heads (1, 2, 4, 4), so
that stage 0 pads its 16 x 48 tokens to 21 x 49 under an active shift, as
the flagship's Swin-T pads every stage at 256 x 704.

One set of weights: the port's model is seeded (entry.build_model), its
state_dict goes through JAX's convert_coocc_ray (its convert_swin reads
the port's names) and both sides run synthetic_batch(seed=3).

  * eval, fp32, pts.impl="dense" pinned on both sides: every stop_at prefix
    and the full outputs at atol = rtol = 5e-3 (tests/test_torch_model.py's
    tolerance), and the same refined cells;
  * eval, bf16 (JAX compiled with xla_allow_excess_precision off): each
    prefix's output within 2x (max) and 1.5x (mean) of JAX's own
    bf16-vs-fp32 drift, JAX's dtypes;
  * one train step (the default packed encoder with K2's seam swapped for
    the unrounded conv, dropout off, JAX's cascade priorities) against
    JAX's value_and_grad, at tests/test_torch_train.py's bounds: raw loss
    terms to rtol 1e-4, the outputs the losses read within 1e-3 of their
    scale, the same refined cells, every moved statistic within 1e-3 of
    its scale, the gradients within JAX's own conditioning (per leaf 10x
    JAX's change under a 1e-5 weight perturbation, or 10% of its scale;
    the median leaf within 6%, the 90th percentile within 20%), and the
    backbone's leaves took gradients;
  * state_dict_from_jax round trip of the Swin model (JAX's
    convert_coocc_ray of the port's state_dict back to it unchanged), the
    model's refusal of Swin with stereo LSS.
JAX's three compiles run in threads beside the port's work. Measured:
fp32 prefixes within 1.5e-5 (absolute); bf16 ratios to JAX's own drift
(max, mean) img_voxel 0.67, 0.78, voxel_feats 0.60, 0.44, semantic 0-3
1.18, 0.75 / 0.74, 0.90 / 0.72, 0.82 / 1.52, 1.08, occ 1.06, 0.97,
fine_logits 0.62, 0.86; the train step's outputs within 2.1e-4 of their
scale, its statistics 3.1e-5, its gradients 2.5% at the median leaf and
3.9% at the 90th percentile.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from coocc_tpu.config.base import ImageBackboneConfig as JaxBackboneConfig
from coocc_tpu.data.synthetic import tiny_config as jax_tiny_config
from coocc_tpu.train.convert_torch import convert_coocc_ray

from coocc_tpu_torch.config import get_config
from coocc_tpu_torch.config.base import ImageBackboneConfig
from coocc_tpu_torch.convert import state_dict_from_jax
from coocc_tpu_torch.data.synthetic import tiny_config
from coocc_tpu_torch.entry import FLAGSHIP, build_model
from coocc_tpu_torch.models.coocc_ray import STAGES, CoOccRay
from coocc_tpu_torch.nn.swin import SwinTransformer
from test_torch_model import TOL, _common_fine, _dense, _run_both
from test_torch_train import (OUTPUTS, SEED, _jax_step, _leaf_errors, _np,
                              _port_step, _to_port)
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

SWIN = dict(type="SwinTransformer", embed_dims=16, window_size=7,
            swin_depths=(2, 2, 1, 1), swin_num_heads=(1, 2, 4, 4))


def swin_twin(cfg, backbone_cls):
    """cfg with the tiny Swin backbone and its widths into the neck."""
    return dataclasses.replace(
        cfg, img_backbone=backbone_cls(**SWIN),
        img_neck=dataclasses.replace(cfg.img_neck,
                                     in_channels=(16, 32, 64, 128)))


def _configs():
    return (swin_twin(jax_tiny_config(), JaxBackboneConfig),
            swin_twin(tiny_config(), ImageBackboneConfig))


def _train_side(jcfg, cfg, sd):
    """JAX's fp32 step and its yardstick (the gradient with the weights
    perturbed by 1e-5 relative, twice) -> (raw, outs, port-named grads and
    statistics, [perturbed port-named grads])."""
    variables = convert_coocc_ray({k: v.numpy() for k, v in sd.items()},
                                  jcfg)
    raw, outs, grads, stats, fn = _jax_step(jcfg, variables, False)
    noise = []
    rs = np.random.RandomState(0)
    for _ in range(2):
        pert = jax.tree.map(lambda p: p * (1 + 1e-5 * rs.choice(
            [-1, 1], size=np.shape(p)).astype(np.float32)),
            variables["params"])
        _, g = fn(pert, variables["batch_stats"])
        noise.append(_to_port(g, stats, cfg))
    return (raw, outs, _to_port(grads, stats, cfg)), noise


@pytest.fixture(scope="module")
def runs():
    """{"fp32", "bf16": _run_both's prefixes (dense pinned), "train":
    (the port's step, JAX's, the yardstick), "sd"}."""
    jcfg, cfg = _configs()
    sd = build_model(cfg, "cpu", seed=SEED).state_dict()
    n = int(np.prod(jcfg.lss_grid_size))
    prio = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 2), 0),
        (n,))))[None]
    stops = STAGES + (None,)
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(3) as pool:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        jobs = {"fp32": pool.submit(_run_both, _dense(jcfg), _dense(cfg),
                                    stops, True),
                "bf16": pool.submit(_run_both, _dense(jcfg), _dense(cfg),
                                    stops, True, True),
                "train": pool.submit(_train_side, jcfg, cfg, sd)}
        port = _port_step(cfg, sd, prio, None, True)
        out = {k: j.result() for k, j in jobs.items()}
    jax_step, noise = out["train"]
    out["train"] = (port, jax_step, noise)
    out["sd"] = sd
    return out


def test_twin_builds_swin_and_its_neck_reads_swin_widths():
    _, cfg = _configs()
    model = CoOccRay(cfg)
    assert type(model.img_backbone) is SwinTransformer
    assert model.img_backbone.out_channels == [16, 32, 64, 128]
    assert [d[0].in_channels for d in model.img_neck.deblocks] \
        == [16, 32, 64, 128]


@pytest.mark.parametrize("stop", STAGES)
def test_fp32_prefix_matches_jax(runs, stop):
    j, t = runs["fp32"][stop]
    assert set(t) == set(j)
    for key in j:
        pairs = zip(j[key], t[key]) if key == "semantic" \
            else [(j[key], t[key])]
        for a, b in pairs:
            assert a.shape == b.shape, key
            assert np.abs(b).max() > 0, f"{key} is all zero"
            np.testing.assert_allclose(b, a, err_msg=f"{stop}/{key}", **TOL)


def test_fp32_full_outputs_match_jax(runs):
    j, t = runs["fp32"][None]
    np.testing.assert_allclose(t["occ"], j["occ"], **TOL)
    np.testing.assert_array_equal(t["fine_valid"], j["fine_valid"])
    np.testing.assert_array_equal(t["fine_coords"], j["fine_coords"])
    got, ref = _common_fine(t, j)
    np.testing.assert_allclose(got, ref, **TOL)


def _bf16_cases():
    return [("img", "img_voxel", None), ("pts", "pts_voxel", None),
            ("fuse", "voxel_feats", None)] \
        + [("sem", "semantic", i) for i in range(4)] \
        + [("coarse", "occ", None), (None, "fine_logits", None)]


@pytest.mark.parametrize("stop,key,level", _bf16_cases())
def test_bf16_prefix_within_jax_own_drift(runs, stop, key, level):
    jb, tb = runs["bf16"][stop]
    jf = runs["fp32"][stop][0]
    if key == "fine_logits":
        tb, jb, jf = _common_fine(tb, jb, jf)
    else:
        tb, jb, jf = tb[key], jb[key], jf[key]
        if level is not None:
            tb, jb, jf = tb[level], jb[level], jf[level]
    assert tb.shape == jb.shape == jf.shape
    port, own = np.abs(tb - jb), np.abs(jb - jf)
    assert own.max() > 0
    assert port.max() <= 2.0 * own.max(), (port.max(), own.max())
    assert port.mean() <= 1.5 * own.mean(), (port.mean(), own.mean())


@pytest.mark.parametrize("stop", STAGES + (None,))
def test_bf16_prefix_dtypes_match_jax(runs, stop):
    dtypes = runs["bf16"]["dtypes"][stop]
    assert dtypes
    for key, (jd, td) in dtypes.items():
        assert jd == td, (stop, key)


def test_train_step_losses_outputs_and_cells_match_jax(runs):
    (raw, outs, _, _), (jraw, jouts, _), _ = runs["train"]
    assert set(raw) == set(jraw)
    for k in jraw:
        np.testing.assert_allclose(_np(raw[k]), _np(jraw[k]), rtol=1e-4,
                                   err_msg=k)
    for key in OUTPUTS:
        ref, got = _np(jouts[key]), _np(outs[key])
        assert got.shape == ref.shape, key
        scale = np.abs(ref).max()
        assert scale > 0, key
        assert np.abs(got - ref).max() <= 1e-3 * scale, key
    np.testing.assert_array_equal(outs["fine_coords"].numpy(),
                                  np.asarray(jouts["fine_coords"]))


def test_train_step_statistics_match_jax(runs):
    (_, _, _, stats), (_, _, ref), _ = runs["train"]
    assert len(stats) > 100
    for k, v in stats.items():
        r = ref[k].numpy()
        assert np.abs(v.numpy() - r).max() <= 1e-3 * np.abs(r).max(), k
        assert not np.array_equal(v.numpy(), runs["sd"][k].numpy()), k


def test_train_step_gradients_within_jax_own_conditioning(runs):
    (_, _, grads, _), (_, _, ref), noise = runs["train"]
    errs = _leaf_errors(grads, ref)
    yard = {k: max(float(np.abs(n[k].numpy() - ref[k].numpy()).max())
                   for n in noise) for k in errs}
    bad = [(k, e / max(s, 1e-30), yard[k] / max(s, 1e-30))
           for k, (e, s) in errs.items() if e > max(10 * yard[k], 0.1 * s)]
    assert not bad, bad
    rel = np.array([e / s for e, s in errs.values() if s > 0])
    assert np.median(rel) <= 0.06, np.median(rel)
    assert np.quantile(rel, 0.9) <= 0.2, np.quantile(rel, 0.9)
    swin = [k for k, (e, s) in errs.items()
            if k.startswith("img_backbone") and s > 0]
    assert len(swin) >= 60, "the backbone's parameters took gradients"


def test_state_dict_round_trips_through_jax(runs):
    jcfg, cfg = _configs()
    sd = runs["sd"]
    back = state_dict_from_jax(convert_coocc_ray(
        {k: v.numpy() for k, v in sd.items()}, jcfg), cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_swin_refuses_stereo_lss():
    cfg = get_config(FLAGSHIP + "_stereo")
    cfg = dataclasses.replace(cfg, img_backbone=ImageBackboneConfig(
        type="SwinTransformer"))
    with pytest.raises(ValueError, match="stereo"):
        CoOccRay(cfg)
