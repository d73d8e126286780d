"""Eval-time rendering (render.test_rendering) in the port against the JAX
package at tiny shapes (CPU).

With `render.use_rendering and render.test_rendering` JAX's eval forward
renders every view on the fused voxel features (coocc_tpu/models/
coocc_ray.py:332-352), make_eval_step exposes render_depth and render_rgb
(parallel/train_step.py:138-144), and evaluate scores each view against
the batch's image with numpy PSNR and SSIM (train/loop.py:72-89, 129-131).
Held, on the tiny flagship (rgb and depth) and on the tiny LiDAR-only
model (depth only, on a stride-16 frustum of the cameras' poses), from one
state_dict and synthetic_batch(seed=3):
  * eval_step's render_depth and render_rgb against JAX's make_eval_step:
    fp32 within 1e-3 of each output's scale (K2's seam swapped for the
    fp32 conv, tests/test_torch_configs.py's `_fp32_subm`), bf16 within 2x
    (max) and 1.5x (mean) of JAX's own bf16-vs-fp32 drift (JAX compiled
    with xla_allow_excess_precision off), in JAX's dtypes and shapes, the
    depth inside [0, D] (the renderer's units: its D samples a ray);
  * evaluate's render_PSNR and render_SSIM against JAX's evaluate on the
    same batch (fp32; the LiDAR-only model has neither, on both sides);
  * compute_psnr and compute_ssim equal to JAX's, bit for bit;
  * the test CLI with --test-rendering on the CPU (the flagship's tiny
    twin and the LiDAR-only one), and --render-dir's PNGs where PIL is
    installed.
JAX's four eval-step compiles run in threads beside the port's forwards.
"""
import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from coocc_tpu.data.synthetic import tiny_config as jax_tiny_config
from coocc_tpu.evaluation import render_metrics as jax_render_metrics
from coocc_tpu.models.coocc_ray import CoOccRay as JaxCoOccRay
from coocc_tpu.parallel.train_step import make_eval_step
from coocc_tpu.train.convert_torch import convert_coocc_ray
from coocc_tpu.train.loop import evaluate as jax_evaluate

from test_torch_configs import _fp32_subm, lidar_configs

from coocc_tpu_torch.data.synthetic import synthetic_batch, tiny_config
from coocc_tpu_torch.entry import build_model
from coocc_tpu_torch.evaluation import render_metrics
from coocc_tpu_torch.nn import sparse_enc_packed
from coocc_tpu_torch.parallel.train_step import eval_step
from coocc_tpu_torch.test import __main__ as test_cli
from coocc_tpu_torch.train.loop import evaluate
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

RENDERED = ("render_depth", "render_rgb")


def rendering(cfg):
    """cfg with eval-time rendering on, as `--test-rendering` sets it."""
    return cfg.replace(render=dataclasses.replace(
        cfg.render, use_rendering=True, test_rendering=True))


def _configs(name):
    """(JAX's, the port's) tiny config of `name`, rendering in eval."""
    if name == "flagship":
        pair = (jax_tiny_config(), tiny_config())
    else:
        pair = lidar_configs()
    return tuple(rendering(c) for c in pair)


def _jax_tree(batch):
    return jax.tree.map(lambda x: None if x is None else jnp.asarray(x),
                        batch, is_leaf=lambda x: x is None)


def _jax_eval_step(jcfg, variables, jbatch, bf16):
    """make_eval_step's jitted step, compiled for this batch (with
    xla_allow_excess_precision off in bf16)."""
    model = JaxCoOccRay(cfg=jcfg, dtype=jnp.bfloat16 if bf16 else None)
    step = make_eval_step(model, jcfg)
    opts = {"xla_allow_excess_precision": False} if bf16 else None
    return model, step.lower(variables, jbatch).compile(
        compiler_options=opts)


def _numpy(out):
    return {k: (np.asarray(v.float() if isinstance(v, torch.Tensor)
                           else v.astype(jnp.float32)), str(v.dtype)
                .replace("torch.", "")) for k, v in out.items()
            if k in RENDERED}


@pytest.fixture(scope="module")
def runs():
    """{(model, dtype): (JAX's rendered outputs, the port's)} as (fp32
    numpy, dtype name), and {model: (JAX's evaluate, the port's)} in
    fp32: JAX's four compiles in threads, the port's forwards beside."""
    out, summaries, errors = {}, {}, []
    jobs = []

    def jax_run(name, dtype, jcfg, variables, jbatch):
        try:
            model, step = _jax_eval_step(jcfg, variables, jbatch,
                                         dtype == "bf16")
            out[(name, dtype, "jax")] = _numpy(step(variables, jbatch))
            if dtype == "fp32":
                summaries[(name, "jax")] = jax_evaluate(
                    model, variables, jcfg, iter([jbatch]),
                    eval_step=step)
        except BaseException as e:  # re-raised below
            errors.append(e)

    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("COOCC_PALLAS_SUBM", raising=False)  # JAX's XLA route
        mp.setattr(sparse_enc_packed, "subm_ext_conv", _fp32_subm)
        ports = []
        for name in ("flagship", "lidar"):
            jcfg, cfg = _configs(name)
            for dtype in ("fp32", "bf16"):
                model = build_model(cfg, "cpu", seed=7, dtype=torch.bfloat16
                                    if dtype == "bf16" else None)
                sd = {k: v.numpy() for k, v in model.state_dict().items()}
                variables = convert_coocc_ray(sd, jcfg)
                jbatch = _jax_tree(jax_synthetic_batch(jcfg, batch_size=1,
                                                       seed=3))
                t = threading.Thread(target=jax_run, args=(
                    name, dtype, jcfg, variables, jbatch))
                t.start()
                jobs.append(t)
                ports.append((name, dtype, cfg, model))
        for name, dtype, cfg, model in ports:
            batch = synthetic_batch(cfg, batch_size=1, seed=3).to("cpu")
            res = eval_step(model, batch, cfg)
            out[(name, dtype, "port")] = _numpy(res)
            out[(name, dtype, "hists")] = sorted(k for k in res
                                                  if "hist" in k)
            if dtype == "fp32":
                summaries[(name, "port")] = evaluate(model, cfg,
                                                     iter([batch]))
        for t in jobs:
            t.join()
    if errors:
        raise errors[0]
    return out, summaries


CASES = [("flagship", "render_depth"), ("flagship", "render_rgb"),
         ("lidar", "render_depth")]


@pytest.mark.parametrize("name,key", CASES)
def test_fp32_render_matches_jax(runs, name, key):
    out, _ = runs
    (ref, rdt), (got, gdt) = (out[(name, "fp32", s)][key]
                              for s in ("jax", "port"))
    assert got.shape == ref.shape
    assert gdt == rdt == "float32"
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(got - ref).max()
    assert err <= 1e-3 * scale, (err, scale)


@pytest.mark.parametrize("name,key", CASES)
def test_bf16_render_within_jax_own_drift(runs, name, key):
    out, _ = runs
    (jb, jdt), (tb, tdt) = (out[(name, "bf16", s)][key]
                            for s in ("jax", "port"))
    jf = out[(name, "fp32", "jax")][key][0]
    assert tdt == jdt
    assert tb.shape == jb.shape == jf.shape
    port, own = np.abs(tb - jb), np.abs(jb - jf)
    assert own.max() > 0
    assert port.max() <= 2.0 * own.max(), (port.max(), own.max())
    assert port.mean() <= 1.5 * own.mean(), (port.mean(), own.mean())


@pytest.mark.parametrize("name", ["flagship", "lidar"])
def test_eval_step_renders_every_view(runs, name):
    """[B, N, H, W] depth and [B, N, H, W, 3] rgb (the flagship only) at
    the input size, finite, the depth inside the renderer's units
    (linspace(0, D, D) over its D samples: [0, D]); the hists beside."""
    out, _ = runs
    jcfg, cfg = _configs(name)
    H, W = cfg.data.input_size
    N = cfg.data.num_cams
    got = out[(name, "fp32", "port")]
    assert set(got) == ({"render_depth", "render_rgb"} if name == "flagship"
                        else {"render_depth"})
    assert got["render_depth"][0].shape == (1, N, H, W)
    dbound = cfg.grid.dbound if cfg.use_camera else (2.0, 58.0, 0.5)
    D = len(np.arange(*dbound))
    for dtype in ("fp32", "bf16"):
        depth = out[(name, dtype, "port")]["render_depth"][0]
        assert 0 <= depth.min() and depth.max() <= D, (depth.min(), D)
    if name == "flagship":
        rgb = got["render_rgb"][0]
        assert rgb.shape == (1, N, H, W, 3)
        assert 0 <= rgb.min() and rgb.max() <= 1
    for dtype in ("fp32", "bf16"):
        for v, _ in out[(name, dtype, "port")].values():
            assert np.isfinite(v).all()
    assert {"SC_hist", "SSC_hist"} <= set(out[(name, "fp32", "hists")])


@pytest.mark.parametrize("name", ["flagship", "lidar"])
def test_evaluate_render_scores_match_jax(runs, name):
    _, summaries = runs
    ref, got = summaries[(name, "jax")], summaries[(name, "port")]
    keys = {"render_PSNR", "render_SSIM"}
    if name == "lidar":
        assert not keys & set(ref) and not keys & set(got)
        return
    assert keys <= set(ref) and keys <= set(got)
    for k in sorted(keys):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    assert 0 < got["render_PSNR"] < 100


def test_render_scores_equal_jax_bit_for_bit():
    rs = np.random.RandomState(2)
    a, b = rs.rand(2, 16, 24, 3).astype(np.float32)
    mask = rs.rand(16, 24, 3) > 0.3
    assert render_metrics.compute_psnr(a, b) \
        == jax_render_metrics.compute_psnr(a, b)
    assert render_metrics.compute_psnr(a, b, mask) \
        == jax_render_metrics.compute_psnr(a, b, mask)
    assert render_metrics.compute_psnr(a, a) == float("inf")
    assert render_metrics.compute_ssim(a, b) \
        == jax_render_metrics.compute_ssim(a, b)


@pytest.mark.parametrize("name", ["flagship", "lidar"])
def test_test_cli_renders_on_the_cpu(name, monkeypatch, capsys, tmp_path):
    """`python -m coocc_tpu_torch.test tiny --synthetic --test-rendering
    --device cpu` prints the table with the PSNR and SSIM (the LiDAR-only
    twin, which renders depth only, without them); with --render-dir, a
    [render | image | depth] PNG per view where PIL is installed (the card's
    machine has none: there it raises ImportError)."""
    cfg = _configs(name)[1]
    plain = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, test_rendering=False))
    monkeypatch.setattr(test_cli, "config_by_name", lambda n: plain)
    args = ["cfg", "--synthetic", "--device", "cpu", "--max-steps", "1"]
    try:
        import PIL  # noqa: F401
        args += ["--render-dir", str(tmp_path)]
    except ImportError:
        args += ["--test-rendering"]
    test_cli.main(args)
    text = capsys.readouterr().out
    assert "mIoU" in text
    assert ("PSNR" in text) == (name == "flagship")
    pngs = sorted(os.listdir(tmp_path))
    if "--render-dir" in args and name == "flagship":
        assert pngs == [f"render_0_0_cam{v}.png"
                        for v in range(cfg.data.num_cams)]
    else:
        assert pngs == []
