"""The port's eval metrics == the JAX package's, on the same numpy inputs.

Each function of coocc_tpu_torch/evaluation (and forward_lidarseg) against
its JAX counterpart (coocc_tpu/evaluation/ssc_metrics.py, formatting.py,
nn/occ_head.py:forward_lidarseg), on seeded numpy inputs at the tiny
config's grids (coarse 20x20x4, GT 40x40x8, 17 classes):

  * fast_hist, ssc_summary, lidarseg_hist, cm_to_ious and the table lines:
    equal;
  * occupancy_hists in fp32 and in bf16, with and without extra_mask:
    equal. The port's resize_logits is JAX's resize_linear op for op
    (its integer-ratio blends in the logits' dtype, the gathered lerp
    with fp32 weights otherwise), so the upsampled logits are equal bit
    for bit, and so is every argmax;
  * scatter_fine_into_pred: equal; forward_lidarseg: within 1e-6.

The whole eval path on the tiny model's outputs is held in
tests/test_torch_model.py, on its fixture's outputs.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.config.nuscenes import NUSC_CLASS_NAMES as JAX_NAMES
from coocc_tpu.evaluation import formatting as jfmt
from coocc_tpu.evaluation import ssc_metrics as jsm
from coocc_tpu.nn.occ_head import forward_lidarseg as jax_forward_lidarseg
from coocc_tpu.ops.interpolate import resize_trilinear_chlast

from coocc_tpu_torch.config.nuscenes import NUSC_CLASS_NAMES
from coocc_tpu_torch.evaluation import formatting as fmt
from coocc_tpu_torch.evaluation import ssc_metrics as sm
from coocc_tpu_torch.nn.occ_head import forward_lidarseg

C = 17
COARSE, FINE = (20, 20, 4), (40, 40, 8)
PC_RANGE = (-10.0, -10.0, -2.0, 10.0, 10.0, 2.0)


def _gt(rs, B=2):
    gt = rs.randint(0, C, (B,) + FINE)
    gt = np.where(rs.rand(*gt.shape) < 0.6, 0, gt)
    return np.where(rs.rand(*gt.shape) < 0.03, 255, gt).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _summary_eq(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k], np.float64),
                                      np.asarray(b[k], np.float64), k)


def test_class_names_match_jax():
    assert NUSC_CLASS_NAMES == JAX_NAMES


@pytest.mark.parametrize("masked", [False, True])
def test_fast_hist_matches_jax(masked):
    rs = np.random.RandomState(0)
    pred, label = rs.randint(0, C, (2, 4000)), rs.randint(0, C, (2, 4000))
    valid = rs.rand(2, 4000) < 0.8 if masked else None
    got = sm.fast_hist(_t(pred), _t(label), C,
                       None if valid is None else _t(valid))
    ref = jsm.fast_hist(jnp.asarray(pred), jnp.asarray(label), C,
                        None if valid is None else jnp.asarray(valid))
    assert got.dtype == torch.int64 and got.shape == (C, C)
    _eq(got, ref)
    assert int(got.sum()) == (valid.sum() if masked else pred.size)


@pytest.mark.parametrize("case", ["random", "empty_classes", "all_empty"])
def test_ssc_summary_matches_jax(case):
    rs = np.random.RandomState(1)
    sc = rs.randint(0, 1000, (2, 2))
    ssc = rs.randint(0, 1000, (C, C))
    if case == "empty_classes":
        ssc[3], ssc[:, 3] = 0, 0      # a class with no gt and no prediction
    if case == "all_empty":
        sc, ssc = np.zeros_like(sc), np.zeros_like(ssc)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # an all-nan mean
        got, ref = sm.ssc_summary(sc, ssc), jsm.ssc_summary(sc, ssc)
    _summary_eq(got, ref)


def test_lidarseg_hist_matches_jax():
    rs = np.random.RandomState(2)
    logits = rs.randn(2, 3000, C).astype(np.float32)
    labels = rs.randint(0, C, (2, 3000))
    valid = rs.rand(2, 3000) < 0.9
    got = sm.lidarseg_hist(_t(logits), _t(labels), _t(valid), C)
    ref = jsm.lidarseg_hist(jnp.asarray(logits), jnp.asarray(labels),
                            jnp.asarray(valid), C)
    _eq(got, ref)
    assert int(got[:, 0].sum()) == 0, "the argmax skips class 0"


def test_tables_match_jax():
    rs = np.random.RandomState(3)
    ssc = rs.randint(0, 1000, (C, C))
    ssc[5], ssc[:, 5] = 0, 0
    summary = jsm.ssc_summary(rs.randint(1, 1000, (2, 2)), ssc)
    assert fmt.format_ssc_table(summary, NUSC_CLASS_NAMES) \
        == jfmt.format_ssc_table(summary, JAX_NAMES)
    rendered = {**summary, "render_PSNR": 21.5, "render_SSIM": 0.61}
    assert fmt.format_ssc_table(rendered, NUSC_CLASS_NAMES) \
        == jfmt.format_ssc_table(rendered, JAX_NAMES)
    assert fmt.format_lidarseg_table(ssc, NUSC_CLASS_NAMES) \
        == jfmt.format_lidarseg_table(ssc, JAX_NAMES)
    _eq(fmt.cm_to_ious(ssc), jfmt.cm_to_ious(ssc))


@pytest.mark.parametrize("with_mask", [False, True])
def test_occupancy_hists_fp32_match_jax(with_mask):
    rs = np.random.RandomState(4)
    logits = rs.randn(2, *COARSE, C).astype(np.float32)
    gt = _gt(rs)
    mask = (rs.rand(*gt.shape) < 0.7).astype(np.uint8) if with_mask \
        else None
    got = sm.occupancy_hists(_t(logits), _t(gt), C, 0,
                             None if mask is None else _t(mask))
    ref = jsm.occupancy_hists(jnp.asarray(logits), jnp.asarray(gt), C, 0,
                              None if mask is None else jnp.asarray(mask))
    for g, r in zip(got, ref):
        assert g.dtype == torch.int64
        _eq(g, r)
    valid = (gt != 255) & (True if mask is None else mask != 0)
    assert int(got[1].sum()) == int(got[0].sum()) == valid.sum()


def test_occupancy_hists_bf16_flips_counted():
    """bf16 logits: the port upsamples in bf16 ops where JAX does, so the
    upsampled logits, their argmax (no flipped cell) and the hists equal
    JAX's; the upsampling also equals JAX's off the integer ratios, where
    the fp32 lerp weights promote the result to fp32."""
    rs = np.random.RandomState(5)
    logits = rs.randn(1, *COARSE, C).astype(np.float32)
    gt = _gt(rs, 1)
    jl = jnp.asarray(logits, jnp.bfloat16)
    tl = _t(logits).to(torch.bfloat16)
    for size, dtype in ((FINE, torch.bfloat16), ((2 * FINE[0], 30, 6),
                                                 torch.float32)):
        up = sm.resize_logits(tl, size)
        assert up.dtype == dtype
        _eq(up.float().numpy(), np.asarray(
            resize_trilinear_chlast(jl, size).astype(jnp.float32)))
    got = sm.occupancy_hists(tl, _t(gt), C)
    ref = jsm.occupancy_hists(jl, jnp.asarray(gt), C)
    for g, r in zip(got, ref):
        _eq(g, r)


def test_scatter_fine_into_pred_matches_jax():
    rs = np.random.RandomState(6)
    B, K, r = 2, 50, 2
    cells = np.stack([rs.choice(np.prod(COARSE), K, replace=False)
                      for _ in range(B)])
    coarse = np.stack(np.unravel_index(cells, COARSE), -1)
    child = np.stack(np.meshgrid(*[np.arange(r)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    coords = (coarse[:, :, None] * r + child).reshape(B, -1, 3)
    valid = np.repeat(rs.rand(B, K) < 0.8, r ** 3, axis=1)
    logits = rs.randn(B, K * r ** 3, C).astype(np.float32)
    got = sm.scatter_fine_into_pred(_t(logits), _t(coords.astype(np.int32)),
                                    _t(valid), FINE)
    ref = jsm.scatter_fine_into_pred(jnp.asarray(logits),
                                     jnp.asarray(coords, jnp.int32),
                                     jnp.asarray(valid), FINE)
    _eq(got, ref)


def test_forward_lidarseg_matches_jax():
    rs = np.random.RandomState(7)
    logits = rs.randn(2, *FINE, C).astype(np.float32)
    pts = np.zeros((2, 2048, 4), np.float32)
    for a in range(3):  # some points outside the range (border padding)
        pts[..., a] = rs.uniform(PC_RANGE[a] - 1, PC_RANGE[a + 3] + 1,
                                 (2, 2048))
    mask = rs.rand(2, 2048) < 0.9
    got = forward_lidarseg(_t(logits), _t(pts), _t(mask), PC_RANGE)
    ref = np.asarray(jax_forward_lidarseg(jnp.asarray(logits),
                                          jnp.asarray(pts),
                                          jnp.asarray(mask), PC_RANGE))
    assert got.shape == ref.shape == (2, 2048, C)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
