"""The Mask2Former occupancy head, the port against the JAX package on the
CPU, on the inputs of the JAX package's own tests (tests/test_mask2former.py):

  * sine_positional_encoding_3d (an odd num_feats too) and _maxpool_to;
  * Mask2FormerOccHead on the 16x16x8 pyramid, with and without the
    memories' input projection: JAX's head initialized by flax with every
    leaf perturbed by seeded noise, carried into the port by
    convert.module_state_dict_from_jax (strict); cls_preds and mask_preds of
    every stage and occ within REL of their scale (fp32);
  * format_panoptic_results (JAX's case and the head's own outputs) and
    forward_lidarseg (border and zeros padding, with and without labels);
  * mask2former_occ_loss and mask2former_occ_loss_all_layers on the head's
    outputs, with the same Hungarian assignments as JAX's (scipy's
    linear_sum_assignment recorded on both sides), every term within
    1e-5 of its value (each is one fp32 reduction);
  * the head in bf16 against JAX's bf16 (xla_allow_excess_precision off):
    the port's distance within twice (max) and 1.5 times (mean) of JAX's
    own bf16-to-fp32 drift (tests/test_torch_bf16_modules.py's rule).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

from coocc_tpu.nn import mask2former_occ as jm2f

from coocc_tpu_torch.convert import module_state_dict_from_jax
from coocc_tpu_torch.nn import mask2former_occ as m2f
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

REL = 1e-4
JIT_BF16 = dict(compiler_options={"xla_allow_excess_precision": False})
SHAPES = [(16, 16, 8), (8, 8, 4), (4, 4, 2), (2, 2, 1)]
HEAD = dict(feat_channels=32, num_classes=5, num_queries=8, num_heads=4,
            num_decoder_layers=3, feedforward_channels=64)
PORT_HEAD = (32, 5, 8, 4, 3, 3, 64)
# memories' channels (coarsest first) of the "proj" case
PROJ = (16, 24, 16)


def _randomized(variables, seed):
    rs = np.random.RandomState(seed)

    def leaf(p):
        p = np.asarray(p)
        s = 0.1 * (p.std() if p.std() > 0 else 1.0)
        return (p + rs.standard_normal(p.shape) * s).astype(np.float32)
    return {"params": jax.tree.map(leaf, variables["params"])}


def _close(got, ref, what, rel=REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0, what
    assert np.abs(got - ref).max() <= rel * scale, (
        what, np.abs(got - ref).max(), scale)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pyramid(case, seed=0):
    rng = np.random.RandomState(seed)
    chans = [32, *PROJ[::-1]] if case == "proj" else [32] * 4
    return [rng.randn(1, *s, c).astype(np.float32)
            for s, c in zip(SHAPES, chans)]


def _port_feats(feats, dtype=torch.float32):
    return [_t(np.moveaxis(f, -1, 1)).to(dtype) for f in feats]


@pytest.fixture(scope="module")
def heads():
    """{case: (JAX's variables, JAX's outputs, the port's outputs)}."""
    res = {}
    head = jm2f.Mask2FormerOccHead(**HEAD)
    for case in ("plain", "proj"):
        feats = _pyramid(case)
        v = _randomized(jax.tree.map(np.asarray, jax.jit(
            head.init, static_argnames="train")(
                jax.random.PRNGKey(0), feats, train=False)), 1)
        out = jax.tree.map(np.asarray, jax.jit(
            lambda v, f: head.apply(v, f, train=False))(v, feats))
        port = m2f.Mask2FormerOccHead(
            *PORT_HEAD, in_channels=PROJ if case == "proj" else None)
        port.load_state_dict(module_state_dict_from_jax(port, v),
                             strict=True)
        with torch.no_grad():
            got = port(_port_feats(feats))
        res[case] = (v, out, got)
    return res


def test_sine_positional_encoding_matches_jax():
    for shape, nf in (((4, 6, 2), 8), ((5, 3, 2), 42), ((2, 2, 1), 7)):
        ref = np.asarray(jm2f.sine_positional_encoding_3d(shape, nf))
        got = m2f.sine_positional_encoding_3d(shape, nf)
        assert got.shape == ref.shape == shape + (3 * nf,)
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_maxpool_to_matches_jax():
    x = np.random.RandomState(2).randn(2, 3, 8, 6, 4).astype(np.float32)
    for target in ((4, 3, 2), (2, 2, 1), (8, 6, 4)):
        np.testing.assert_array_equal(
            m2f._maxpool_to(_t(x), target).numpy(),
            np.asarray(jm2f._maxpool_to(jnp.asarray(x), target)))


@pytest.mark.parametrize("case", ["plain", "proj"])
def test_head_matches_jax(heads, case):
    _, out, got = heads[case]
    assert len(got["cls_preds"]) == len(got["mask_preds"]) == 4
    for i in range(4):
        _close(got["cls_preds"][i].numpy(), out["cls_preds"][i],
               f"cls_preds[{i}]")
        _close(got["mask_preds"][i].numpy(), out["mask_preds"][i],
               f"mask_preds[{i}]")
    assert got["occ"].shape == (1, 16, 16, 8, 5)
    _close(got["occ"].numpy(), out["occ"], "occ")


def test_format_panoptic_results_matches_jax(heads):
    # JAX's test case: two instances of thing class 1, stuff class 2
    Q, NC = 3, 4
    cls = np.full((1, Q, NC + 1), -5.0, np.float32)
    cls[0, 0, 1] = cls[0, 1, 1] = cls[0, 2, 2] = 5.0
    mask = np.full((1, Q, 2, 2, 1), -5.0, np.float32)
    mask[0, 0, 0] = 5.0
    mask[0, 1, 1, 0] = 5.0
    mask[0, 2, 1, 1] = 5.0
    _, out, got = heads["plain"]
    for c, m, things in ((cls, mask, (1,)),
                         (out["cls_preds"][-1], out["mask_preds"][-1],
                          (1, 2, 3))):
        ref = jm2f.format_panoptic_results(jnp.asarray(c), jnp.asarray(m),
                                           thing_indices=things)
        res = m2f.format_panoptic_results(_t(c), _t(m), things)
        for r, g in zip(ref, res):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, r)
    assert len(np.unique(res[1])) > 1


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("labels", [False, True])
def test_forward_lidarseg_matches_jax(heads, padding_mode, labels):
    """Points over and past the grid's range, in two batch entries (the
    head's outputs twice); the (z, y, x) swap onto grid_sample_3d."""
    _, out, _ = heads["plain"]
    rng = np.random.RandomState(4)
    cls = np.concatenate([out["cls_preds"][-1]] * 2)
    mask = np.concatenate([out["mask_preds"][-1],
                           out["mask_preds"][-2]])
    pc_range = (-10.0, -8.0, -2.0, 10.0, 8.0, 4.0)
    pts = [rng.uniform(-11, 11, (50, 4)).astype(np.float32),
           rng.uniform(-9, 9, (30, 5)).astype(np.float32)]
    kw = dict(pc_range=pc_range, padding_mode=padding_mode, num_classes=5)
    lab = [rng.randint(0, 5, len(p)) for p in pts] if labels else None
    ref = jm2f.forward_lidarseg(jnp.asarray(cls), jnp.asarray(mask), pts,
                                point_labels=lab, **kw)
    got = m2f.forward_lidarseg(_t(cls), _t(mask), [_t(p) for p in pts],
                               point_labels=lab, **kw)
    if labels:
        assert set(got) == {"point_mean_iou"}
        np.testing.assert_allclose(got["point_mean_iou"],
                                   ref["point_mean_iou"], rtol=1e-12)
    else:
        assert got.shape == (80, 5)
        _close(got.numpy(), ref, "point probabilities", 1e-5)


_ASSIGN = scipy.optimize.linear_sum_assignment


def _recording(calls):
    def record(cost):
        r = _ASSIGN(cost)
        calls.append(r)
        return r
    return record


def _gt(seed):
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, 5, size=(2, 16, 16, 8)).astype(np.int64)
    gt[0, :4] = 255                          # ignored voxels
    gt[1, :, :, 4:] = 3
    return gt


def test_losses_match_jax(heads):
    """Both losses on the head's four stages at B = 2 (the plain and proj
    heads' outputs stacked): the same assignments as JAX's, and every
    term within 1e-5 of JAX's."""
    outs = [heads[c][1] for c in ("plain", "proj")]
    gots = [heads[c][2] for c in ("plain", "proj")]
    cls = [np.concatenate([o["cls_preds"][i] for o in outs])
           for i in range(4)]
    mask = [np.concatenate([o["mask_preds"][i] for o in outs])
            for i in range(4)]
    gt = _gt(5)
    jcalls, pcalls = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scipy.optimize, "linear_sum_assignment",
                   _recording(jcalls))
        ref = jm2f.mask2former_occ_loss_all_layers(
            [jnp.asarray(c) for c in cls], [jnp.asarray(m) for m in mask],
            jnp.asarray(gt), num_classes=5)
        ref1 = jm2f.mask2former_occ_loss(jnp.asarray(cls[0]),
                                         jnp.asarray(mask[0]),
                                         jnp.asarray(gt), num_classes=5)
        mp.setattr(scipy.optimize, "linear_sum_assignment",
                   _recording(pcalls))
        got = m2f.mask2former_occ_loss_all_layers(
            [torch.cat([g["cls_preds"][i] for g in gots])
             for i in range(4)],
            [torch.cat([g["mask_preds"][i] for g in gots])
             for i in range(4)], _t(gt), num_classes=5)
        got1 = m2f.mask2former_occ_loss(_t(cls[0]), _t(mask[0]), _t(gt),
                                        num_classes=5)
    assert len(jcalls) == len(pcalls) == 10
    for (jq, jg), (pq, pg) in zip(jcalls, pcalls):
        np.testing.assert_array_equal(pq, jq)
        np.testing.assert_array_equal(pg, jg)
    assert set(got) == set(ref) and "d0.loss_cls" in got
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    for k in ref1:
        np.testing.assert_allclose(float(got1[k]), float(ref1[k]),
                                   rtol=1e-5, err_msg=k)


def test_loss_takes_a_gradient():
    """The port's loss terms are torch ops on the predictions (JAX's are
    host numpy): mask_pred and cls_pred receive finite, non-zero
    gradients, and a loss with every voxel ignored has no matched term."""
    rng = np.random.RandomState(6)
    cls = _t(rng.randn(1, 4, 4).astype(np.float32)).requires_grad_()
    mask = _t(rng.randn(1, 4, 4, 4, 2).astype(np.float32)).requires_grad_()
    gt = _t(rng.randint(0, 3, (1, 4, 4, 2)))
    loss = m2f.mask2former_occ_loss(cls, mask, gt, num_classes=3)
    sum(loss.values()).backward()
    for t in (cls, mask):
        assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
    empty = m2f.mask2former_occ_loss(cls, mask, torch.full_like(gt, 255),
                                     num_classes=3)
    assert float(empty["loss_mask"]) == float(empty["loss_dice"]) == 0.0


def test_head_bf16_within_jax_drift(heads):
    """The head with a bf16 compute dtype on bf16 features: occ, the last
    stage's cls_preds and mask_preds within 2x (max) and 1.5x (mean) of
    JAX's own distance from bf16 to fp32, with equal dtypes."""
    v = heads["plain"][0]
    feats16 = [np.asarray(jnp.asarray(f).astype(jnp.bfloat16))
               for f in _pyramid("plain")]
    j32 = jm2f.Mask2FormerOccHead(**HEAD)
    j16 = jm2f.Mask2FormerOccHead(**HEAD, dtype=jnp.bfloat16)
    ref32 = jax.jit(lambda v, f: j32.apply(v, f))(
        v, [f.astype(np.float32) for f in feats16])
    ref16 = jax.jit(lambda v, f: j16.apply(v, f), **JIT_BF16)(v, feats16)
    port = m2f.Mask2FormerOccHead(*PORT_HEAD, dtype=torch.bfloat16)
    port.load_state_dict(module_state_dict_from_jax(port, v), strict=True)
    with torch.no_grad():
        got = port(_port_feats([f.astype(np.float32) for f in feats16],
                               torch.bfloat16))
    for key, g, r16, r32 in (
            ("occ", got["occ"], ref16["occ"], ref32["occ"]),
            ("cls", got["cls_preds"][-1], ref16["cls_preds"][-1],
             ref32["cls_preds"][-1]),
            ("mask", got["mask_preds"][-1], ref16["mask_preds"][-1],
             ref32["mask_preds"][-1])):
        assert str(g.dtype)[6:] == r16.dtype.name, key
        r16 = np.asarray(r16).astype(np.float32)
        own = np.abs(r16 - np.asarray(r32))
        diff = np.abs(g.float().numpy() - r16)
        assert own.max() > 0, key
        assert diff.max() <= 2.0 * own.max(), (key, diff.max(), own.max())
        assert diff.mean() <= 1.5 * own.mean(), (key, diff.mean(),
                                                 own.mean())
