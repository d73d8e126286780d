"""The multi-scale deformable attention family, the port against the JAX
package on the CPU, on the inputs of the JAX package's own tests
(tests/test_ms_deform_attn.py, tests/test_image2bev.py):

  * the samplers `ms_deform_attn_3d` and `ms_deform_attn_2d`, with
    locations past every border (zeros padding);
  * MSDeformAttn3D, MSDeformableAttention2D, DeformSelfAttention (with and
    without a history), DeformCrossAttention (a hit mask with unhit
    queries), VoxFormerLayer, VoxFormerEncoder (with intermediates) and
    Image2BEVTransformer: JAX's module initialized by flax with every leaf
    perturbed by seeded noise (flax starts the offset and weight kernels at
    zero: unperturbed, the offsets would not depend on the query, and a
    wrong reshape of them would pass), carried into the port by
    convert.module_state_dict_from_jax (strict); every output within
    REL of its scale in fp32;
  * point_sampling and the reference points against JAX's;
  * the gradients of MSDeformAttn3D and Image2BEVTransformer with respect
    to their values, queries and parameters against jax.vjp, each leaf
    within REL of its scale;
  * Image2BEVTransformer in bf16 against JAX's bf16 (compiled with
    xla_allow_excess_precision off, so that each bf16 op rounds as eager
    torch's does): the port's distance within twice (max) and 1.5 times
    (mean) of JAX's own bf16-to-fp32 drift, the rule of
    tests/test_torch_bf16_modules.py.
JAX's jitted runs go through a thread pool beside the port's work.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.nn import image2bev as ji2b
from coocc_tpu.ops import ms_deform_attn as jmsda

from coocc_tpu_torch.convert import module_state_dict_from_jax
from coocc_tpu_torch.nn import image2bev
from coocc_tpu_torch.ops import ms_deform_attn
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

REL = 1e-4
JIT_BF16 = dict(compiler_options={"xla_allow_excess_precision": False})
PC_RANGE = (-8.0, -8.0, -2.0, 8.0, 8.0, 2.0)
IMG = (80, 120)


def _randomized(variables, seed):
    """Every leaf moved by 10% of its spread (0.1 where the leaf is
    constant: the zero kernels, biases)."""
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


def _cf(a, axis=1):
    """channels-last numpy -> channels-first torch (channels to `axis`)."""
    return _t(np.moveaxis(a, -1, axis))


def _cams_setup():
    """tests/test_image2bev.py's tiny_setup: 2 cameras, levels 8x12 and
    4x6 of 32 channels, a lidar2img whose second camera is skewed."""
    rng = np.random.RandomState(1)
    B, N, C = 1, 2, 32
    feats = [rng.randn(B, N, h, w, C).astype("f4")
             for h, w in [(8, 12), (4, 6)]]
    l2i = np.tile(np.eye(4, dtype="f4")[None, None], (B, N, 1, 1))
    l2i[:, :, 0, 0] = 60.0
    l2i[:, :, 1, 1] = 40.0
    l2i[:, :, 0, 2] = 60.0
    l2i[:, :, 1, 2] = 40.0
    l2i[:, 1, 0, 1] = 30.0
    return feats, l2i


def _rig():
    """[1, 2, 4, 4] lidar2img of two pinhole cameras (120x80 images, 90
    degrees across) looking along +x and -x, a little off the origin:
    about half of the tiny grids' pillars hit a camera (the JAX test's
    lidar2img hits none of a 4x4 grid's)."""
    l2i = np.zeros((1, 2, 4, 4), np.float32)
    l2i[0, 0] = [[60, -60, 0, 5], [40, 0, -40, 3], [1, 0, 0, 0.2],
                 [0, 0, 0, 1]]
    l2i[0, 1] = [[-60, 60, 0, -4], [-40, 0, -40, 2], [-1, 0, 0, 0.1],
                 [0, 0, 0, 1]]
    return l2i


def _cams_cf(feats):
    return [_cf(f, 2) for f in feats]


def _cases():
    """{name: (JAX module, port module, JAX's inputs, the port's call on
    them)}."""
    rng = np.random.RandomState(0)
    feats, _ = _cams_setup()
    l2i = _rig()
    B, Q, C = 2, 7, 16
    levels = [rng.randn(B, *s, C).astype(np.float32)
              for s in ((8, 8, 4), (4, 4, 2), (2, 2, 1))]
    q7 = rng.randn(B, Q, C).astype(np.float32)
    ref3 = rng.uniform(-0.1, 1.1, (B, Q, 3)).astype(np.float32)
    q32 = rng.randn(1, 10, 32).astype(np.float32)
    refz = rng.uniform(-0.1, 1.1, (1, 10, 2, 2)).astype(np.float32)
    lv2 = [f[:, 0] for f in feats]
    q12 = rng.randn(1, 12, 32).astype(np.float32)
    pos12 = rng.randn(1, 12, 32).astype(np.float32)
    prev12 = rng.randn(1, 12, 32).astype(np.float32)
    ref2d = ji2b.get_reference_points_2d(3, 4)[None]
    q5 = rng.randn(1, 5, 32).astype(np.float32)
    refs_cam = rng.uniform(-0.1, 1.1, (1, 2, 5, 2, 2)).astype(np.float32)
    mask = rng.rand(1, 2, 5, 2) < 0.6
    mask[0, :, 3] = False                   # a query no camera hits
    ref3d = ji2b.get_reference_points_3d(6, 6, 4.0, 4)
    xy, bev_mask = (np.asarray(a) for a in ji2b.point_sampling(
        jnp.asarray(ref3d), PC_RANGE, jnp.asarray(l2i), IMG))
    q36 = rng.randn(1, 36, 32).astype(np.float32)
    pos36 = rng.randn(1, 36, 32).astype(np.float32)
    prev36 = rng.randn(1, 36, 32).astype(np.float32)
    ref2d6 = ji2b.get_reference_points_2d(6, 6)[None]
    enc = dict(embed_dims=32, num_layers=2, num_heads=4, num_levels=2,
               num_cams=2, pc_range=PC_RANGE, feedforward_channels=64)
    return {
        "msda3d": (
            jmsda.MSDeformAttn3D(embed_dims=C, num_heads=4, num_levels=3,
                                 num_points=2),
            ms_deform_attn.MSDeformAttn3D(C, 4, 3, 2),
            (q7, levels, ref3),
            lambda m, q, lv, r: m(_t(q), [_cf(v) for v in lv], _t(r))),
        "msda2d": (
            ji2b.MSDeformableAttention2D(embed_dims=32, num_heads=4,
                                         num_levels=2, num_points=4),
            image2bev.MSDeformableAttention2D(32, 4, 2, 4),
            (q32, lv2, refz),
            lambda m, q, lv, r: m(_t(q), [_cf(v) for v in lv], _t(r))),
        "self_attn": (
            ji2b.DeformSelfAttention(embed_dims=32, num_heads=4,
                                     num_points=4),
            image2bev.DeformSelfAttention(32, 4, num_points=4),
            (q12, ref2d, (3, 4), pos12),
            lambda m, q, r, s, p: m(_t(q), _t(r), s, query_pos=_t(p))),
        "self_attn_prev": (
            ji2b.DeformSelfAttention(embed_dims=32, num_heads=4,
                                     num_points=4),
            image2bev.DeformSelfAttention(32, 4, num_points=4),
            (q12, ref2d, (3, 4), pos12, prev12),
            lambda m, q, r, s, p, h: m(_t(q), _t(r), s, query_pos=_t(p),
                                       prev_bev=_t(h))),
        "cross_attn": (
            ji2b.DeformCrossAttention(embed_dims=32, num_cams=2,
                                      num_levels=2, num_heads=4,
                                      num_points=4),
            image2bev.DeformCrossAttention(32, 2, 2, 4, 4),
            (q5, feats, refs_cam, mask),
            lambda m, q, f, r, k: m(_t(q), _cams_cf(f), _t(r), _t(k))),
        "layer": (
            ji2b.VoxFormerLayer(embed_dims=32, num_heads=4, num_levels=2,
                                feedforward_channels=64, num_cams=2),
            image2bev.VoxFormerLayer(32, 4, 2, feedforward_channels=64,
                                     num_cams=2),
            (q36, feats, ref2d6, (6, 6), xy, bev_mask, pos36),
            lambda m, q, f, r2, s, xy_, bm, p: m(
                _t(q), _cams_cf(f), _t(r2), s, _t(xy_), _t(bm),
                query_pos=_t(p))),
        "encoder": (
            ji2b.VoxFormerEncoder(**enc, return_intermediate=True),
            image2bev.VoxFormerEncoder(**enc, return_intermediate=True),
            (q36, feats, 6, 6, l2i, IMG, pos36, prev36),
            lambda m, q, f, h, w, li, im, p, pv: m(
                _t(q), _cams_cf(f), h, w, _t(li), im, bev_pos=_t(p),
                prev_bev=_t(pv))),
        "transformer": (
            ji2b.Image2BEVTransformer(embed_dims=32, num_layers=2,
                                      num_heads=4, num_feature_levels=2,
                                      num_cams=2, bev_h=4, bev_w=4,
                                      pc_range=PC_RANGE),
            image2bev.Image2BEVTransformer(32, 2, 4, 2, 2, 4, 4, PC_RANGE),
            (feats, l2i, IMG),
            lambda m, f, li, im: m(_cams_cf(f), _t(li), im)),
    }


CASES = ("msda3d", "msda2d", "self_attn", "self_attn_prev", "cross_attn",
         "layer", "encoder", "transformer")
# the positional inputs that are static (shapes) for JAX's jit
STATIC = {"self_attn": (2,), "self_attn_prev": (2,), "layer": (3,),
          "encoder": (2, 3, 5), "transformer": (2,)}


def _jax_side(name, jmod, inputs):
    static = STATIC.get(name, ())
    dyn = [a for i, a in enumerate(inputs) if i not in static]

    def call(v, *d):
        it = iter(d)
        args = [inputs[i] if i in static else next(it)
                for i in range(len(inputs))]
        return jmod.apply(v, *args)

    def init(*d):
        it = iter(d)
        args = [inputs[i] if i in static else next(it)
                for i in range(len(inputs))]
        return jmod.init(jax.random.PRNGKey(0), *args)
    variables = _randomized(jax.tree.map(np.asarray, jax.jit(init)(*dyn)),
                            1)
    out = jax.jit(call)(variables, *dyn)
    return {"variables": variables, "out": np.asarray(out)}


@pytest.fixture(scope="module")
def modules():
    """{case: (JAX's results, the port's output, the port module)}."""
    cases = _cases()
    assert tuple(cases) == CASES
    with ThreadPoolExecutor(4) as pool:
        jobs = {n: pool.submit(_jax_side, n, c[0], c[2])
                for n, c in cases.items()}
        res = {}
        for name, (_, port, inputs, call) in cases.items():
            ref = jobs[name].result()
            port.load_state_dict(module_state_dict_from_jax(
                port, ref["variables"]), strict=True)
            with torch.no_grad():
                res[name] = (ref, call(port, *inputs).numpy(), port)
    return res


@pytest.mark.parametrize("name", CASES)
def test_module_matches_jax(modules, name):
    ref, got, _ = modules[name]
    _close(got, ref["out"], name)


def test_unhit_query_keeps_its_residual(modules):
    """A query no camera hits leaves the cross-attention as its residual
    plus output_proj's bias, in JAX and in the port."""
    ref, got, port = modules["cross_attn"]
    q5 = _cases()["cross_attn"][2][0]
    bias = port.output_proj.bias.detach().numpy()
    np.testing.assert_allclose(got[0, 3], q5[0, 3] + bias, atol=1e-6)
    np.testing.assert_allclose(ref["out"][0, 3], q5[0, 3] + bias, atol=1e-6)


def test_ms_deform_attn_3d_matches_jax():
    """tests/test_ms_deform_attn.py's core inputs, locations past every
    border."""
    rng = np.random.RandomState(0)
    B, Q, H, L, P, D = 1, 5, 2, 2, 3, 4
    values = [rng.randn(B, 6, 5, 4, H, D).astype(np.float32),
              rng.randn(B, 3, 3, 2, H, D).astype(np.float32)]
    locs = rng.rand(B, Q, H, L, P, 3).astype(np.float32) * 1.2 - 0.1
    w = rng.rand(B, Q, H, L, P).astype(np.float32)
    w /= w.reshape(B, Q, H, -1).sum(-1)[..., None, None]
    ref = jmsda.ms_deform_attn_3d([jnp.asarray(v) for v in values],
                                  jnp.asarray(locs), jnp.asarray(w))
    got = ms_deform_attn.ms_deform_attn_3d([_t(v) for v in values],
                                           _t(locs), _t(w))
    assert got.dtype == torch.float32
    _close(got.numpy(), ref, "ms_deform_attn_3d")


def test_ms_deform_attn_2d_matches_jax():
    """tests/test_image2bev.py's golden inputs (locations straddling the
    borders)."""
    rng = np.random.RandomState(0)
    B, Q, nH, P, c = 2, 37, 4, 3, 8
    shapes = [(11, 17), (6, 9)]
    L = len(shapes)
    values = [rng.randn(B, h, w, nH, c).astype("f4") for h, w in shapes]
    loc = rng.uniform(-0.1, 1.1, (B, Q, nH, L, P, 2)).astype("f4")
    w = rng.rand(B, Q, nH, L, P).astype("f4")
    w /= w.reshape(B, Q, nH, -1).sum(-1).reshape(B, Q, nH, 1, 1)
    ref = ji2b.ms_deform_attn_2d([jnp.asarray(v) for v in values],
                                 jnp.asarray(loc), jnp.asarray(w))
    got = image2bev.ms_deform_attn_2d([_t(v) for v in values], _t(loc),
                                      _t(w))
    _close(got.numpy(), ref, "ms_deform_attn_2d")


def test_reference_points_and_point_sampling_match_jax():
    for h, w in ((6, 6), (3, 4), (5, 7)):
        np.testing.assert_array_equal(image2bev.get_reference_points_2d(h, w),
                                      ji2b.get_reference_points_2d(h, w))
        np.testing.assert_array_equal(
            image2bev.get_reference_points_3d(h, w, 4.0, 4),
            ji2b.get_reference_points_3d(h, w, 4.0, 4))
    for l2i in (_cams_setup()[1], _rig()):
        ref3d = ji2b.get_reference_points_3d(6, 6, 4.0, 4)
        xy_j, m_j = ji2b.point_sampling(jnp.asarray(ref3d), PC_RANGE,
                                        jnp.asarray(l2i), IMG)
        xy_p, m_p = image2bev.point_sampling(_t(ref3d), PC_RANGE, _t(l2i),
                                             IMG)
        _close(xy_p.numpy(), xy_j, "reference_points_cam", 1e-6)
        np.testing.assert_array_equal(m_p.numpy(), np.asarray(m_j))
        assert 0 < np.asarray(m_j).mean() < 1
    # the rig: half the pillars or more hit a camera
    assert np.asarray(m_j).any(-1).any(1).mean() >= 0.5


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def _grad_case(name):
    """(JAX's init on the inputs, JAX's call on (variables, *inputs), port
    module, JAX's inputs to differentiate, the port's call on them):
    MSDeformAttn3D in its query and values; the 1-layer
    Image2BEVTransformer (its bev_queries the queries) in its feature
    maps."""
    jmod, port, inputs, call = _cases()[name]
    key = jax.random.PRNGKey(0)
    if name == "msda3d":
        q, lv, r = inputs
        return (lambda q, lv: jmod.init(key, q, lv, r),
                lambda v, q, lv: jmod.apply(v, q, lv, r), port, (q, lv),
                lambda m, q, lv: m(q, [x.movedim(-1, 1) for x in lv], _t(r)))
    f, li, im = inputs
    jmod = ji2b.Image2BEVTransformer(embed_dims=32, num_layers=1,
                                     num_heads=4, num_feature_levels=2,
                                     num_cams=2, bev_h=4, bev_w=4,
                                     pc_range=PC_RANGE)
    port = image2bev.Image2BEVTransformer(32, 1, 4, 2, 2, 4, 4, PC_RANGE)
    return (lambda f: jmod.init(key, f, li, im),
            lambda v, f: jmod.apply(v, f, li, im), port, (f,),
            lambda m, f: m([x.movedim(-1, 2) for x in f], _t(li), im))


@pytest.mark.parametrize("name", ["msda3d", "transformer"])
def test_gradients_match_jax(name):
    """d(sum(out * cotangent)) with respect to the inputs (values and
    queries) and every parameter, port against jax.vjp, each leaf within
    REL of its scale. The port's value gradient runs through gather_rows
    (a fixed-order sum)."""
    jinit, jcall, port, diff, pcall = _grad_case(name)
    variables = _randomized(jax.tree.map(np.asarray, jax.jit(jinit)(*diff)),
                            2)
    shape = jax.eval_shape(jcall, variables, *diff).shape
    cot = np.random.RandomState(3).randn(*shape).astype(np.float32)

    def out_and_grads(v, d, c):
        out, vjp = jax.vjp(jcall, v, *d)
        return out, vjp(c)
    out, jgrads = jax.jit(out_and_grads)(variables, diff, cot)
    port.load_state_dict(module_state_dict_from_jax(port, variables),
                         strict=True)
    tin = [jax.tree.map(lambda a: _t(a).requires_grad_(), d) for d in diff]
    got = pcall(port, *tin)
    _close(got.detach().numpy(), out, f"{name} output")
    (got * _t(cot)).sum().backward()
    for i, (t, g) in enumerate(zip(jax.tree.leaves(tin),
                                   jax.tree.leaves(jgrads[1:]))):
        _close(t.grad.numpy(), g, f"{name} input {i}")
    pgrads = module_state_dict_from_jax(port, {"params": jax.tree.map(
        np.asarray, jgrads[0]["params"])})
    for k, p in port.named_parameters():
        _close(p.grad.numpy(), pgrads[k].numpy(), f"{name} {k}")


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------

def test_transformer_bf16_within_jax_drift():
    """Image2BEVTransformer with a bf16 compute dtype on bf16 feature maps:
    the port's distance to JAX's bf16 output within 2x (max) and 1.5x
    (mean) of JAX's own distance from bf16 to its fp32 output, with equal
    dtypes."""
    feats, _ = _cams_setup()
    l2i = _rig()
    feats16 = [np.asarray(jnp.asarray(f).astype(jnp.bfloat16)) for f in
               feats]
    kw = dict(embed_dims=32, num_layers=2, num_heads=4,
              num_feature_levels=2, num_cams=2, bev_h=4, bev_w=4,
              pc_range=PC_RANGE)
    j32 = ji2b.Image2BEVTransformer(**kw)
    j16 = ji2b.Image2BEVTransformer(**kw, dtype=jnp.bfloat16)
    variables = _randomized(jax.tree.map(np.asarray, jax.jit(
        lambda f, l: j32.init(jax.random.PRNGKey(0), f, l, IMG))(
            feats, l2i)), 1)
    ref32 = np.asarray(jax.jit(lambda v, f, l: j32.apply(v, f, l, IMG))(
        variables, [f.astype(np.float32) for f in feats16], l2i))
    ref16 = jax.jit(lambda v, f, l: j16.apply(v, f, l, IMG), **JIT_BF16)(
        variables, feats16, l2i)
    port = image2bev.Image2BEVTransformer(32, 2, 4, 2, 2, 4, 4, PC_RANGE,
                                          dtype=torch.bfloat16)
    port.load_state_dict(module_state_dict_from_jax(port, variables),
                         strict=True)
    with torch.no_grad():
        got = port([_cf(f.astype(np.float32), 2).to(torch.bfloat16)
                    for f in feats16], _t(l2i), IMG)
    assert got.dtype == torch.bfloat16 and ref16.dtype == jnp.bfloat16
    ref16 = np.asarray(ref16).astype(np.float32)
    own = np.abs(ref16 - ref32)
    diff = np.abs(got.float().numpy() - ref16)
    assert own.max() > 0
    assert diff.max() <= 2.0 * own.max(), (diff.max(), own.max())
    assert diff.mean() <= 1.5 * own.mean(), (diff.mean(), own.mean())
