"""The port's gather-GEMM sparse conv engine and the ops beside it, against
the JAX package on the CPU (seeded numpy inputs).

(a) `ops/sparse_conv.py`: SubM rulebooks on grids below and above the
    dense-LUT threshold (4M cells: a LUT, then a binary search),
    `downsample_sites` and `build_strided_rulebook` at k3 s2 p1, with an
    output capacity that binds (the largest ids dropped), and at
    SparseEncoderHD's paddings (1, 1, 1) on an odd z and (1, 1, 0): the
    rulebooks, output ids and masks equal JAX's bit for bit.
    `apply_conv` (SubM and strided) and its gradients, `to_dense` and
    `from_dense` within fp32 rounding: 1e-5 of the output's scale (both
    sum K3*Cin <= 432 products in fp32, in other orders).
(b) `ops/voxelize.py:voxelize(exact_overflow=True)` on clouds that
    overflow the voxel cap and on one that does not: ids, masks and means
    equal JAX's bit for bit.
(c) `ops/fps.py` on the inputs of tests/test_point_ops.py and on seeded
    clouds with padding: equal indices.
(d) `nn/layers.py:masked_batch_norm` against JAX's `MaskedBatchNorm`: the
    training forward, its gradients (input, scale, bias) and the moved
    statistics within 1e-5 of their scales (fp32 sums in other orders),
    the eval forward within 1e-6.
(e) `ops/conv.py:conv` is JAX's `conv_f32acc` / `conv2d_f32acc`
    (ops/conv_acc.py: fp32 sums, one rounding, the backward in the
    operands' dtype): fp32 forward and gradients within 1e-5 of their
    scales, bf16 within one bf16 ulp of their scales (the same products
    summed in other orders, each rounded once).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from coocc_tpu.nn.layers import MaskedBatchNorm as JaxMaskedBN
from coocc_tpu.ops import fps as jfps
from coocc_tpu.ops import sparse_conv as jsc
from coocc_tpu.ops.conv_acc import conv2d_f32acc, conv_f32acc
from coocc_tpu.ops.voxelize import voxelize as jax_voxelize

from coocc_tpu_torch.nn.layers import BatchNorm, masked_batch_norm
from coocc_tpu_torch.ops import fps
from coocc_tpu_torch.ops import sparse_conv as sc
from coocc_tpu_torch.ops.conv import conv
from coocc_tpu_torch.ops.voxelize import voxelize
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

REL = 1e-5
BF16_ULP = 2.0 ** -7


def _sparse(seed, grid, n_active, C, capacity):
    """A sample of n_active distinct sorted sites, padded to capacity: the
    numpy (ids, features, mask)."""
    rng = np.random.RandomState(seed)
    ncell = int(np.prod(grid))
    ids = np.sort(rng.choice(ncell, size=n_active, replace=False))
    pad = capacity - n_active
    return (np.concatenate([ids, np.full(pad, ncell)]).astype(np.int64),
            np.concatenate([rng.randn(n_active, C),
                            np.zeros((pad, C))]).astype(np.float32),
            np.arange(capacity) < n_active)


# jitted: each of JAX's site and rulebook builders compiles as one program
# (called eagerly, it dispatches every op on its own)
_jax_subm_rulebook = jax.jit(jsc.build_subm_rulebook, static_argnums=(1,))
_jax_downsample_sites = jax.jit(jsc.downsample_sites,
                                static_argnums=(1, 2, 3),
                                static_argnames=("padding",))
_jax_strided_rulebook = jax.jit(jsc.build_strided_rulebook,
                                static_argnums=(3, 4),
                                static_argnames=("padding",))


def _jax_sp(ids, feats, mask):
    return jsc.SparseTensor(jnp.asarray(ids.astype(np.int32)),
                            jnp.asarray(feats), jnp.asarray(mask))


def _t(*a):
    return [torch.from_numpy(np.asarray(x)) for x in a]


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(got - ref).max()
    assert err <= rel * scale, (err, scale)


# ---------------------------------------------------------------------------
# (a) rulebooks, sites, conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid,n_active,capacity", [
    ((6, 5, 4), 20, 32),            # LUT, padding rows
    ((40, 40, 16), 900, 900),       # LUT, no padding row
    ((256, 256, 64), 3000, 3200)])  # 4.19M cells: binary search
def test_subm_rulebook_equals_jax(grid, n_active, capacity):
    ids, feats, mask = _sparse(0, grid, n_active, 2, capacity)
    ref = np.asarray(_jax_subm_rulebook(_jax_sp(ids, feats, mask), grid))
    got = sc.build_subm_rulebook(*_t(ids, mask), grid).numpy()
    np.testing.assert_array_equal(got, ref)


# (grid, n_active, capacity, out_capacity, padding)
SITE_CASES = {
    "k3s2p1": ((16, 14, 12), 300, 320, 2000, (1, 1, 1)),
    "cap_binds": ((16, 14, 12), 300, 320, 150, (1, 1, 1)),
    "hd_odd_z": ((12, 10, 65), 400, 410, 3000, (1, 1, 1)),
    "hd_pad_110": ((12, 10, 17), 300, 300, 2000, (1, 1, 0)),
    "binary_search": ((300, 300, 64), 4000, 4000, 30000, (1, 1, 1)),
}


def _sites_both(case, seed=1):
    grid, n_active, cap, out_cap, pad = SITE_CASES[case]
    out_grid = sc.conv_output_shape(grid, 3, 2, pad)
    ids, feats, mask = _sparse(seed, grid, n_active, 3, cap)
    jsp = _jax_sp(ids, feats, mask)
    j_ids, j_mask = _jax_downsample_sites(jsp, grid, out_grid, out_cap,
                                          padding=pad)
    j_rb = _jax_strided_rulebook(jsp, j_ids, j_mask, grid, out_grid,
                                 padding=pad)
    t_ids, t_mask, n = sc.downsample_sites(*_t(ids, mask), grid, out_grid,
                                           out_cap, padding=pad)
    t_rb = sc.build_strided_rulebook(*_t(ids, mask), t_ids, t_mask, grid,
                                     out_grid, padding=pad)
    return dict(grid=grid, out_grid=out_grid, np=(ids, feats, mask),
                jax=(jsp, j_ids, j_mask, j_rb), port=(t_ids, t_mask, t_rb),
                n_unique=int(n), out_cap=out_cap)


@pytest.mark.parametrize("case", sorted(SITE_CASES))
def test_downsample_sites_and_strided_rulebook_equal_jax(case):
    r = _sites_both(case)
    _, j_ids, j_mask, j_rb = r["jax"]
    t_ids, t_mask, t_rb = r["port"]
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(t_rb.numpy(), np.asarray(j_rb))
    assert int(t_mask.sum()) == min(r["n_unique"], r["out_cap"])
    if case == "cap_binds":
        assert r["n_unique"] > r["out_cap"]


@pytest.mark.parametrize("kind", ["subm", "strided", "strided_cap_binds"])
def test_apply_conv_and_grads_match_jax(kind):
    """The conv's output and its gradients in the features and the weight
    (a cotangent from seeded noise) within 1e-5 of their scales."""
    if kind == "subm":
        grid = (8, 7, 6)
        ids, feats, mask = _sparse(2, grid, 120, 5, 140)
        jsp = _jax_sp(ids, feats, mask)
        j_rb = _jax_subm_rulebook(jsp, grid)
        t_rb = sc.build_subm_rulebook(*_t(ids, mask), grid)
        out_mask = mask
    else:
        r = _sites_both("cap_binds" if kind.endswith("binds")
                        else "k3s2p1")
        ids, feats, mask = r["np"]
        _, _, j_om, j_rb = r["jax"]
        _, t_om, t_rb = r["port"]
        out_mask = np.asarray(j_om)
    rng = np.random.RandomState(3)
    Cin = feats.shape[1]
    w = (rng.randn(27, Cin, 4) * 0.2).astype(np.float32)
    cot = rng.randn(len(out_mask), 4).astype(np.float32)

    def jfn(f, w_):
        return jsc.apply_conv(f, jnp.asarray(mask), jnp.asarray(j_rb), w_,
                              jnp.asarray(out_mask))
    ref, vjp = jax.vjp(jfn, jnp.asarray(feats), jnp.asarray(w))
    ref_df, ref_dw = vjp(jnp.asarray(cot))
    f_t, w_t = _t(feats, w)
    f_t.requires_grad_(True)
    w_t.requires_grad_(True)
    got = sc.apply_conv(f_t, torch.from_numpy(mask), t_rb, w_t,
                        torch.from_numpy(np.array(out_mask)))
    got.backward(torch.from_numpy(cot))
    _close(got.detach(), ref)
    _close(f_t.grad, ref_df)
    _close(w_t.grad, ref_dw)


def test_to_dense_and_from_dense_match_jax():
    grid = (7, 6, 5)
    ids, feats, mask = _sparse(4, grid, 60, 3, 80)
    ref = np.asarray(jsc.to_dense(_jax_sp(ids, feats, mask), grid))
    got = sc.to_dense(*_t(ids, feats, mask), grid)
    np.testing.assert_array_equal(got.numpy(), ref)
    for cap in (80, 40):     # room for every site; the largest ids dropped
        j = jsc.from_dense(jnp.asarray(ref), cap)
        t = sc.from_dense(got, cap)
        np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
        np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
        np.testing.assert_array_equal(t.features.numpy(),
                                      np.asarray(j.features))


# ---------------------------------------------------------------------------
# (b) voxelize(exact_overflow=True)
# ---------------------------------------------------------------------------

def _cloud(seed, P, n_valid):
    """Points clustered so that voxels hold several points, in a shuffled
    arrival order; the padding after n_valid."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform([-8, -8, -1], [8, 8, 3], (n_valid // 4, 3))
    pts = centres[rng.randint(0, len(centres), n_valid)] \
        + rng.randn(n_valid, 3) * 0.3
    feats = rng.randn(n_valid, 2)
    cloud = np.zeros((P, 5), np.float32)
    cloud[:n_valid] = np.concatenate([pts, feats], 1)
    return cloud, np.arange(P) < n_valid


@pytest.mark.parametrize("max_voxels", [40, 150, 5000])
def test_voxelize_exact_overflow_equals_jax(max_voxels):
    """40 and 150 voxels kept of the ~400 occupied (the latest to arrive
    dropped), 5000: nothing overflows and both paths agree."""
    pcr, vs, grid = (-10, -10, -2, 10, 10, 4), (0.5, 0.5, 0.5), (40, 40, 12)
    cloud, m = _cloud(5, 2000, 1700)
    kw = dict(max_voxels=max_voxels, max_points_per_voxel=3,
              num_features=4)
    ref = jax_voxelize(jnp.asarray(cloud), jnp.asarray(m), pcr, vs, grid,
                       exact_overflow=True, **kw)
    got = voxelize(*_t(cloud, m), pcr, vs, grid, exact_overflow=True, **kw)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.features.numpy(),
                                  np.asarray(ref.features))
    fast = voxelize(*_t(cloud, m), pcr, vs, grid, **kw)
    n_occupied = int(voxelize(*_t(cloud, m), pcr, vs, grid,
                              **{**kw, "max_voxels": 5000}).mask.sum())
    assert (n_occupied > max_voxels) == (max_voxels < 5000)
    if max_voxels == 5000:
        for a, b in zip(fast, got):
            assert torch.equal(a, b)
    else:
        assert not torch.equal(fast.ids, got.ids)


# ---------------------------------------------------------------------------
# (c) fps, ball query, gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["oracle", "padding", "none_valid"])
def test_furthest_point_sample_equals_jax(case):
    rng = np.random.RandomState({"oracle": 0, "padding": 1,
                                 "none_valid": 2}[case])
    P, S = (64, 8) if case == "oracle" else (32, 6)
    pts = rng.randn(P, 3).astype(np.float32)
    mask = np.ones(P, bool)
    if case == "padding":
        pts[16:] = 1e6
        mask[16:] = False
    elif case == "none_valid":
        mask[:] = False
    ref = np.asarray(jfps.furthest_point_sample(jnp.asarray(pts),
                                                jnp.asarray(mask), S))
    got = fps.furthest_point_sample(*_t(pts, mask), S).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("num_samples", [3, 4, 40])
def test_ball_query_and_gather_equal_jax(num_samples):
    rng = np.random.RandomState(num_samples)
    pts = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    pts[:4] = [[0, 0, 0], [0.1, 0, 0], [5, 5, 5], [0, 0.2, 0]]
    centers = np.concatenate([pts[:2], [[9, 9, 9]],
                              rng.uniform(-1, 1, (5, 3))]).astype(np.float32)
    mask = rng.rand(30) < 0.8
    mask[:4] = True
    ref = np.asarray(jfps.ball_query(jnp.asarray(centers), jnp.asarray(pts),
                                     jnp.asarray(mask), 0.6, num_samples))
    got = fps.ball_query(*_t(centers, pts, mask), 0.6, num_samples)
    np.testing.assert_array_equal(got.numpy(), ref)
    feats = rng.randn(30, 5).astype(np.float32)
    np.testing.assert_array_equal(
        fps.gather_points(torch.from_numpy(feats), got).numpy(),
        np.asarray(jfps.gather_points(jnp.asarray(feats), jnp.asarray(ref))))


# ---------------------------------------------------------------------------
# (d) the masked BatchNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps,momentum", [(1e-5, 0.1), (1e-3, 0.01)])
def test_masked_batch_norm_matches_jax(eps, momentum):
    """Rows [N, C] with 70% active, the padding rows holding large values
    that must not reach the statistics."""
    rng = np.random.RandomState(6)
    N, C = 300, 8
    x = (rng.randn(N, C) * 2 + 1).astype(np.float32)
    mask = rng.rand(N) < 0.7
    x[~mask] = 50.0
    scale = (rng.rand(C) + 0.5).astype(np.float32)
    bias = rng.randn(C).astype(np.float32)
    mean0 = rng.randn(C).astype(np.float32)
    var0 = (rng.rand(C) + 0.5).astype(np.float32)
    cot = rng.randn(N, C).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0),
                                 "var": jnp.asarray(var0)}}
    mod = JaxMaskedBN(eps=eps, momentum=momentum)

    def jfn(x_, params):
        y, upd = mod.apply({**variables, "params": params}, x_,
                           jnp.asarray(mask), use_running_average=False,
                           mutable=["batch_stats"])
        return y, upd["batch_stats"]
    ref, stats = jfn(jnp.asarray(x), variables["params"])
    _, vjp = jax.vjp(lambda x_, p: jfn(x_, p)[0], jnp.asarray(x),
                     variables["params"])
    ref_dx, ref_dp = vjp(jnp.asarray(cot))

    bn = BatchNorm(C, eps, momentum)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    bn.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    got = masked_batch_norm(bn, xt, torch.from_numpy(mask))
    got.backward(torch.from_numpy(cot))
    _close(got.detach(), ref)
    _close(xt.grad, ref_dx)
    _close(bn.weight.grad, ref_dp["scale"])
    _close(bn.bias.grad, ref_dp["bias"])
    _close(bn.running_mean, stats["mean"])
    _close(bn.running_var, stats["var"])
    assert float(xt.grad[torch.from_numpy(~mask)].abs().max()) == 0.0

    bn.eval()
    ref_eval = mod.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                         use_running_average=True)
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
        _close(masked_batch_norm(bn, torch.from_numpy(x),
                                 torch.from_numpy(mask)), ref_eval, 1e-6)


# ---------------------------------------------------------------------------
# (e) conv_acc
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,dims", [("float32", 2), ("bfloat16", 2),
                                        ("float32", 3), ("bfloat16", 3)])
def test_conv_is_jax_conv_f32acc(dtype, dims):
    """JAX's conv_f32acc(...).astype(x.dtype), as its callers round it,
    against the port's conv(F.conv{2,3}d, ...): forward, dx and dw."""
    rng = np.random.RandomState(7)
    sp = (9, 8) if dims == 2 else (6, 5, 4)
    x = rng.randn(2, *sp, 6).astype(np.float32)
    w = (rng.randn(*(3,) * dims, 6, 5) * 0.3).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xj, wj = jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd)
    pads = ((1, 1),) * dims
    stride = (2,) + (1,) * (dims - 1)

    def jfn(x_, w_):
        if dims == 2:
            out = conv2d_f32acc(x_, w_, stride, pads)
        else:
            out = conv_f32acc(x_, w_, stride, pads, 1,
                              ("NXYZC", "XYZIO", "NXYZC"))
        return out.astype(x_.dtype)
    ref, vjp = jax.vjp(jfn, xj, wj)
    cot = rng.randn(*ref.shape).astype(np.float32)
    ref_dx, ref_dw = vjp(jnp.asarray(cot).astype(jd))

    perm_x = (0, dims + 1) + tuple(range(1, dims + 1))
    perm_w = (dims + 1, dims) + tuple(range(dims))
    xt = torch.from_numpy(x).to(td).permute(*perm_x).detach() \
        .requires_grad_(True)
    # the port's weights are fp32 parameters cast at the call
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32))).permute(
        *perm_w).contiguous().requires_grad_(True)
    fn = F.conv2d if dims == 2 else F.conv3d
    got = conv(fn, xt, wt, None, stride, 1)
    inv_x = (0,) + tuple(range(2, dims + 2)) + (1,)
    got.backward(torch.from_numpy(cot).to(td).permute(*perm_x))
    assert got.dtype == td
    rel = BF16_ULP if dtype == "bfloat16" else REL
    _close(got.detach().float().permute(*inv_x).numpy(),
           np.asarray(ref.astype(jnp.float32)), rel)
    _close(xt.grad.float().permute(*inv_x).numpy(),
           np.asarray(ref_dx.astype(jnp.float32)), rel)
    inv_w = tuple(range(2, dims + 2)) + (1, 0)
    _close(wt.grad.permute(*inv_w).numpy(),
           np.asarray(ref_dw.astype(jnp.float32)), rel)
