"""K2's backward kernels: their host tables and what the CPU computes.

The dX kernel (`subm_ext_conv_dx`, csrc/subm_conv_bwd.cuh) keeps a column
group's weight panels in shared memory at p >= 4; the dW kernel
(`subm_ext_weight_grad`, csrc/subm_conv_dw.cuh) has warpgroups multiply 4
K-blocks' x^T by a 32-column window of the tap-shifted cotangent (wgmma
m64n96k16), in units of two warpgroups, over shape-only splits of the
cells, and reduces the splits in order. Both run only on the card, where
chip_smoke.py holds them against their plain versions. Here, on the CPU:

  * the dX tables hold exactly the nonzero blocks of JAX's
    `_subm_ext_weight` of the mirrored taps, group by group, address the
    lanes JAX's `_shift_ext` builds, and the conv they describe (each
    group's K-blocks against its panels, as the kernel walks them) is the
    plain dX;
  * the dW units keep to the kernel's limits, their warpgroups cover
    every nonzero (extended lane, column) element of JAX's extended weight
    once and the reduce writes no other (at every level's shape, and at
    three with C != Co that the kernel also takes), the splits cover every tile once
    and depend on the shapes alone, and a numpy walk of the kernel's loops
    (x tiles at the carries' packs, dy halos zero outside the grid, the
    warpgroups' 64 x 32 sums a tap, the split partials summed in order)
    gives the plain dW; the fp32 cotangent's three bf16 parts sum to it
    exactly;
  * the wrappers take the plain versions on CPU tensors, leave their
    launch counters at 0, and raise on any other device (no fallback).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.nn import sparse_enc_packed as jpk

from coocc_tpu_torch.ops.subm_conv import (
    DW_COLS, DW_MAX_KB, DW_MAX_WIN, DW_ROW, DW_TILES_PER_SPLIT, KB,
    N_LANES, _dx_index, _dx_table, _dw_table, dw_splits, dw_tiles, dw_units,
    dw_windows, dx_groups,
    dx_weight_panels,
    dy_parts, flip_taps, kblocks, shift_ext, subm_conv, subm_ext_conv_dx,
    subm_ext_conv_dx_plain, subm_ext_table, subm_ext_weight,
    subm_ext_weight_grad, subm_ext_weight_grad_plain)
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

PACKINGS = [1, 2, 4, 8]      # p, with C = Co = 128 / p as in every level
# (p, C, Co) for the dW tables: every level's, and shapes the dW kernel
# also takes (p*Co = 128, C a multiple of 16, p*C whole 128-lane rows)
DW_SHAPES = [(p, N_LANES // p, N_LANES // p) for p in PACKINGS] + [
    (8, 32, 16), (4, 64, 32), (2, 128, 64)]


def _split_ranges(T, S):
    """The tile ranges [start, stop) of the dW kernel's S splits, as it
    cuts them."""
    return [(T * s // S, T * (s + 1) // S) for s in range(S)]


def _bf16_valued(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.randn(*shape)).astype(
        np.float32)).to(torch.bfloat16).float()


def _case(p, B=1, bz=3, X=19, Y=21, seed=0):
    """bf16-valued x, w27 and cotangent (the roundings the kernels make
    are then exact), on a grid that is not a multiple of the 16 x 16
    tile."""
    rng = np.random.RandomState(seed + p)
    C = N_LANES // p
    x = _bf16_valued(rng, B, bz, X, Y, p * C)
    w27 = _bf16_valued(rng, 27, C, C, scale=0.1)
    dy = _bf16_valued(rng, B, bz, X, Y, p * C)
    return x, w27, dy


# ---------------------------------------------------------------------------
# dX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", PACKINGS)
def test_dx_panels_hold_exactly_the_mirrored_nonzero_blocks(p):
    """The dX panels hold JAX's extended weight of the mirrored taps at
    their positions, each position once, and skip only its structural
    zeros; a resident group's panels take 110,592 bytes (p >= 4)."""
    C = N_LANES // p
    w27 = np.random.RandomState(p).randn(27, C, C).astype(np.float32)
    wf = flip_taps(torch.from_numpy(w27))
    jw = np.asarray(jpk._subm_ext_weight(jnp.asarray(wf.numpy()),
                                         p)).reshape(-1)
    idx = _dx_index(p, C, C)
    assert len(np.unique(idx)) == len(idx)
    panels = dx_weight_panels(torch.from_numpy(w27), p)
    assert panels.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        panels.float().numpy(),
        torch.from_numpy(jw[idx]).to(torch.bfloat16).float().numpy())
    skipped = np.ones(jw.size, bool)
    skipped[idx] = False
    assert not jw[skipped].any()
    assert skipped.sum() * (p + 2) == jw.size * (p - 1)
    table, nkb, base = _dx_table(p, C, C)
    if p >= 4:       # resident: groups of 110,592 bytes
        assert len(nkb) == C // KB and (np.diff(base) == 110_592).all()
    else:            # streamed: one group
        assert len(nkb) == 1
    assert base[-1] == 2 * len(idx)


@pytest.mark.parametrize("p", PACKINGS)
def test_dx_groups_address_jax_extended_lanes(p):
    """Each group row is a K-block of `kblocks` (whose lanes and pack
    offsets address JAX's `_shift_ext`, tests/test_torch_subm_conv.py) with
    its window cut to the group; the groups tile the output lanes and each
    output lane is fed by 3C/16 K-blocks."""
    C = N_LANES // p
    x = np.random.RandomState(p).randn(2, 3, 4, 5, p * C).astype(np.float32)
    ext = np.asarray(jpk._shift_ext(jnp.asarray(x), C))
    blocks = kblocks(p, C, C)
    groups = dx_groups(p, C, C)
    width = N_LANES // len(groups)
    assert width == (16 * p if p >= 4 else N_LANES)
    feeds = np.zeros(N_LANES, int)
    for gc, rows in enumerate(groups):
        for i, lane, dg, a, w in rows:
            l0, d0, c0, w0 = blocks[i]
            assert (lane, dg) == (l0, d0)
            assert gc * width <= a < a + w <= (gc + 1) * width
            assert c0 <= a and a + w <= c0 + w0
            feeds[a:a + w] += 1
            src = np.roll(x[..., lane:lane + KB], -dg, axis=1)
            if dg == 1:
                src[:, -1] = 0
            elif dg == -1:
                src[:, 0] = 0
            np.testing.assert_array_equal(ext[..., i * KB:(i + 1) * KB], src)
    assert (feeds == 3 * C // KB).all()
    table, nkb, _ = _dx_table(p, C, C)
    for gc, rows in enumerate(groups):
        assert nkb[gc] == len(rows)
        np.testing.assert_array_equal(
            table[gc, :len(rows)],
            [(lane, dg, a - gc * width, w) for _, lane, dg, a, w in rows])


def _dx_walk(dy_pb, w27, p):
    """The dX kernel's loops in torch (fp32): for each group, each of its
    K-blocks' 16 cotangent lanes (at the carry's pack) against its panel,
    the 9 taps' shifted rows, summed into the group's columns."""
    B, bz, X, Y, L = dy_pb.shape
    C = L // p
    wf = flip_taps(w27)
    w_ext = subm_ext_weight(wf, p).reshape(9, -1, N_LANES)
    ext = shift_ext(dy_pb, C).reshape(B * bz, X, Y, -1)
    pad = torch.nn.functional.pad(ext, (0, 0, 1, 1, 1, 1))
    out = torch.zeros(B * bz, X, Y, N_LANES)
    for rows in dx_groups(p, C, C):
        for i, _, _, a, w in rows:
            for kx in range(3):
                for ky in range(3):
                    src = pad[:, kx:kx + X, ky:ky + Y, i * KB:(i + 1) * KB]
                    out[..., a:a + w] += src @ w_ext[3 * kx + ky,
                                                     i * KB:(i + 1) * KB,
                                                     a:a + w]
    return out.reshape(B, bz, X, Y, N_LANES)


@pytest.mark.parametrize("p", PACKINGS)
def test_dx_walk_is_the_plain_dx(p):
    x, w27, dy = _case(p)
    ref = subm_ext_conv_dx_plain(dy, w27, p)
    got = _dx_walk(dy, w27, p)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


# ---------------------------------------------------------------------------
# dW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,C,Co", DW_SHAPES)
def test_dw_units_keep_to_the_kernels_limits(p, C, Co):
    """Each unit lands at most DW_MAX_KB x tiles and DW_MAX_WIN windows of
    DW_COLS whole 8-column chunks inside the 128 output lanes; each
    warpgroup reads one of its windows and x tiles it lands, each once (the
    second may have none); at most 16 units; the host rows are DwUnit's layout with the K-blocks of
    `kblocks` (extended index, lane, pack offset, window)."""
    blocks = kblocks(p, C, Co)
    units = dw_units(p, C, Co)
    table = _dw_table(p, C, Co)
    assert table.shape == (len(units), DW_ROW) and 1 <= len(units) <= 16
    for row, (kbs, cols, wgs) in zip(table, units):
        assert 1 <= len(kbs) <= DW_MAX_KB and 1 <= len(cols) <= DW_MAX_WIN
        assert len(set(kbs)) == len(kbs) and len(wgs) == 2
        assert all(c % 8 == 0 and 0 <= c <= N_LANES - DW_COLS for c in cols)
        for w, xs in wgs:
            assert 0 <= w < len(cols) and len(xs) == 4
            used = [x for x in xs if x >= 0]
            assert len(set(used)) == len(used)
            assert all(x < len(kbs) for x in used)
        assert max(wgs[0][1]) >= 0
        n, m = len(kbs), len(cols)
        assert list(row[:4]) == [n, m, *cols, *[0] * (DW_MAX_WIN - m)]
        assert list(row[4:14]) == [w for w, _ in wgs] + [x for _, xs in wgs
                                                         for x in xs]
        fields = row[14:].reshape(5, DW_MAX_KB)[:, :n]
        for k, i in enumerate(kbs):
            lane, dg, c0, w = blocks[i]
            assert tuple(fields[:, k]) == (i, lane, dg, c0, c0 + w)


@pytest.mark.parametrize("p,C,Co", DW_SHAPES)
def test_dw_units_cover_every_nonzero_element_once(p, C, Co):
    """Every (extended lane, output column) element of JAX's extended
    weight that is not a structural zero is summed by exactly one
    (unit, warpgroup, warp) whose window holds the column, and the reduce
    (a warp's x tile and the column inside its K-block's nonzero columns)
    writes exactly those elements; a K-block's lanes address JAX's
    `_shift_ext` at its lane and pack offset."""
    w27 = np.random.RandomState(p).randn(27, C, Co).astype(np.float32) + 3
    jw = np.asarray(jpk._subm_ext_weight(jnp.asarray(w27), p))
    nz = (np.abs(jw).sum(axis=(0, 1)) > 0).astype(int)   # [E, 128]
    seen = np.zeros_like(nz)
    written = np.zeros_like(nz)
    blocks = kblocks(p, C, Co)
    for kbs, cols, wgs in dw_units(p, C, Co):
        for w, xs in wgs:
            c = cols[w]
            for x in xs:
                if x < 0:
                    continue
                i = kbs[x]
                _, _, c0, width = blocks[i]
                rows = slice(i * KB, (i + 1) * KB)
                seen[rows, c:c + DW_COLS] += nz[rows, c:c + DW_COLS]
                lo, hi = max(c, c0), min(c + DW_COLS, c0 + width)
                written[rows, lo:hi] += 1
    np.testing.assert_array_equal(seen, nz)
    np.testing.assert_array_equal(written, nz)
    x = np.random.RandomState(p).randn(2, 3, 4, 5, p * C).astype(np.float32)
    ext = np.asarray(jpk._shift_ext(jnp.asarray(x), C))
    for i, (lane, dg, _, _) in enumerate(blocks):
        src = np.roll(x[..., lane:lane + KB], -dg, axis=1)
        src[:, -1 if dg == 1 else 0] *= dg == 0
        np.testing.assert_array_equal(ext[..., i * KB:(i + 1) * KB], src)
    # each window's K-blocks are those whose nonzero columns meet it
    for j, ks in enumerate(dw_windows(p, C, Co)):
        meets = nz[:, j * DW_COLS:(j + 1) * DW_COLS].reshape(
            -1, KB, DW_COLS).any(axis=(1, 2))
        assert ks == list(np.flatnonzero(meets))


@pytest.mark.parametrize("G,X,Y", [
    (8, 400, 400), (9, 800, 800), (10, 512, 512), (8, 200, 200),
    (9, 100, 100), (3, 19, 21), (1, 5, 7)])
def test_dw_splits_cover_every_tile_once_by_shape_alone(G, X, Y):
    """The splits cut the tiles into contiguous ranges of at most
    DW_TILES_PER_SPLIT that cover each tile once, none empty; S is a
    function of the tiles alone."""
    T = dw_tiles(G, X, Y)
    assert T == G * -(-X // 16) * -(-Y // 16)
    S = dw_splits(T)
    assert 1 <= S <= T and S == dw_splits(T)
    ranges = _split_ranges(T, S)
    assert ranges[0][0] == 0 and ranges[-1][1] == T
    assert all(a < b for a, b in ranges)
    assert all(r[1] == n[0] for r, n in zip(ranges, ranges[1:]))
    assert max(b - a for a, b in ranges) <= DW_TILES_PER_SPLIT


def _dw_walk(x_pb, dy_pb, p):
    """The dW kernel's loops in numpy (float64 sums of the bf16-valued
    operands, i.e. exact up to the final rounding): per unit, split and
    warpgroup, each tile's A (its 4 warps' x tiles as 64 rows of lanes,
    zero for a skipped carry or a warp without a K-block) against B (the
    window's 32 columns of the dy halo at the tap's shifted sites, zero
    outside the grid), one 64 x 32 sum a tap; then the reduce: the split
    partials summed in order, kept where a warp's K-block is nonzero at
    the column, into the extended gradient."""
    B, bz, X, Y, pC = x_pb.shape
    C, Co, G = pC // p, N_LANES // p, B * bz
    E = (p + 2) * C
    xg = x_pb.double().numpy().reshape(G, X, Y, pC)
    dg_ = dy_pb.double().numpy().reshape(G, X, Y, N_LANES)
    Xp, Yp = -(-X // 16) * 16, -(-Y // 16) * 16
    xpad = np.zeros((G, Xp, Yp, pC))
    xpad[:, :X, :Y] = xg
    dpad = np.zeros((G, Xp + 2, Yp + 2, N_LANES))
    dpad[:, 1:X + 1, 1:Y + 1] = dg_
    blocks = kblocks(p, C, Co)
    T = dw_tiles(G, X, Y)
    S = dw_splits(T)
    ny = Yp // 16
    gw = np.zeros((9, E, N_LANES))
    for kbs, cols, wgs in dw_units(p, C, Co):
        for w, xs in wgs:
            c = cols[w]
            part = np.zeros((9, 64, DW_COLS))
            for t0, t1 in _split_ranges(T, S):
                acc = np.zeros((9, 64, DW_COLS))
                for t in range(t0, t1):
                    g, x0, y0 = t % G, t // (G * ny) * 16, t // G % ny * 16
                    a = np.zeros((256, 64))
                    for q, x in enumerate(xs):
                        if x < 0:
                            continue
                        lane, dg = blocks[kbs[x]][:2]
                        if (dg > 0 and g % bz == bz - 1) or (
                                dg < 0 and g % bz == 0):
                            continue
                        a[:, 16 * q:16 * q + 16] = xpad[
                            g + dg, x0:x0 + 16, y0:y0 + 16,
                            lane:lane + KB].reshape(256, KB)
                    for kx in range(3):
                        for ky in range(3):
                            b = dpad[g, x0 + 2 - kx:x0 + 18 - kx,
                                     y0 + 2 - ky:y0 + 18 - ky,
                                     c:c + DW_COLS].reshape(256, -1)
                            acc[3 * kx + ky] += a.T @ b
                part += acc
            for q, x in enumerate(xs):
                if x < 0:
                    continue
                i = kbs[x]
                _, _, c0, width = blocks[i]
                for n in range(DW_COLS):
                    if c0 <= c + n < c0 + width:
                        gw[:, i * KB:(i + 1) * KB, c + n] = \
                            part[:, 16 * q:16 * q + 16, n]
    return gw.reshape(3, 3, E, N_LANES)


@pytest.mark.parametrize("p,C,Co", DW_SHAPES)
def test_dw_walk_is_the_plain_dw(p, C, Co):
    """The kernel's walk gives the extended gradient of the plain version
    (the same bf16 products, other summation orders), folded by the same
    `gather_taps_transpose`."""
    from coocc_tpu_torch.ops.subm_conv import gather_taps_transpose
    rng = np.random.RandomState(p + C)
    x = _bf16_valued(rng, 1, 3, 19, 35, p * C)
    dy = _bf16_valued(rng, 1, 3, 19, 35, p * Co)
    gw = _dw_walk(x, dy, p)
    got = gather_taps_transpose(torch.from_numpy(gw).float(),
                                subm_ext_table(p), C, Co)
    ref = subm_ext_weight_grad_plain(x, dy, p)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


def test_dy_parts_sum_to_the_cotangent_exactly():
    rng = np.random.RandomState(0)
    dy = torch.from_numpy((rng.randn(4096) * np.exp(
        rng.uniform(-20, 20, 4096))).astype(np.float32))
    parts = dy_parts(dy)
    assert len(parts) == 3 and all(t.dtype == torch.bfloat16 for t in parts)
    total = parts[0].double() + parts[1].double() + parts[2].double()
    assert torch.equal(total, dy.double())
    b = dy.to(torch.bfloat16)
    assert dy_parts(b) == [b]


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrappers_take_the_plain_versions(dtype):
    """CPU tensors take the plain versions, bit for bit, and leave the
    launch counters at 0; so does `subm_conv`'s backward."""
    p = 4
    x, w27, dy = _case(p, bz=2, X=9, Y=11)
    x, dy = x.to(dtype), dy.to(dtype)
    subm_ext_conv_dx.launches = subm_ext_weight_grad.launches = 0
    assert torch.equal(subm_ext_conv_dx(dy, w27, p),
                       subm_ext_conv_dx_plain(dy, w27, p))
    assert torch.equal(subm_ext_weight_grad(x, dy, p),
                       subm_ext_weight_grad_plain(x, dy, p))
    mcell = torch.ones(x.shape[:-1] + (p,), dtype=torch.bool)
    xr = x.clone().requires_grad_()
    wr = w27.clone().requires_grad_()
    subm_conv(xr, wr, p, mcell).backward(dy)
    assert torch.equal(xr.grad, subm_ext_conv_dx_plain(dy, w27, p))
    assert torch.equal(wr.grad, subm_ext_weight_grad_plain(x, dy, p))
    assert subm_ext_conv_dx.launches == subm_ext_weight_grad.launches == 0


def test_other_devices_raise_and_never_take_a_plain_version():
    """A tensor off the CPU goes to the kernels' launchers, which raise on
    a device that is not CUDA (here the meta device) before any build."""
    p = 4
    x = torch.empty((1, 2, 9, 11, 128), device="meta")
    w27 = torch.empty((27, 32, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        subm_ext_conv_dx(x, w27, p)
    with pytest.raises(ValueError, match="unsupported device meta"):
        subm_ext_weight_grad(x, x, p)
    assert subm_ext_conv_dx.launches == subm_ext_weight_grad.launches == 0
