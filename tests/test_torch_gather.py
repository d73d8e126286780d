"""ops/gather.py: the row gather whose gradient sums in fp32."""
import numpy as np
import pytest
import torch

from coocc_tpu_torch.ops.gather import (gather_rows, piece_size,
                                        sorted_segment_sum)
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)


def _inputs(dtype):
    rs = np.random.RandomState(0)
    table = torch.from_numpy(rs.standard_normal((50, 3, 4)).astype(
        np.float32)).to(dtype).requires_grad_()
    # row 0 read 400 times, as the clamped out-of-range points read it
    idx = torch.from_numpy(np.concatenate([np.zeros(400, np.int64),
                                           rs.randint(0, 50, 300)]))
    g = torch.from_numpy(rs.standard_normal((700, 3, 4)).astype(
        np.float32)).to(dtype)
    return table, idx.reshape(28, 25), g.reshape(28, 25, 3, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_is_the_gather_with_fp32_summed_gradient(dtype):
    table, idx, g = _inputs(dtype)
    out = gather_rows(table, idx)
    assert torch.equal(out, table.detach()[idx])
    out.backward(g)
    ref = torch.zeros(50, 3, 4, dtype=torch.float64)
    ref.index_add_(0, idx.reshape(-1), g.reshape(-1, 3, 4).double())
    assert table.grad.dtype == dtype
    # the fp32 sum rounded once to the table's dtype: equal to the exact
    # sum's rounding but where the fp32 sum lands across a rounding
    # boundary (one bf16 ulp, 2^-8 relative)
    fp32 = dtype == torch.float32
    np.testing.assert_allclose(table.grad.double().numpy(),
                               ref.to(dtype).double().numpy(),
                               rtol=1e-5 if fp32 else 2.0 ** -8,
                               atol=1e-4 if fp32 else 0)


def test_gather_rows_without_a_gradient_is_the_plain_gather():
    table, idx, _ = _inputs(torch.float32)
    with torch.no_grad():
        out = gather_rows(table, idx)
    assert out.grad_fn is None and torch.equal(out, table[idx].detach())
    plain = gather_rows(table.detach(), idx)
    assert plain.grad_fn is None


def _index_add_sum(v, ids, rows):
    """The backward's earlier sum: an fp32 index_add_ in index order on the
    CPU (atomics on the card)."""
    return torch.zeros((rows,) + v.shape[1:]).index_add_(0, ids, v)


# (values, rows, how the indices fall): every value on row 0 (40,000, three
# levels of pieces), a row read at every depth bin among short runs, runs
# that straddle the pieces' cuts, fewer values than a piece, none at all
_CASES = [(40000, 1, "one row"), (30000, 300, "one heavy row"),
          (5000, 2000, "short runs"), (7, 5, "short"), (0, 4, "empty")]


def _sorted_case(M, rows, kind, rs, dyadic):
    if kind == "one heavy row":
        ids = np.concatenate([np.zeros(M - M // 4, np.int64),
                              rs.randint(0, rows, M // 4)])
    else:
        ids = rs.randint(0, rows, M)
    ids = np.sort(ids)
    v = (rs.randint(-512, 512, (M, 3)) / 1024.0 if dyadic
         else rs.standard_normal((M, 3))).astype(np.float32)
    return torch.from_numpy(v), torch.from_numpy(ids)


@pytest.mark.parametrize("M,rows,kind", _CASES)
def test_sorted_segment_sum_is_the_exact_sum_on_dyadic_values(M, rows,
                                                               kind):
    """Values on a grid of 2^-10 below 1/2: every partial sum is exact in
    fp32, so every order gives the exact sum: the tree of pieces and the
    old index_add_ agree bit for bit, and each row is its exact sum."""
    v, ids = _sorted_case(M, rows, kind, np.random.RandomState(1), True)
    got = sorted_segment_sum(v, ids, rows)
    exact = np.zeros((rows, 3))
    np.add.at(exact, ids.numpy(), v.numpy().astype(np.float64))
    assert torch.equal(got, _index_add_sum(v, ids, rows))
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))


@pytest.mark.parametrize("M,rows,kind", _CASES)
def test_sorted_segment_sum_within_fp32_of_the_exact_sum(M, rows, kind):
    """Random values: the tree's sums lie within the fp32 bound of any
    order (n * 2^-24 * sum |v| a row) of the exact sums and no farther
    from them than the old index_add_ order, where a row read 30,000 times
    drifts by many ulps; a row whose values lie in one piece is summed in
    index order, equal to index_add_ bit for bit."""
    v, ids = _sorted_case(M, rows, kind, np.random.RandomState(2), False)
    got = sorted_segment_sum(v, ids, rows).numpy().astype(np.float64)
    old = _index_add_sum(v, ids, rows).numpy().astype(np.float64)
    exact = np.zeros((rows, 3))
    np.add.at(exact, ids.numpy(), v.numpy().astype(np.float64))
    mag = np.zeros((rows, 3))
    np.add.at(mag, ids.numpy(), np.abs(v.numpy()).astype(np.float64))
    n = np.bincount(ids.numpy(), minlength=rows)[:, None]
    assert (np.abs(got - exact) <= n * 2.0 ** -24 * mag).all()
    assert np.abs(got - exact).max() <= np.abs(old - exact).max()
    first = np.searchsorted(ids.numpy(), np.arange(rows + 1))
    k = piece_size(M)
    short = first[:-1] // k == (first[1:] - 1) // k
    np.testing.assert_array_equal(got[short], old[short])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_backward_repeats_and_reads_every_depth_bin(dtype):
    """A lift-splat-like read: every pixel at each of 112 depth bins and
    an out-of-range sink on row 0 read 20,000 times, in shuffled order.
    Two backward passes give the same bits, and both equal the fixed-order
    sum of the sorted cotangents rounded once."""
    rs = np.random.RandomState(3)
    pix = np.tile(np.arange(64), 112)
    idx = np.concatenate([pix, np.zeros(20000, np.int64)])
    idx = torch.from_numpy(idx[rs.permutation(idx.size)])
    g = torch.from_numpy(rs.standard_normal((idx.numel(), 8)).astype(
        np.float32)).to(dtype)
    grads = []
    for _ in range(2):
        table = torch.zeros(64, 8, dtype=dtype, requires_grad=True)
        gather_rows(table, idx).backward(g)
        grads.append(table.grad)
    assert torch.equal(grads[0], grads[1])
    order = torch.argsort(idx, stable=True)
    want = sorted_segment_sum(g[order].float(), idx[order], 64).to(dtype)
    assert torch.equal(grads[0], want)
