"""ops/gather.py: the row gather whose gradient sums in fp32."""
import numpy as np
import pytest
import torch

from coocc_tpu_torch.ops.gather import gather_rows
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
