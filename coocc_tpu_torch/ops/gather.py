"""Row gathers whose gradient sums in fp32 with `index_add_`.

`table[idx]` has the gather's own gradient in PyTorch: on the card it sorts
the indices and walks each run of equal ones in a single warp, so one row
read by many points (an out-of-range point clamped to row 0, a pixel read
at every depth bin) serializes the backward: the flagship's bf16 train step
spent 362 of its 621 ms of device time there on an H100 (`chip_smoke.py`'s
train profile). The transpose of JAX's gather is a scatter-add; here it is
`index_add_` into an fp32 buffer (atomics on the card), rounded once to the
table's dtype.

Without a gradient to take (eval, or a table that needs none) the gather is
`table[idx]` itself: the eval forward's ops stay a plain gather.
"""
from __future__ import annotations

import torch


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        row = g.shape[idx.dim():]
        acc = g.new_zeros((ctx.rows,) + row, dtype=torch.float32)
        acc.index_add_(0, idx.reshape(-1), g.reshape((-1,) + row).float())
        return acc.to(g.dtype), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [R, ...] at the int64 rows idx [...] -> [*idx.shape, ...], as
    `table[idx]`; its gradient sums the rows' cotangents in fp32."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table[idx]
    return _GatherRows.apply(table, idx)
