"""Row gathers whose gradient sums each row's cotangents in fp32, in a fixed
order.

`table[idx]` has the gather's own gradient in PyTorch: on the card it sorts
the indices and walks each run of equal ones in a single warp, so one row
read by many points (an out-of-range point clamped to row 0, a pixel read
at every depth bin) serializes the backward: the flagship's bf16 train step
spent 362 of its 621 ms of device time there on an H100 (`chip_smoke.py`'s
train profile). The transpose of JAX's gather is a scatter-add. An
`index_add_` into an fp32 buffer computes it, but its atomics sum in an
order that changes from run to run on the card, so two train steps from
one state differed.

Here the backward sorts the indices stably and sums each row's run of
cotangents by segment (`torch.segment_reduce`, as the lift-splat's forward
does, ops/lift_splat.py), in fp32, rounded once to the table's dtype:
`sorted_segment_sum`. segment_reduce walks a segment in one thread per
channel, so a row read 10^5 times would take as long as `x[idx]`'s own
backward; the runs are therefore cut into pieces of at most about sqrt(M)
values, summed in one pass, and each row's pieces summed in a second, a
tree of fixed shape: the order of every sum depends on the indices alone.

Without a gradient to take (eval, or a table that needs none) the gather is
`table[idx]` itself: the eval forward's ops stay a plain gather.
"""
from __future__ import annotations

import math

import torch

CHUNK = 32   # the fewest values a piece holds (see sorted_segment_sum)


def piece_size(M: int) -> int:
    """The most values a piece of sorted_segment_sum holds, over M values:
    max(CHUNK, ceil(sqrt(M))), so that a row has at most as many pieces."""
    return max(CHUNK, math.isqrt(M - 1) + 1 if M else 0)


def sorted_segment_sum(v: torch.Tensor, ids: torch.Tensor,
                       rows: int) -> torch.Tensor:
    """v [M, ...] with ids [M] (int64, non-decreasing, in [0, rows)) ->
    [rows, ...]: row r the sum of the v whose id is r, in v's dtype. The
    values are cut into pieces at every row's start and at every multiple
    of piece_size(M) positions; each piece is summed in order (one
    segment_reduce), then each row's pieces in order (a second): every sum
    has at most about sqrt(M) + 1 terms and an order fixed by `ids`. A row without values sums to 0. No host sync:
    every size follows from M and rows."""
    dev = ids.device
    M = v.shape[0]
    chunk = piece_size(M)
    # row r's values are v[first[r]:first[r + 1]]
    first = torch.searchsorted(ids, torch.arange(rows + 1, device=dev))
    # the pieces' starts, in order: the rows' (an empty row's moved past
    # the end, where its piece belongs to no row) and the cuts
    starts = torch.where(first[1:] > first[:-1], first[:-1], M)
    starts = torch.cat([starts, torch.arange(0, M, chunk, device=dev)])
    starts = torch.sort(starts).values
    pieces = torch.segment_reduce(v, "sum", lengths=torch.diff(
        starts, append=starts.new_full((1,), M)), unsafe=True)
    # row r's pieces are those that start in [first[r], first[r + 1])
    return torch.segment_reduce(pieces, "sum", lengths=torch.searchsorted(
        starts, first).diff(), unsafe=True)


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
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        acc = sorted_segment_sum(g.reshape((-1,) + row)[order].float(),
                                 flat[order], ctx.rows)
        return acc.to(g.dtype), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [R, ...] at the int64 rows idx [...] -> [*idx.shape, ...], as
    `table[idx]`; its gradient sums each row's cotangents in fp32 in an
    order fixed by idx (sorted_segment_sum)."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table[idx]
    return _GatherRows.apply(table, idx)
