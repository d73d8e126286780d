"""K1's column tables, and a numpy walk over them that equals the plain
version.

The CUDA kernel (csrc/window_knn.cu) walks the window's (dx, dy) columns in
the order of `column_tables`, finds each column's nearest active dz above
and below the cell with bit operations on a packed word, and stops before
the first column whose smallest rank is not below its second rank. The
kernel runs only on the card; `_column_walk` repeats its steps in numpy,
pruning included, so the tables and the stopping rule are held here against
`window_knn_plain` (which tests/test_torch_window_knn.py holds against the
JAX package). chip_smoke.py holds the kernel against the same plain version
on the card.
"""
import numpy as np
import pytest
import torch

from coocc_tpu_torch.ops.window_knn import (WALK_CHUNK, best2_ranks_plain,
                                            column_tables, make_offsets,
                                            window_knn_plain)
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)

SHAPES = [(10, 9, 4), (20, 20, 8), (37, 23, 5)]
RADII = [(4, 4, 3), (4, 4, 7), (6, 6, 7)]
DENSITIES = [0.0, 0.02, 0.3, 1.0]
WINDOWS = {"flagship pts": make_offsets(6, 6, 7, 13.3),
           "flagship img": make_offsets(4, 4, 7, 13.3),
           "clipped": make_offsets(6, 6, 7, 8.0),
           "openoccupancy": make_offsets(8, 8, 9, 13.3)}


def _highest_bit(v):
    return np.frexp(v.astype(np.float64))[1] - 1


def _column_walk(mask, offsets):
    """(best1, best2) ranks [X*Y*Z] (O = none) and the columns each cell
    walked, by the kernel's steps: one word per (x, y) column, the column's
    allowed dz bits, two nearest set bits above z (lowest first) and below
    z (highest first), their ranks from the table, columns taken WALK_CHUNK
    at a time, stop before a chunk whose first column's smallest rank is
    not below the second rank."""
    t = column_tables(offsets)
    O = len(offsets)
    X, Y, Z = mask.shape
    rz = t.ranks.shape[1] // 2
    rx, ry = np.abs(t.dxdy).max(axis=0)
    words = (mask.astype(np.uint64)
             << np.arange(Z, dtype=np.uint64)).sum(axis=-1)
    words = np.pad(words, ((rx, rx), (ry, ry)))
    z = np.arange(Z, dtype=np.int64)
    below = (np.uint64(1) << z.astype(np.uint64)) - np.uint64(1)
    r1 = np.full((X, Y, Z), O, np.int64)
    r2 = np.full((X, Y, Z), O, np.int64)
    steps = np.zeros((X, Y, Z), np.int64)
    mask32 = np.uint64(0xFFFFFFFF)
    for c, ((dx, dy), row, allow) in enumerate(zip(t.dxdy, t.ranks,
                                                    t.allow)):
        if c % WALK_CHUNK == 0:
            live = t.min_rank[c] < r2
            if not live.any():
                break
            steps += WALK_CHUNK * live
        allowed = (allow >> (32 - z).astype(np.uint64)) & mask32
        w = words[rx + dx:rx + dx + X, ry + dy:ry + dy + Y, None] & allowed
        w = np.where(live, w, np.uint64(0))
        up, dn = w & ~below, w & below
        for part, lowest in ((up, True), (dn, False)):
            for _ in range(2):
                has = part != 0
                if lowest:
                    bit = part & (~part + np.uint64(1))
                    p = _highest_bit(bit)
                else:
                    p = _highest_bit(np.where(has, part, 1))
                    bit = np.uint64(1) << p.astype(np.uint64)
                r = np.where(has, row[np.clip(p - z + rz, 0, 2 * rz)], O)
                r2 = np.minimum(r2, np.maximum(r1, r))
                r1 = np.minimum(r1, r)
                part = np.where(has, part ^ bit, part)
    return r1.reshape(-1), r2.reshape(-1), steps.reshape(-1)


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_column_tables(name):
    offsets = WINDOWS[name]
    t = column_tables(offsets)
    O = len(offsets)
    rz = t.ranks.shape[1] // 2
    # every offset appears exactly once, at its make_offsets rank
    c, j = np.nonzero(t.ranks < O)
    found = np.concatenate([t.dxdy[c], (j - rz)[:, None]], axis=1)
    rank = t.ranks[c, j]
    assert len(rank) == O and sorted(rank) == list(range(O))
    np.testing.assert_array_equal(found[np.argsort(rank)], offsets)
    # columns sorted by their smallest rank, each column once
    np.testing.assert_array_equal(t.min_rank, t.ranks.min(axis=1))
    assert (np.diff(t.min_rank) > 0).all()
    assert len(np.unique(t.dxdy, axis=0)) == len(t.dxdy)
    # clipped dz are O, and the allow mask holds exactly the kept ones
    dz = np.arange(-rz, rz + 1)
    norm = np.sqrt((t.dxdy ** 2).sum(axis=1)[:, None] + dz[None] ** 2)
    np.testing.assert_array_equal(t.ranks < O, norm < 13.3 if name !=
                                  "clipped" else norm < 8.0)
    bits = (t.allow[:, None] >> (dz + 32).astype(np.uint64)) & np.uint64(1)
    np.testing.assert_array_equal(bits == 1, t.ranks < O)
    # the kernel's layout: (dx << 16 | dy & 0xffff, min rank, allow low,
    # allow high) per column, then the rank rows
    packed = t.packed()
    NC = len(t.dxdy)
    assert packed.dtype == np.int32 and packed.shape == (NC * (4 + 2 * rz
                                                               + 1),)
    head = packed[:4 * NC].reshape(NC, 4)
    np.testing.assert_array_equal(head[:, 0] >> 16, t.dxdy[:, 0])
    np.testing.assert_array_equal(head[:, 0].astype(np.int16), t.dxdy[:, 1])
    np.testing.assert_array_equal(head[:, 1], t.min_rank)
    np.testing.assert_array_equal(head[:, 2:].view(np.uint32).astype(
        np.uint64) << np.uint64([0, 32]), np.stack(
            [t.allow & np.uint64(0xFFFFFFFF), t.allow & ~np.uint64(
                0xFFFFFFFF)], axis=1))
    np.testing.assert_array_equal(packed[4 * NC:], t.ranks.reshape(-1))


def _walk_vs_plain(mask, offsets):
    r1, r2, steps = _column_walk(mask, offsets)
    p1, p2 = best2_ranks_plain(torch.from_numpy(mask), offsets)
    np.testing.assert_array_equal(r1, p1.numpy())
    np.testing.assert_array_equal(r2, p2.numpy())
    # the walk visits the chunks up to the last column whose smallest rank
    # is <= the final second rank (chip_smoke.py counts the kernel's steps
    # so)
    t = column_tables(offsets)
    n = np.searchsorted(t.min_rank, p2.numpy(), side="right")
    np.testing.assert_array_equal(steps, -(-n // WALK_CHUNK) * WALK_CHUNK)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("radii", RADII)
@pytest.mark.parametrize("shape", SHAPES)
def test_column_walk_matches_plain(shape, radii, density):
    mask = np.random.RandomState(0).rand(*shape) < density
    _walk_vs_plain(mask, make_offsets(*radii, dist_thresh=13.3))


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("shape, window", [
    ((20, 20, 8), "clipped"), ((37, 23, 5), "clipped"),
    ((13, 11, 32), "flagship pts"), ((13, 11, 32), "openoccupancy")])
def test_column_walk_clipped_and_tall(shape, window, density):
    offsets = WINDOWS[window]
    mask = np.random.RandomState(1).rand(*shape) < density
    _walk_vs_plain(mask, offsets)
    ids = window_knn_plain(torch.from_numpy(mask), offsets).numpy()
    assert ids.shape == (*shape, 2)
