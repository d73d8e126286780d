"""The rulebook counts against a brute-force count at tiny sizes."""
import itertools

import numpy as np
import pytest
import torch

from occbench.work import sparse


def _brute_subm(active, grid):
    s = {tuple(a) for a in active}
    n = 0
    for a in s:
        for d in itertools.product((-1, 0, 1), repeat=3):
            b = tuple(x + y for x, y in zip(a, d))
            n += b in s
    return n


def _brute_down(active, grid, pad):
    out_grid = [(g + 2 * p - 3) // 2 + 1 for g, p in zip(grid, pad)]
    pairs, outs = 0, set()
    for o in itertools.product(*[range(g) for g in out_grid]):
        for k in itertools.product(range(3), repeat=3):
            i = tuple(2 * oo - p + kk for oo, p, kk in zip(o, pad, k))
            if i in active:
                pairs += 1
                outs.add(o)
    return sorted(outs), pairs


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pad", [(1, 1, 1), (1, 1, 0)])
def test_counts_match_brute_force(seed, pad):
    rng = np.random.default_rng(seed)
    grid = (9, 7, 6)
    n = rng.integers(5, 40)
    lin = np.unique(rng.integers(0, np.prod(grid), n))
    coords = torch.from_numpy(np.stack(np.unravel_index(lin, grid), -1))
    active = {tuple(c) for c in coords.tolist()}
    assert sparse.subm_pairs(coords, grid) == _brute_subm(active, grid)
    oc, og, pairs = sparse.down(coords, grid, pad)
    want_out, want_pairs = _brute_down(active, grid, pad)
    assert pairs == want_pairs
    assert [tuple(c) for c in oc.tolist()] == want_out


def test_encoder_work_flop_and_bytes():
    coords = torch.tensor([[1, 1, 1], [1, 1, 2], [4, 4, 4]])
    convs = [{"name": "a", "kind": "subm", "ci": 4, "co": 8, "k2": True},
             {"name": "b", "kind": "down", "ci": 8, "co": 16,
              "pad": [1, 1, 1]},
             {"name": "c", "kind": "point", "ci": 16, "co": 16}]
    w = sparse.encoder_work(convs, coords, (6, 6, 6), 2)
    assert w[0].pairs == 3 + 2 and w[0].flop == 2 * 4 * 8 * 5
    assert w[0].bytes == (3 * 4 + 3 * 8 + 27 * 4 * 8) * 2
    assert w[0].k2 and not w[1].k2
    assert w[2].pairs == len(sparse.down(coords, (6, 6, 6), (1, 1, 1))[0])


def test_active_voxels_cap_keeps_smallest_ids():
    pts = torch.tensor([[0.1, 0.1, 0.1], [0.9, 0.1, 0.1], [0.1, 0.9, 0.1],
                        [0.12, 0.1, 0.1], [5.0, 0.0, 0.0]])
    mask = torch.tensor([True, True, True, True, True])
    c = sparse.active_voxels(pts, mask, (0, 0, 0, 1, 1, 1), (0.25,) * 3,
                             (4, 4, 4), 2)
    assert c.tolist() == [[0, 0, 0], [0, 3, 0]]
