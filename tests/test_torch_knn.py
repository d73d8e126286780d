"""The port's knn2 (CPU: its plain version) == the JAX Pallas knn2 kernel.

The JAX kernel runs in interpret mode, as tests/test_pallas_knn.py runs it.
On integer coordinates every squared distance is exact in fp32, so indices
and distances must be equal, ties included (the tile-and-merge rule decides
them the same way); on random floats the two are compared by distance to
1e-4, as tests/test_pallas_knn.py compares the kernel with numpy (the
returned distances to the expansion's fp32 cancellation error). Q and K
are not multiples of the tiles (256 queries, 512 keys), and K spans several
key tiles so the merge across tiles runs. The CUDA kernel runs only on the
card: chip_smoke.py holds it against the same plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.ops.pallas.knn import knn2 as jax_knn2

from coocc_tpu_torch.ops.knn import knn2
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)


def _both(queries, keys, qmask, kmask, thresh=13.3):
    got = knn2(torch.from_numpy(queries), torch.from_numpy(keys),
               torch.from_numpy(qmask), torch.from_numpy(kmask), thresh)
    ref = jax_knn2(jnp.asarray(queries), jnp.asarray(keys),
                   jnp.asarray(qmask), jnp.asarray(kmask), dist_thresh=thresh,
                   interpret=True)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    return [g.numpy() for g in got], [np.asarray(r) for r in ref]


@pytest.mark.parametrize("Q,K,box", [(300, 1300, 12), (257, 513, 6),
                                     (40, 2000, 30)])
def test_knn2_exact_on_integer_coordinates(Q, K, box):
    rng = np.random.RandomState(Q + K)
    queries = rng.randint(0, box, (Q, 3)).astype(np.float32)
    keys = rng.randint(0, box, (K, 3)).astype(np.float32)
    qmask = rng.rand(Q) > 0.1
    kmask = rng.rand(K) > 0.2
    (idx, dist), (ref_idx, ref_dist) = _both(queries, keys, qmask, kmask)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(dist, ref_dist)
    # ties are present: equal best distances with different keys
    assert (dist[:, 0] == dist[:, 1]).sum() > 0
    assert (idx >= 0).sum() > 0 and (idx < 0).sum() > 0


def test_knn2_random_floats_by_distance():
    rng = np.random.RandomState(7)
    Q, K = 300, 1100
    queries = rng.uniform(0, 50, (Q, 3)).astype(np.float32)
    keys = rng.uniform(0, 50, (K, 3)).astype(np.float32)
    qmask = rng.rand(Q) > 0.1
    kmask = rng.rand(K) > 0.1
    (idx, dist), (ref_idx, ref_dist) = _both(queries, keys, qmask, kmask)
    # the returned distances come from the expansion, whose cancellation at
    # |q|^2 + |k|^2 ~ 1.5e4 leaves d2 good to about 1e-3 either side
    # (measured 4.2e-4 apart in dist)
    np.testing.assert_allclose(dist, ref_dist, rtol=0, atol=2e-3)

    def d_of(q, i):
        return np.inf if i < 0 else np.linalg.norm(keys[i] - queries[q])

    for q in range(Q):
        for s in range(2):
            np.testing.assert_allclose(d_of(q, idx[q, s]),
                                       d_of(q, ref_idx[q, s]),
                                       rtol=1e-4, atol=1e-4)


def test_knn2_all_keys_masked():
    rng = np.random.RandomState(1)
    queries = rng.uniform(0, 10, (50, 3)).astype(np.float32)
    keys = np.zeros((600, 3), np.float32)
    (idx, dist), (ref_idx, ref_dist) = _both(
        queries, keys, np.ones(50, bool), np.zeros(600, bool))
    assert (idx == -1).all() and (ref_idx == -1).all()
    np.testing.assert_array_equal(dist, ref_dist)  # sqrt(1e30) each


def _tie_heavy(seed=3):
    """Integer keys in a 6-box with the tile before each 512-key boundary
    repeated after it, so equal distances straddle the boundaries; and one
    query far off whose keys 5 (d2 4), 515 (d2 1) and 519 (d2 4) make the
    TPU kernel's merge keep 519 where the lexicographic second is 5."""
    rng = np.random.RandomState(seed)
    K = 1300
    keys = rng.randint(0, 6, (K, 3)).astype(np.float32)
    keys[512:700] = keys[324:512]
    keys[1024:1200] = keys[848:1024]
    far = np.float32(100)
    keys[[5, 515, 519]] = far + np.array([[2, 0, 0], [1, 0, 0], [0, 2, 0]],
                                         np.float32)
    queries = rng.randint(0, 6, (301, 3)).astype(np.float32)
    queries[0] = far
    return queries, keys, rng.rand(301) > 0.05, rng.rand(K) > 0.1


def _lexicographic_best2(queries, keys, kmask):
    d2 = ((queries[:, None].astype(np.float64) - keys[None]) ** 2).sum(-1)
    d2 = np.where(kmask[None], d2, np.inf)
    order = np.lexsort((np.broadcast_to(np.arange(len(keys)), d2.shape), d2),
                       axis=1)
    return order[:, :2]


def test_knn2_tie_rule_across_tiles():
    queries, keys, qmask, kmask = _tie_heavy()
    (idx, dist), (ref_idx, ref_dist) = _both(queries, keys, qmask, kmask)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(dist, ref_dist)
    np.testing.assert_array_equal(idx[0], [515, 519])
    lex = _lexicographic_best2(queries, keys, kmask)
    found = (idx >= 0).all(axis=1)
    # the cross-tile rule is exercised: some answers are not the
    # lexicographic two smallest
    assert (idx[found] != lex[found]).any(axis=1).sum() >= 1


def _threshold_filter_knn2(queries, keys, qmask, kmask, thresh=13.3):
    """The CUDA kernel's tile scan in numpy: each tile's two smallest by
    (d2, index) among the keys below the carried second distance ("none"
    = 1e30 at tile index 0), merged by the TPU kernel's rule; d2 rounded as
    the kernel rounds it, masked keys +inf."""
    f = np.float32
    q, k = queries.astype(f), keys.astype(f)
    qq = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]
    kk = (k[:, 0] * k[:, 0] + k[:, 1] * k[:, 1]) + k[:, 2] * k[:, 2]
    kk = np.where(kmask, kk, f(np.inf))
    k2 = k + k
    big = f(1e30)
    bd = np.full((len(q), 2), big, f)
    bi = np.full((len(q), 2), -1, np.int64)
    rows = np.arange(len(q))
    for base in range(0, len(k), 512):
        kt, kkt = k2[base:base + 512], kk[base:base + 512]
        cross2 = (q[:, 0:1] * kt[:, 0] + q[:, 1:2] * kt[:, 1]) \
            + q[:, 2:3] * kt[:, 2]
        d2 = (qq[:, None] + kkt[None]) - cross2
        d2 = np.where(d2 < bd[:, 1:2], d2, np.inf)
        a1 = d2.argmin(axis=1)
        m1 = d2[rows, a1]
        d2[rows, a1] = np.inf
        a2 = d2.argmin(axis=1)
        m2 = d2[rows, a2]
        a1, m1 = np.where(np.isinf(m1), 0, a1), np.where(np.isinf(m1), big, m1)
        a2, m2 = np.where(np.isinf(m2), 0, a2), np.where(np.isinf(m2), big, m2)
        i1, i2 = base + a1, base + a2
        take = m1 < bd[:, 0]
        nd1, ni1 = np.where(take, m1, bd[:, 0]), np.where(take, i1, bi[:, 0])
        o1, oi = np.where(take, bd[:, 0], m1), np.where(take, bi[:, 0], i1)
        c2, ci = np.minimum(m2, bd[:, 1]), np.where(m2 < bd[:, 1], i2,
                                                    bi[:, 1])
        use = o1 < c2
        bd = np.stack([nd1, np.where(use, o1, c2)], 1)
        bi = np.stack([ni1, np.where(use, oi, ci)], 1)
    valid = (bd < np.float32(thresh * thresh)) & qmask[:, None]
    # torch's sqrt, as the plain version takes it (on the CPU not always
    # the correctly rounded one numpy gives)
    return np.where(valid, bi, -1), torch.sqrt(
        torch.from_numpy(np.maximum(bd, 0))).numpy()


@pytest.mark.parametrize("case", ["tie-heavy", "integer 12-box", "floats"])
def test_knn2_threshold_filter_matches_plain(case):
    """Starting each tile's scan at the carried second distance (the CUDA
    kernel's filter) leaves knn2's answers exactly as they are."""
    if case == "tie-heavy":
        queries, keys, qmask, kmask = _tie_heavy(5)
    else:
        rng = np.random.RandomState(11)
        if case == "floats":
            queries = rng.uniform(0, 30, (200, 3)).astype(np.float32)
            keys = rng.uniform(0, 30, (1500, 3)).astype(np.float32)
        else:
            queries = rng.randint(0, 12, (200, 3)).astype(np.float32)
            keys = rng.randint(0, 12, (1500, 3)).astype(np.float32)
        qmask, kmask = rng.rand(200) > 0.1, rng.rand(1500) > 0.2
    idx, dist = _threshold_filter_knn2(queries, keys, qmask, kmask)
    ref_idx, ref_dist = knn2(*(torch.from_numpy(a) for a in (
        queries, keys, qmask, kmask)), 13.3)
    np.testing.assert_array_equal(idx, ref_idx.numpy())
    np.testing.assert_array_equal(dist, ref_dist.numpy())
