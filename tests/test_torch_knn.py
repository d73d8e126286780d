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
