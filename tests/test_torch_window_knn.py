"""The port's window_knn (CPU: its plain version) == the JAX package's.

Integers, so equality is exact, against three references: the JAX XLA
plane reduction, the JAX Pallas best-2 kernel in interpret mode (as
test_pallas_window_knn.py runs it) and the numpy oracle of golden_refs.
The CUDA kernel itself runs only on the card: chip_smoke.py holds it against
the same plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.ops.window_knn import make_offsets as jax_make_offsets
from coocc_tpu.ops.window_knn import window_knn as jax_window_knn
from golden_refs import window_knn_oracle_vec

from coocc_tpu_torch.ops.window_knn import make_offsets, window_knn

SHAPES = [(10, 9, 4), (20, 20, 8), (37, 23, 5)]
RADII = [(4, 4, 3), (4, 4, 7), (6, 6, 7)]
DENSITIES = [0.0, 0.02, 0.3, 1.0]


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("radii", RADII)
@pytest.mark.parametrize("shape", SHAPES)
def test_window_knn_matches_jax(monkeypatch, shape, radii, density):
    mask = np.random.RandomState(0).rand(*shape) < density
    offsets = make_offsets(*radii, dist_thresh=13.3)
    np.testing.assert_array_equal(
        offsets, jax_make_offsets(*radii, dist_thresh=13.3))

    got = window_knn(torch.from_numpy(mask), offsets, k=2)
    assert got.dtype == torch.int32 and got.shape == (*shape, 2)
    got = got.numpy()

    monkeypatch.setenv("COOCC_PALLAS_KNN", "0")
    xla = np.asarray(jax_window_knn(jnp.asarray(mask), offsets, k=2))
    monkeypatch.setenv("COOCC_PALLAS_KNN", "interpret")
    pallas = np.asarray(jax_window_knn(jnp.asarray(mask), offsets, k=2))
    oracle = window_knn_oracle_vec(mask, offsets, k=2)

    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, oracle)
