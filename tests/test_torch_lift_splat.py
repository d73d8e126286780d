"""ops/lift_splat.py: the sorted segment-sum against a scatter-add.

The splat sums each voxel's points in their order (a stable sort by voxel
id, then one segment-sum), which is `index_add_`'s order on the CPU: the
two grids are equal bit for bit. Its gradients: the depth weights' equal,
the features' (gathered rows, summed in another order) within fp32
rounding, one bf16 rounding more for bf16 features.
"""
import numpy as np
import pytest
import torch

from coocc_tpu_torch.geometry.frustum import gen_dx_bx, voxel_indices
from coocc_tpu_torch.ops.gather import gather_rows
from coocc_tpu_torch.ops.lift_splat import lift_splat
from coocc_tpu_torch.ops.voxelize import linearize

BOUNDS = ((-4.0, 4.0, 1.0), (-4.0, 4.0, 1.0), (-2.0, 2.0, 1.0))


def scatter_add(dp, feat, geom, dx, bx, nx):
    """Every frustum point added into its voxel by index_add_, the points
    outside the grid into a sink row; the features gathered by the port's
    gather_rows, whose gradient sums in fp32 (tests/test_torch_gather.py)."""
    B, N, D, fH, fW = dp.shape
    C = feat.shape[-1]
    nx = [int(v) for v in nx]
    n_vox = nx[0] * nx[1] * nx[2]
    idx, valid = voxel_indices(geom, dx, bx, nx)
    vox = torch.where(valid, linearize(idx, nx), n_vox).reshape(B, -1)
    pix = torch.arange(N * fH * fW).reshape(N, 1, fH, fW)
    pix = pix.expand(N, D, fH, fW).reshape(-1)
    outs = []
    for b in range(B):
        contrib = gather_rows(feat[b].reshape(-1, C), pix).to(dp.dtype) \
            * dp[b].reshape(-1, 1)
        out = contrib.new_zeros(n_vox + 1, C)
        out.index_add_(0, vox[b].long(), contrib)
        outs.append(out[:n_vox].reshape(nx[0], nx[1], nx[2], C))
    return torch.stack(outs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lift_splat_equals_index_add_bit_for_bit(dtype):
    rs = np.random.RandomState(0)
    B, N, D, fH, fW, C = 2, 2, 12, 4, 5, 8
    dp = torch.from_numpy(rs.rand(B, N, D, fH, fW).astype(np.float32))
    feat = torch.from_numpy(rs.randn(B, N, fH, fW, C).astype(
        np.float32)).to(dtype)
    # a third of the points outside the grid, many points per voxel
    geom = torch.from_numpy(rs.uniform(-5, 5, (B, N, D, fH, fW, 3)).astype(
        np.float32))
    grid = gen_dx_bx(*BOUNDS)
    ins = [t.clone().requires_grad_(True) for t in (dp, feat)]
    ref_ins = [t.clone().requires_grad_(True) for t in (dp, feat)]
    got = lift_splat(*ins, geom, *grid)
    ref = scatter_add(*ref_ins, geom, *grid)
    assert got.dtype == torch.float32 and got.shape == (B, 8, 8, 4, C)
    assert float(ref.detach().abs().max()) > 0
    assert torch.equal(got, ref)
    cot = torch.from_numpy(rs.randn(*got.shape).astype(np.float32))
    g = torch.autograd.grad((got * cot).sum(), ins)
    r = torch.autograd.grad((ref * cot).sum(), ref_ins)
    assert torch.equal(g[0], r[0])
    assert g[1].dtype == dtype
    torch.testing.assert_close(g[1].float(), r[1].float(), atol=1e-5,
                               rtol=1e-5 if dtype == torch.float32 else 1e-2)
