"""The reference copy: its HD encoder's recomputed training blocks give the
gradients of the plain forward, and the weights both sides draw agree."""
import torch

from occbench.reference import weights
from occbench.reference.occref.nn import sparse_enc_packed_hd as hd
from occbench.reference.occref.ops.sparse_tensor import SparseTensor


def _grads(enc, sp):
    enc.zero_grad()
    enc(sp).square().sum().backward()
    return [p.grad.clone() for p in enc.parameters() if p.grad is not None]


def test_recomputed_hd_blocks_give_the_same_gradients(monkeypatch):
    torch.manual_seed(0)
    shape = (16, 16, 17)
    enc = hd.PackedEncoderHD(4, 16, 128, shape).train()
    weights.load(enc, 3)
    n = 300
    ids = torch.randperm(shape[0] * shape[1] * shape[2])[:n].sort().values
    sp = SparseTensor(ids[None], torch.randn(1, n, 4),
                      torch.ones(1, n, dtype=torch.bool))
    with_ckpt = _grads(enc, sp)
    monkeypatch.setattr(hd, "checkpoint",
                        lambda fn, *a, use_reentrant: fn(*a))
    plain = _grads(enc, sp)
    assert len(with_ckpt) == len(plain) > 10
    for a, b in zip(with_ckpt, plain):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_draw_is_seeded_and_by_name():
    a = hd.PackedEncoderHD(4, 16, 128, (16, 16, 17))
    b = hd.PackedEncoderHD(4, 16, 128, (16, 16, 17))
    sa, sb = weights.draw(a, 5), weights.draw(b, 5)
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert weights.names_digest(a) == weights.names_digest(b)
    sc = weights.draw(a, 6)
    assert not torch.equal(sa["conv_out.0.weight"], sc["conv_out.0.weight"])
