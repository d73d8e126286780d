"""Semantic scene completion losses (MonoScene family).

Counterpart of coocc_tpu/losses/ssc.py (reference utils/semkitti.py:65-149:
CE_ssc_loss, sem_scal_loss, geo_scal_loss), op for op in the JAX order and
dtypes: logits channels-last [..., C] in the compute dtype, integer targets
with 255 = ignore, handled by masks. A bf16 input keeps bf16 where JAX
does; its sums run in fp32 and round once, as jnp.sum does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn.layers import softmax


def _bce(p, target: float):
    """F.binary_cross_entropy of probabilities p against a constant
    target (torch clamps the log at -100; JAX clips p). A term of weight 0
    is left out: at target 1.0 the clip's upper end rounds to 1.0 in fp32,
    and JAX's 0 * log(0) makes the loss NaN wherever p rounds to 1.0 (a
    precision over a grid without empty cells); torch's reference loss is
    finite there. Elsewhere the value and gradient are JAX's."""
    p = p.clamp(1e-12, 1.0 - 1e-12)
    loss = -target * torch.log(p)
    if target != 1.0:
        loss = loss - (1.0 - target) * torch.log(1.0 - p)
    return loss


def log_softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """jax.nn.log_softmax with its roundings (fp32: torch's)."""
    if x.dtype == torch.float32:
        return F.log_softmax(x, dim)
    shifted = x - x.detach().amax(dim, keepdim=True)
    lse = torch.log(torch.exp(shifted).sum(dim, keepdim=True,
                                           dtype=torch.float32).to(x.dtype))
    return shifted - lse


def ce_ssc_loss(logits, target, class_weights=None, ignore_index=255):
    """Weighted CE, mean over the non-ignored: sum(w_y * ce) / sum(w_y)."""
    C = logits.shape[-1]
    valid = target != ignore_index
    tgt = torch.where(valid, target, 0).long()
    logp = log_softmax(logits, -1)
    ce = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    if class_weights is None:
        w = logits.new_ones(C)
    else:
        w = torch.as_tensor(class_weights, device=logits.device).to(
            logits.dtype)
    wv = w[tgt] * valid
    return (ce * wv).sum() / wv.sum().clamp(min=1e-12)


def geo_scal_loss(logits, target, ignore_index=255, non_empty_idx=0):
    """BCE on the precision, recall and specificity of the binary
    occupied-vs-empty prediction."""
    probs = softmax(logits, -1)
    empty_probs = probs[..., non_empty_idx]
    nonempty_probs = 1.0 - empty_probs
    mask = target != ignore_index
    nonempty_target = ((target != non_empty_idx) & mask).to(logits.dtype)
    m = mask.to(logits.dtype)
    nonempty_probs = nonempty_probs * m
    empty_probs = empty_probs * m
    eps = 1e-5
    intersection = (nonempty_target * nonempty_probs).sum()
    precision = intersection / (nonempty_probs.sum() + eps)
    recall = intersection / (nonempty_target.sum() + eps)
    neg = m - nonempty_target
    spec = (neg * empty_probs).sum() / (neg.sum() + eps)
    return _bce(precision, 1.0) + _bce(recall, 1.0) + _bce(spec, 1.0)


def sem_scal_loss(logits, target, ignore_index=255):
    """Per-class precision / recall / specificity BCE, averaged over the
    classes present in the target."""
    C = logits.shape[-1]
    probs = softmax(logits, -1)
    mask = target != ignore_index
    m = mask.to(logits.dtype)
    tgt = torch.where(mask, target, C).long()
    ct = F.one_hot(tgt, C + 1)[..., :C].to(logits.dtype)
    p = probs * m[..., None]
    sum_p = p.reshape(-1, C).sum(0)
    sum_ct = ct.reshape(-1, C).sum(0)
    nominator = (p * ct).reshape(-1, C).sum(0)
    sum_not_ct = (m[..., None] * (1 - ct)).reshape(-1, C).sum(0)
    sum_spec = ((1 - p) * (1 - ct) * m[..., None]).reshape(-1, C).sum(0)
    present = sum_ct > 0
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    loss_prec = torch.where(sum_p > 0, _bce(
        nominator / sum_p.clamp(min=1e-12), 1.0), zero)
    loss_rec = torch.where(sum_ct > 0, _bce(
        nominator / sum_ct.clamp(min=1e-12), 1.0), zero)
    loss_spec = torch.where(sum_not_ct > 0, _bce(
        sum_spec / sum_not_ct.clamp(min=1e-12), 1.0), zero)
    per_class = (loss_prec + loss_rec + loss_spec) * present
    return per_class.sum() / present.sum().clamp(min=1.0)
