"""Layers with the reference's parameter names, computing in the dtype of
their input.

Counterpart of coocc_tpu/nn/layers.py. The flax modules there take a
compute `dtype` and keep their parameters in fp32, casting them at use; the
port's model casts its inputs to the compute dtype once (models/coocc_ray.py)
and every layer here follows the dtype of the activation it is given:

  * `Conv2d`, `Conv3d`, `ConvTranspose2d`, `ConvTranspose3d`, `Linear`:
    torch's modules (their state_dict names are the reference
    checkpoint's) with the weight and bias cast to the input's dtype at the
    call (`ops/conv.py`). A bf16
    convolution sums in fp32 and rounds once, as JAX's conv with
    `preferred_element_type=fp32` followed by `astype(bf16)` does; the bias
    is added inside the same call, where flax adds it in bf16 after the
    rounding (one bf16 ulp apart at most).
  * `BatchNorm`: fp32 running statistics and affine, one rounding to the
    input's dtype (flax's BatchNorm with `dtype` set). In training it
    normalizes with the batch's statistics as flax does (fp32 mean and
    biased variance E[x^2] - E[x]^2) and moves the running statistics by
    its momentum towards them, the variance biased too (torch's training
    BatchNorm would move it towards the unbiased one). Its backward
    (`_BatchNormTrain`) keeps the input in its own dtype and the [C]
    statistics, and computes the batch-statistics gradient from them in
    fp32, rounded once to the input's dtype: autograd through the forward's
    ops would keep two fp32 copies of the input a layer. Under
    `bn_sync_group(group)` (a data-parallel step, parallel/train_step.py)
    it is SyncBN as flax's BatchNorm with an `axis_name` computes it: the
    [2, C] means of x and x^2 are averaged over the group's ranks in one
    all-reduce before the variance E[x^2] - E[x]^2 is formed, and its
    backward sums the [2, C] sums of g and g * xhat over the ranks (the
    gradient of that mean). It keeps no
    `num_batches_tracked` counter (a counter the JAX variables cannot carry,
    so `convert.state_dict_from_jax` round-trips exactly).
  * `LayerNorm`, `GroupNorm`: flax's arithmetic (`flax_norm`).
  * `Dropout`: flax's, its keep mask drawn from the module's `generator`.
  * `softmax`: jax.nn.softmax's roundings; `weak`: a Python constant as a
    JAX op of a narrow dtype takes it; `flax_apply`: a layer called as a
    flax layer with a `dtype` attribute casts its input.

Parameters and BN statistics stay fp32 whatever the compute dtype: the model
is never cast as a whole.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import conv


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # cuDNN gives a dilated bf16 conv its direct kernel at some
        # dilations and shapes: ASPP's dilations 12 and 18 took 225-255 ms
        # each on channels-last 56x100 maps (the 896x1600 configs), 10-17
        # ms on the flagship's 16x44 ones, against 3.6 and 0.76 ms for the
        # fp32 conv of the same values (PERF.md). Every dilated conv takes
        # the fp32 route, the same numerics.
        return conv(F.conv2d, x, self.weight, self.bias, self.stride,
                    self.padding, self.dilation, self.groups,
                    via_fp32=self.dilation != (1, 1))


class Conv3d(nn.Conv3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(F.conv3d, x, self.weight, self.bias, self.stride,
                    self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(F.conv_transpose2d, x, self.weight, self.bias,
                    self.stride, self.padding, self.output_padding,
                    self.groups, self.dilation)


class ConvTranspose3d(nn.ConvTranspose3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(F.conv_transpose3d, x, self.weight, self.bias,
                    self.stride, self.padding, self.output_padding,
                    self.groups, self.dilation)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(F.linear, x, self.weight, self.bias)



def group_mean_(t, group):
    """The reference runs on one device: no group to average over."""
    raise RuntimeError("the reference BatchNorm runs without a group")


# The process group the training BatchNorms sync their statistics over;
# None outside a data-parallel step.
_BN_SYNC_GROUP = contextvars.ContextVar("bn_sync_group", default=None)


@contextlib.contextmanager
def bn_sync_group(group):
    """Inside the block every BatchNorm in training syncs its batch
    statistics over `group` (a torch.distributed process group; None: no
    sync): SyncBN, the twin of JAX's `bn_sync_axis` (coocc_tpu/nn/
    layers.py:34-49; reference tools/train.py:222-223). The packed
    encoders' masked BatchNorms stay rank-local, as JAX's `_PackedBNCore`
    does."""
    token = _BN_SYNC_GROUP.set(group)
    try:
        yield
    finally:
        _BN_SYNC_GROUP.reset(token)


class _BatchNormTrain(torch.autograd.Function):
    """BatchNorm on the batch's statistics over dim 1 of x: the forward in
    fp32 as flax computes it (mean, biased variance E[x^2] - E[x]^2),
    rounded once to x's dtype; -> (y, mean, var). The backward keeps x in
    its dtype and the [C] statistics, and recomputes the normalized input:
    dx = w*rstd * (g - mean(g) - xhat * mean(g * xhat)), in fp32. With a
    process group the means of x and x^2 are the group's (flax's pmean of
    both in one call) and mean(g), mean(g * xhat) are over the group's
    n * world values; dw and db stay this rank's sums (the step averages
    every gradient)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        mean, mean2 = xf.mean(dims), (xf * xf).mean(dims)
        if group is not None:
            mean, mean2 = group_mean_(torch.stack([mean, mean2]), group)
        var = (mean2 - mean * mean).clamp(min=0.0)
        rstd = torch.rsqrt(var + eps)
        mul = rstd * weight
        y = (xf - mean.view(shape)) * mul.view(shape) + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, rstd = ctx.saved_tensors
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        n = x.numel() // x.shape[1]
        g = gy.float()
        # fp32 temporaries, updated in place: a pass over x each
        xhat = torch.sub(x, mean.view(shape)).mul_(rstd.view(shape))
        db = g.sum(dims)
        dw = (g * xhat).sum(dims)
        sdb, sdw = db, dw
        if ctx.group is not None:
            sums = torch.stack([db, dw])
            dist.all_reduce(sums, group=ctx.group)
            sdb, sdw = sums
            n *= dist.get_world_size(ctx.group)
        dx = xhat.mul_((-sdw / n).view(shape)).add_(g).sub_(
            (sdb / n).view(shape)).mul_((weight * rstd).view(shape))
        return dx.to(x.dtype), dw, db, None, None


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 of [N, C, ...] (1d, 2d and 3d alike), in fp32
    with one rounding to the input's dtype: the running statistics in eval,
    the batch's in training (see the module note), the group's under
    `bn_sync_group`, which the running statistics then move towards.

    eps and momentum follow the call site, as in the reference: 1e-5 and
    0.1 are torch's and the JAX BatchNorm's defaults; SECONDFPN passes 1e-3
    and 0.01.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        # the share of the running statistics kept at each training step
        # (flax's `momentum`; torch's momentum is 1 - decay)
        self.decay = 1.0 - momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor,
                update_stats: bool = True) -> torch.Tensor:
        """update_stats=False normalizes with the batch's statistics without
        moving the running ones (a recomputation under checkpointing)."""
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias,
                                             self.eps, _BN_SYNC_GROUP.get())
        if update_stats:
            with torch.no_grad():
                self.running_mean.copy_(self.decay * self.running_mean
                                        + (1 - self.decay) * mean)
                self.running_var.copy_(self.decay * self.running_var
                                       + (1 - self.decay) * var)
        return y

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # reference checkpoints carry torch BN's step counter; eval ignores it
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def extra_repr(self) -> str:
        return (f"{self.weight.shape[0]}, eps={self.eps}, "
                f"momentum={1.0 - self.decay:g}")


def _masked_sums(x: torch.Tensor, m: torch.Tensor, dims, group):
    """The [C] sums of x * m over dims, all-reduced over `group`."""
    s = (x * m).sum(dims)
    if group is not None:
        dist.all_reduce(s, group=group)
    return s


class _MaskedBNTrain(torch.autograd.Function):
    """JAX `MaskedBatchNorm` in training on x [N, C, *S] and its row mask
    m [N, 1, *S] (fp32 0/1): n = max(sum m, 1), summed over the group's
    ranks; mean = sum(x m) / n, var = sum((x - mean)^2 m) / n, each sum
    all-reduced before it is divided (JAX's psums); y = ((x - mean) /
    sqrt(var + eps) * weight + bias) * m in fp32. -> (y, mean, var, n).
    The backward keeps x in its dtype, m and the [C] statistics, and
    computes in fp32: the gradient of the masked statistics over the
    group's active rows (its three [C] sums all-reduced in one call), dx
    rounded once to x's dtype; dweight and dbias stay this rank's sums,
    as `_BatchNormTrain`'s."""

    @staticmethod
    def forward(ctx, x, m, weight, bias, eps, group):
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if x.dtype != torch.float32:
            y, mean, var, n, rstd = _masked_bn_narrow(x, m, weight, bias,
                                                      eps, group)
            ctx.save_for_backward(x, m, weight, mean.float(), rstd,
                                  n.float())
            ctx.group = group
            ctx.mark_non_differentiable(mean, var, n)
            return y, mean, var, n
        xf = x.float()
        n = m.sum().clamp(min=1.0)
        if group is not None:
            dist.all_reduce(n, group=group)
        mean = _masked_sums(xf, m, dims, group) / n
        xc = xf - mean.view(shape)
        var = _masked_sums(xc * xc, m, dims, group) / n
        rstd = 1.0 / torch.sqrt(var + eps)
        y = (xc * rstd.view(shape) * weight.view(shape)
             + bias.view(shape)) * m
        ctx.save_for_backward(x, m, weight, mean, rstd, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var, n)
        return y, mean, var, n

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar, _gn):
        x, m, weight, mean, rstd, n = ctx.saved_tensors
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        g = gy.float() * m
        xc = torch.sub(x, mean.view(shape))         # fp32
        db = g.sum(dims)
        dw = (g * xc).sum(dims) * rstd
        # the statistics' gradient, over every rank's active rows
        sums = torch.stack([db, dw, (xc * m).sum(dims)])
        if ctx.group is not None:
            dist.all_reduce(sums, group=ctx.group)
        sdb, sdw, sxc = sums
        dvar = -0.5 * sdw * weight * rstd * rstd
        dmean = -sdb * weight * rstd - 2.0 * dvar * sxc / n
        dx = xc.mul_((2.0 * dvar / n).view(shape)).add_(
            (dmean / n).view(shape)).mul_(m).addcmul_(
            g, (weight * rstd).view(shape))
        return dx.to(x.dtype), None, dw, db, None, None


def _masked_bn_narrow(x, m, weight, bias, eps, group):
    """JAX `MaskedBatchNorm` in training on a narrow (bf16) x, rounded as
    JAX rounds it (coocc_tpu/nn/layers.py:390-402): the mask, n, the masked
    sums, the mean, the variance and the normalized value in x's dtype,
    each sum taken in fp32 and rounded once (jnp.sum upcasts a narrow
    dtype), eps rounded to x's dtype first; the scale and bias promote
    the result to fp32. Over a group the ranks' fp32 sums are added
    before that one rounding (JAX's psum adds each rank's rounded sum).
    -> (y, mean, var, n, rstd fp32 for the backward)."""
    dt = x.dtype
    dims = [0] + list(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mt = m.to(dt)

    def total(t, over):
        s = t.sum(over, dtype=torch.float32)
        if group is not None:
            dist.all_reduce(s, group=group)
        return s.to(dt)
    n = total(mt, list(range(mt.dim()))).clamp(min=1.0)
    mean = total(x * mt, dims) / n
    xc = x - mean.view(shape)
    var = total(xc * xc * mt, dims) / n
    s = torch.sqrt(var + weak(eps, dt))
    y = ((xc / s.view(shape)).float() * weight.view(shape)
         + bias.view(shape)) * m
    return y, mean, var, n, 1.0 / s.float()


def masked_batch_norm(bn: "BatchNorm", x: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """JAX `MaskedBatchNorm` (coocc_tpu/nn/layers.py:362-409) with `bn`'s
    parameters, statistics, eps and momentum: x [N, C, *S] normalized over
    the rows where mask [N, *S] is set, the output fp32 times the mask. In
    eval with the running statistics; in training with the active rows'
    (`_MaskedBNTrain`), synced over `bn_sync_group`'s group as JAX's
    reads `_BN_SYNC_AXIS` (the packed encoders' BatchNorms are rank-local,
    this one is not), moving the running mean towards the mean and the
    running variance towards n / max(n - 1, 1) of the variance. A bf16 x
    takes its statistics in bf16, as JAX's does (`_masked_bn_narrow`):
    the running statistics then move by bf16 terms (the momentum rounded
    to bf16 first), added to their fp32 values in fp32."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    m = mask.unsqueeze(1).float()
    if not bn.training:
        y = (x.float() - bn.running_mean.view(shape)) / torch.sqrt(
            bn.running_var.view(shape) + bn.eps) * bn.weight.view(shape) \
            + bn.bias.view(shape)
        return y * m
    y, mean, var, n = _MaskedBNTrain.apply(x, m, bn.weight, bn.bias, bn.eps,
                                           _BN_SYNC_GROUP.get())
    momentum = weak(1 - bn.decay, mean.dtype)
    with torch.no_grad():
        bn.running_mean.copy_(bn.decay * bn.running_mean + momentum * mean)
        bn.running_var.copy_(bn.decay * bn.running_var + momentum * var * n
                             / (n - 1).clamp(min=1.0))
    return y


class Dropout(nn.Module):
    """flax.linen.Dropout in training (identity in eval or at p = 0): keep
    each element with probability 1 - p, drawn from `generator` (set by the
    train step; None draws from torch's default generator), and scale the
    kept ones by 1 / (1 - p) in the input's dtype."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0:
            return x
        keep = 1.0 - self.p
        m = torch.rand(x.shape, generator=self.generator,
                       device=x.device) < keep
        return torch.where(m, x / keep, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))

    def extra_repr(self) -> str:
        return f"p={self.p}"


def flax_norm(x: torch.Tensor, groups: int, weight: torch.Tensor,
              bias: torch.Tensor, eps: float) -> torch.Tensor:
    """flax's LayerNorm / GroupNorm over the last axis of x [..., C] in
    `groups` groups, in fp32 (flax's statistics): mean and E[x^2] - mean^2
    (clipped at 0) of each group, y = (x - mean) * (rsqrt(var + eps) *
    scale) + bias. Returns fp32; torch's fused layer_norm and group_norm
    round x * rstd in another order (at eps 1e-5 and one channel a group
    they leave 1e-4 of noise where flax gives the bias exactly)."""
    C = x.shape[-1]
    g = x.float().reshape(*x.shape[:-1], groups, C // groups)
    mean = g.mean(-1, keepdim=True)
    var = ((g * g).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
    mul = torch.rsqrt(var + eps) * weight.view(groups, C // groups)
    return ((g - mean) * mul).reshape(x.shape) + bias


class LayerNorm(nn.LayerNorm):
    """flax.linen.LayerNorm with `dtype` the input's (`flax_norm`, one
    rounding to x's dtype) on the last axis; the reference's names
    (weight, bias)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_norm(x, 1, self.weight, self.bias, self.eps).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """flax.linen.GroupNorm with `dtype` None on [N, C, ...]: each sample's
    group statistics over its channels and every spatial position, in
    fp32 as `flax_norm` takes them; its fp32 parameters promote the result
    to fp32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, C = x.shape[:2]
        G = self.num_groups
        xf = x.float()
        g = xf.reshape(N, G, -1)
        mean = g.mean(-1)
        var = ((g * g).mean(-1) - mean * mean).clamp(min=0.0)
        shape = (N, C) + (1,) * (x.dim() - 2)
        mean = mean.repeat_interleave(C // G, 1).view(shape)
        rstd = torch.rsqrt(var + self.eps).repeat_interleave(C // G, 1)
        mul = rstd.view(shape) * self.weight.view((1, C) + shape[2:])
        return (xf - mean) * mul + self.bias.view((1, C) + shape[2:])


def weak(value: float, dtype: torch.dtype) -> float:
    """A Python constant as a JAX op of `dtype` takes it (a weak type,
    rounded to the op's dtype first); torch would apply it unrounded."""
    return float(torch.tensor(value, dtype=dtype))


def flax_apply(layer: nn.Module, x: torch.Tensor, dtype) -> torch.Tensor:
    """layer(x) as the flax layer with `dtype` computes it: x cast to dtype,
    or with dtype None to the promotion of x's dtype and the fp32
    parameters (`Linear` and `LayerNorm` then follow x's dtype)."""
    return layer(x.to(dtype or torch.promote_types(x.dtype, torch.float32)))


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """jax.nn.softmax with its roundings: in fp32 torch's softmax; in a
    narrower dtype the shift, the exp and the quotient each round to it and
    the sum is taken in fp32 and rounded once, as JAX computes it."""
    if x.dtype == torch.float32:
        return x.softmax(dim)
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True, dtype=torch.float32).to(x.dtype)
