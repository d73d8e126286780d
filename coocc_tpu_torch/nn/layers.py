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
  * `Dropout`: flax's, its keep mask drawn from the module's `generator`.
  * `softmax`: jax.nn.softmax's roundings.

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
from ..parallel.distributed import group_mean_


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


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """jax.nn.softmax with its roundings: in fp32 torch's softmax; in a
    narrower dtype the shift, the exp and the quotient each round to it and
    the sum is taken in fp32 and rounded once, as JAX computes it."""
    if x.dtype == torch.float32:
        return x.softmax(dim)
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True, dtype=torch.float32).to(x.dtype)
