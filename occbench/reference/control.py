"""The control: the reference computed one precision below the
configuration's bf16, in fp8 (e4m3, one scale a tensor, as fp8 inference
scales them): every weight of two or more axes rounded once, and the input
of every convolution and linear module rounded at each call. A comparison
that passes the program must fail this."""
from __future__ import annotations

import torch
import torch.nn as nn

E4M3_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to e4m3 with the scale that maps its largest magnitude to
    e4m3's, back in t's dtype."""
    if not t.is_floating_point() or t.numel() == 0:
        return t
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    q = (t.float() * scale).to(torch.float8_e4m3fn).float() / scale
    return q.to(t.dtype)


LAYERS = (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
          nn.ConvTranspose3d, nn.Linear)


@torch.no_grad()
def make_fp8(model: nn.Module) -> nn.Module:
    """Round `model`'s weights to fp8 in place and round each layer's input
    to fp8 from now on."""
    for p in model.parameters():
        if p.dim() >= 2:
            p.copy_(fp8_round(p))

    def pre(_m, args):
        return tuple(fp8_round(a) if isinstance(a, torch.Tensor) else a
                     for a in args)

    for m in model.modules():
        if isinstance(m, LAYERS):
            m.register_forward_pre_hook(pre)
    return model
