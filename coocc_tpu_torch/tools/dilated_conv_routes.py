"""Times a dilated bf16 Conv2d by route, on the card:

    python -m coocc_tpu_torch.tools.dilated_conv_routes

ASPP's 3x3 convs (512 -> 512 channels, dilations 1, 6, 12, 18) on the depth
net's maps of 6 cameras, at the flagship's 16x44 and the 896x1600 configs'
56x100: cuDNN's bf16 conv on NCHW and on channels-last inputs, and the fp32
conv of the same bf16 values rounded once (`ops/conv.py`'s `via_fp32`),
each with its largest difference from the fp32 route. Needs a CUDA card.
"""
from __future__ import annotations

import statistics
import subprocess

import torch
import torch.nn.functional as F


def timed_ms(fn, reps: int = 3) -> float:
    """Median device ms of fn() (CUDA events behind a sleep kernel)."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    cl = torch.channels_last
    for H, W in ((16, 44), (56, 100)):
        x = torch.randn((6, 512, H, W), generator=g,
                        device="cuda").to(torch.bfloat16)
        w = (torch.randn((512, 512, 3, 3), generator=g, device="cuda")
             / 48).to(torch.bfloat16)
        for d in (1, 6, 12, 18):
            routes = {
                "bf16 NCHW": lambda: F.conv2d(x, w, None, 1, d, d),
                "bf16 channels_last": lambda: F.conv2d(
                    x.contiguous(memory_format=cl),
                    w.contiguous(memory_format=cl), None, 1, d, d),
                "fp32 of bf16, NCHW": lambda: F.conv2d(
                    x.float(), w.float(), None, 1, d, d).to(torch.bfloat16),
                "fp32 of bf16, channels_last": lambda: F.conv2d(
                    x.float().contiguous(memory_format=cl),
                    w.float().contiguous(memory_format=cl), None, 1, d,
                    d).to(torch.bfloat16)}
            ref = routes["fp32 of bf16, NCHW"]().float()
            for name, fn in routes.items():
                fn()
                torch.cuda.synchronize()
                ms = timed_ms(fn)
                err = float((fn().float() - ref).abs().max())
                print(f"[{H}x{W}] dilation {d:2d} {name:28s} {ms:9.3f} ms"
                      f"  max|diff| from the fp32 route {err:.4g} (scale "
                      f"{float(ref.abs().max()):.4g})", flush=True)


if __name__ == "__main__":
    main()
