"""A short first check of kernel K2 (csrc/subm_conv.cuh) on one NVIDIA card,
for a new instantiation or shape before a full `chip_smoke.py` run; run it
from the repository's root:

    python -m coocc_tpu_torch.tools.k2_probe

Compiles both K2 sources with `nvcc -Xptxas -v` and prints ptxas's
register lines and any "serialized" wgmma warning, then holds K2 against
its plain version on random inputs at the packings below, in every
epilogue mode, fp32 and bf16 (`chip_smoke.py:k2_check` and its bound),
and times one bn_res_relu launch at the largest (CUDA events behind a
sleep kernel, median of 5). The packings: coocc_lidar's stage 0 at p = 8,
Co = 16, small and ragged, the flagship's p = 4 one, and the full
[1, 9, 800, 800, 128].
"""
from __future__ import annotations

import os
import subprocess

import torch

from ..ops import _build
from ..ops.subm_conv import subm_ext_conv

CASES = [((1, 9, 64, 64, 128), 8), ((2, 3, 37, 29, 128), 8),
         ((1, 9, 48, 40, 128), 4), ((1, 9, 800, 800, 128), 8)]


def ptxas_report():
    for name in ("subm_conv", "subm_conv_f32"):
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.devnull, os.path.join(_build.CSRC, f"{name}.cu")],
            capture_output=True, text=True)
        print(f"nvcc {name}.cu: rc {proc.returncode}", flush=True)
        for ln in (proc.stdout + proc.stderr).splitlines():
            if any(w in ln for w in ("serialized", "registers", "error")):
                print(f"  {ln}")


def main():
    import chip_smoke as cs   # the repository's root, as `python -m` runs
    if not torch.cuda.is_available():
        raise SystemExit("k2_probe needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ptxas_report()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape, p in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            [(x, mcell, idn)], w27, bn = cs.k2_inputs(
                gen, shape, p, 128 // p, dtype, 1)
            for mode in cs.K2_MODES:
                err, scale, _, ok = cs.k2_check(x, w27, p, mcell,
                                                *cs.k2_args(mode, idn, bn))
                print(f"{shape} p={p} {str(dtype)[6:]} {mode}: max_abs_err "
                      f"{err:.6g}, scale {scale:.6g}, "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(f"K2 differs at {shape} p={p}")
            if shape == CASES[-1][0]:
                ms = cs.timed_ms(
                    lambda: subm_ext_conv(x, w27, p, mcell, bn, idn), 5)
                print(f"{shape} p={p} {str(dtype)[6:]} bn_res_relu: "
                      f"{ms:.4f} ms a launch", flush=True)
            del x, mcell, idn
            torch.cuda.empty_cache()
    print(f"card: {cs.card_line()}")


if __name__ == "__main__":
    main()
