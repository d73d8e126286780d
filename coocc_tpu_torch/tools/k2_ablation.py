"""What bounds kernel K2 (csrc/subm_conv.cuh): its time with parts of its
work taken out, on one NVIDIA card.

    python -m coocc_tpu_torch.tools.k2_ablation

Builds copies of the kernel source with one part removed each (the
results of the copies are wrong by design; only their times mean
something) and times every copy on the flagship's res1 and res3 shapes,
fp32, mask epilogue, each repeat on its own input (CUDA events behind a
sleep kernel, median of 5). Variants:

  full        the kernel as it ships;
  no_store    the epilogue computes but does not store;
  no_convert  the converter warps skip the fp32 -> bf16 pass (the
              consumers read stale bf16 halos);
  no_mma      the consumers wait for each stage and release it, nothing
              else: the copies (TMA halo, bulk panel, conversion) and the
              epilogue's stores alone;
  copies      no_mma without the stores: the copies alone.

For `copies` it also prints the bytes the blocks copied from L2 (or device
memory) into shared memory and the rate that implies. Needs a CUDA card
and nvcc, like chip_smoke.py.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import _build
from ..ops import subm_conv as sc

SHAPES = [((1, 8, 400, 400, 128), 4), ((1, 8, 100, 100, 128), 1)]
_STORE = "        store2(out + site * N + n, v[0], v[1]);"
_NO_STORE = "        if (v[0] == 1234.5f) store2(out + site * N + n, v[0], v[1]);"
_MMA = """    kblock_any<Co>(acc, st + Ring<T, Co>::CVT, st + HALO_SLOT,
                   kt.col0[i] / Co, kt.width[i] / Co, wg, wq, lane);"""
_CONVERT = "    convert_halo(st, st + Ring<T, Co>::CVT, t);"


def _variants(src: str):
    def cut(s, a, b=""):
        if a not in s:
            raise RuntimeError(f"k2_ablation: the kernel source changed; "
                               f"cannot find {a.strip()[:60]!r}")
        return s.replace(a, b)
    no_mma = cut(src, _MMA)
    return {"full": src, "no_store": cut(src, _STORE, _NO_STORE),
            "no_convert": cut(src, _CONVERT), "no_mma": no_mma,
            "copies": cut(no_mma, _STORE, _NO_STORE)}


def _build_all(srcs, entry, tmp):
    """Each variant of the kernel header beside the fp32 entry source
    `entry`, built in a directory of its own."""
    def one(item):
        name, s = item
        d = os.path.join(tmp, name)
        os.makedirs(d)
        with open(os.path.join(d, "subm_conv.cuh"), "w") as f:
            f.write(s)
        cu, so = os.path.join(d, "k2.cu"), os.path.join(d, "k2.so")
        with open(cu, "w") as f:
            f.write(entry)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                               cu], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        fn = ctypes.CDLL(so).subm_ext_conv
        fn.argtypes = sc.ARGTYPES
        fn.restype = ctypes.c_int
        return name, fn
    with ThreadPoolExecutor(len(srcs)) as pool:
        return dict(pool.map(one, srcs.items()))


def copied_bytes(shape, p: int) -> int:
    """Bytes the blocks copy into shared memory: per block and K-block the
    18 x 18 halo of 16 fp32 lanes and the weight panel."""
    B, bz, X, Y, pC = shape
    C, Co = pC // p, sc.N_LANES // p
    tiles = -(-X // 16) * -(-Y // 16)
    total = 0
    for _, dg, _, width in sc.kblocks(p, C, Co):
        packs = B * (bz if dg == 0 else bz - 1)
        total += packs * tiles * (18 * 18 * sc.KB * 4 + 9 * sc.KB * width * 2)
    return total


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k2_ablation needs a CUDA card")
    with open(os.path.join(_build.CSRC, "subm_conv.cuh")) as f:
        src = f.read()
    with open(os.path.join(_build.CSRC, "subm_conv_f32.cu")) as f:
        entry = f.read()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        fns = _build_all(_variants(src), entry, tmp)
        gen = torch.Generator(device="cuda").manual_seed(0)
        for shape, p in SHAPES:
            B, bz, X, Y, pC = shape
            C, Co = pC // p, sc.N_LANES // p
            w27 = torch.randn(27, C, Co, generator=gen, device="cuda")
            mcell = torch.rand((B, bz, X, Y, p), generator=gen,
                               device="cuda") < 0.3
            xs = [torch.randn(shape, generator=gen, device="cuda")
                  for _ in range(5)]
            panels = sc.weight_panels(w27, p)
            table = sc._ktable(p, C, Co)
            out = torch.empty(shape, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            for name, fn in fns.items():
                def call(x):
                    err = fn(x.data_ptr(), panels.data_ptr(), out.data_ptr(),
                             0, mcell.data_ptr(), None, None, None, None,
                             table.ctypes.data, 0, B * bz, bz, X, Y, pC, C,
                             Co, len(table), stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                for x in xs:
                    call(x)
                times = []
                for x in xs:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda._sleep(2_000_000)
                    start.record()
                    call(x)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
                ms = statistics.median(times)
                extra = ""
                if name == "copies":
                    nbytes = copied_bytes(shape, p)
                    extra = (f" ({nbytes} bytes into shared memory, "
                             f"{nbytes / ms / 1e9:.2f} TB/s)")
                print(f"{shape} p={p} {name}: {ms:.4f} ms{extra}",
                      flush=True)


if __name__ == "__main__":
    main()
