"""What bounds kernel K2 (csrc/subm_conv.cuh) or its dW kernel
(csrc/subm_conv_dw.cuh): its time with parts of its work taken out, on one
NVIDIA card.

    python -m coocc_tpu_torch.tools.k2_ablation [--dw]

Builds copies of the kernel source with one part removed each (the
results of the copies are wrong by design; only their times mean
something) and times every copy, each repeat on its own input (CUDA
events behind a sleep kernel, median of 5).

K2, on the flagship's res1 and res3 shapes, fp32, mask epilogue:

  full        the kernel as it ships;
  no_store    the epilogue computes but does not store;
  no_convert  the converter warps skip the fp32 -> bf16 pass (the
              consumers read stale bf16 halos);
  no_mma      the consumers wait for each stage and release it, nothing
              else: the copies (TMA halo, bulk panel, conversion) and the
              epilogue's stores alone;
  copies      no_mma without the stores: the copies alone.

dW (`--dw`), bf16, at the train levels where it spends most (the
flagship's res1, coocc_lidar's stage 0, the flagship's p = 1 level):

  full      the kernel as it ships;
  no_ldsm   the consumers' A fragments are zeros (no ldmatrix);
  no_mma    the consumers wait for each stage and release it, and load
            their A fragments: no wgmma;
  no_x      the producer lands the dy halos only (no x tiles);
  no_dy     the producer lands the x tiles only (no dy halos);
  copies    no_mma and no_ldsm: the producer's copies and the barriers;
  no_copy   the producer copies nothing and only arrives on each stage:
            the products and the barriers on whatever the stages hold.

For the copies-only variants (and dW's `full`) it also prints the bytes
the blocks copy into shared memory and the rate that implies. Needs a
CUDA card and nvcc, like chip_smoke.py.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
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

DW_SHAPES = [((1, 8, 400, 400, 128), 4), ((1, 9, 800, 800, 128), 8),
             ((1, 8, 100, 100, 128), 1)]
# x, dy0, dy1, dy2, parts, table, units, S, partials, gw, out dtype, G,
# bz, X, Y, pC, E, stream (ops/subm_conv.py:_dw_launcher)
DW_ARGTYPES = [sc._P] * 4 + [sc._I, sc._P, sc._I, sc._I, sc._P, sc._P] + \
    [sc._I] * 7 + [sc._P]
_DW_MMA = ("      wgmma_n96_mn(acc[ky], a[r & 1],\n                   desc + "
           "static_cast<uint64_t>(r * (DW_HROW / 16) + 2 - ky));")
_LDSM = "  if (zero) {\n    a[0] = a[1] = a[2] = a[3] = 0u;"
_NO_LDSM = "  if (true) {\n    a[0] = a[1] = a[2] = a[3] = 0u;"
_X_LOAD = ("      tma_load_4d(st + xoff + k * DW_XTILE, xmap, un.lane[k], tl.y0, "
           "tl.x0,\n                  tl.g + un.dg[k], bar);")
_X_BYTES = "un.nwin * DW_WIN + active * DW_XTILE"
_EXPECT = "    mbar_expect_tx(bar, un.nwin * DW_WIN + active * DW_XTILE);"
_DY_LOAD = ("      tma_load_5d(st + w * DW_WIN, dymap, 0, tl.y0 - 1, un.col[w] "
            "/ 8,\n                  tl.x0 - 1, tl.g, bar);")


def _cut(s, a, b=""):
    if a not in s:
        raise RuntimeError(f"k2_ablation: the kernel source changed; "
                           f"cannot find {a.strip()[:60]!r}")
    return s.replace(a, b)


def _variants(src: str):
    no_mma = _cut(src, _MMA)
    return {"full": src, "no_store": _cut(src, _STORE, _NO_STORE),
            "no_convert": _cut(src, _CONVERT), "no_mma": no_mma,
            "copies": _cut(no_mma, _STORE, _NO_STORE)}


def _dw_variants(src: str):
    no_mma = _cut(src, _DW_MMA, "      ;")
    no_x = _cut(_cut(src, _X_LOAD, "{}"), _X_BYTES, "un.nwin * DW_WIN")
    no_dy = _cut(_cut(src, _DY_LOAD, "{}"), _X_BYTES, "active * DW_XTILE")
    no_copy = _cut(_cut(_cut(src, _X_LOAD, "{}"), _DY_LOAD, "{}"), _EXPECT,
                   "    mbar_arrive(bar);")
    return {"full": src, "no_ldsm": _cut(src, _LDSM, _NO_LDSM),
            "no_mma": no_mma, "no_x": no_x, "no_dy": no_dy,
            "copies": _cut(no_mma, _LDSM, _NO_LDSM), "no_copy": no_copy}


def _build_all(header, srcs, entry, symbol, argtypes, tmp):
    """Each variant of the kernel `header` beside the entry source `entry`
    (the other headers copied beside it), built in a directory of its own;
    -> {variant: the entry's `symbol` with `argtypes`}."""
    with open(os.path.join(_build.CSRC, entry)) as f:
        entry_src = f.read()
    headers = [h for h in os.listdir(_build.CSRC) if h.endswith(".cuh")]

    def one(item):
        name, s = item
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for h in headers:
            with open(os.path.join(_build.CSRC, h)) as f, \
                    open(os.path.join(d, h), "w") as g:
                g.write(s if h == header else f.read())
        cu, so = os.path.join(d, "k.cu"), os.path.join(d, "k.so")
        with open(cu, "w") as f:
            f.write(entry_src)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                               cu], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        fn = getattr(ctypes.CDLL(so), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return name, fn
    with ThreadPoolExecutor(len(srcs)) as pool:
        return dict(pool.map(one, srcs.items()))


def _median_ms(call, xs):
    """Median ms of call(x) over xs (each once untimed first), CUDA events
    behind a sleep kernel."""
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
    return statistics.median(times)


def _report(shape, p, name, ms, nbytes=None):
    extra = "" if nbytes is None else \
        f" ({nbytes} bytes into shared memory, {nbytes / ms / 1e9:.3f} TB/s)"
    print(f"{shape} p={p} {name}: {ms:.4f} ms{extra}", flush=True)


def copied_bytes(shape, p: int) -> int:
    """K2: bytes the blocks copy into shared memory, per block and K-block
    the 18 x 18 halo of 16 fp32 lanes and the weight panel."""
    B, bz, X, Y, pC = shape
    C, Co = pC // p, sc.N_LANES // p
    tiles = -(-X // 16) * -(-Y // 16)
    total = 0
    for _, dg, _, width in sc.kblocks(p, C, Co):
        packs = B * (bz if dg == 0 else bz - 1)
        total += packs * tiles * (18 * 18 * sc.KB * 4 + 9 * sc.KB * width * 2)
    return total


def dw_copied_bytes(shape, p: int) -> int:
    """dW: bytes the blocks copy into shared memory, per unit and tile the
    windows' halos and the x tiles not skipped."""
    B, bz, X, Y, pC = shape
    C = pC // p
    tiles = -(-X // 16) * -(-Y // 16)
    blocks = sc.kblocks(p, C, C)
    total = 0
    for kbs, cols, _ in sc.dw_units(p, C, C):
        total += B * bz * tiles * len(cols) * 18 * 18 * 32 * 2
        for i in kbs:
            packs = B * (bz if blocks[i][1] == 0 else bz - 1)
            total += packs * tiles * 16 * 16 * sc.KB * 2
    return total


def forward(tmp, gen):
    with open(os.path.join(_build.CSRC, "subm_conv.cuh")) as f:
        fns = _build_all("subm_conv.cuh", _variants(f.read()),
                         "subm_conv_f32.cu", "subm_ext_conv", sc.ARGTYPES,
                         tmp)
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
            _report(shape, p, name, _median_ms(call, xs),
                    copied_bytes(shape, p) if name == "copies" else None)


def dw(tmp, gen):
    with open(os.path.join(_build.CSRC, "subm_conv_dw.cuh")) as f:
        fns = _build_all("subm_conv_dw.cuh", _dw_variants(f.read()),
                         "subm_weight_grad.cu", "subm_ext_weight_grad",
                         DW_ARGTYPES, tmp)
    for shape, p in DW_SHAPES:
        B, bz, X, Y, pC = shape
        C = pC // p
        G, E = B * bz, (p + 2) * C
        table = sc._dw_table(p, C, C)
        S = sc.dw_splits(sc.dw_tiles(G, X, Y))
        xs = [torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(5)]
        dy = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        partials = torch.empty(S * len(table) * 2 * sc.DW_ACC, device="cuda")
        gw = torch.zeros((9, E, 128), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for name, fn in fns.items():
            def call(x):
                err = fn(x.data_ptr(), dy.data_ptr(), 0, 0, 1,
                         table.ctypes.data, len(table), S,
                         partials.data_ptr(), gw.data_ptr(), 1, G, bz, X,
                         Y, pC, E, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            _report(shape, p, name, _median_ms(call, xs),
                    dw_copied_bytes(shape, p)
                    if name in ("full", "copies") else None)
        del xs, dy, partials, gw
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k2_ablation needs a CUDA card")
    import chip_smoke as cs   # the repository's root, as `python -m` runs
    print(f"card: {cs.card_line()}", flush=True)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        gen = torch.Generator(device="cuda").manual_seed(0)
        (dw if "--dw" in sys.argv else forward)(tmp, gen)
    print(f"card: {cs.card_line()}")


if __name__ == "__main__":
    main()
