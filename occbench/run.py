"""One run of one benchmark cell:

    python3 -m occbench --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's entry in BENCHMARK.json names a configuration and a traffic
mix; everything else is found by name: the configuration's file
(`configs/<config>.json`), the traffic file (`traffic/<traffic>.json`), the
loop that serves it (`loops/<loop>.py`, the loop the traffic file names),
the cell's limits (`limits/<cell>.json`) and each per-layer metric's reader
(`metrics/<metric>.py`, or that of its name's longest dotted prefix
that has one). A `--trace 0` run prints the cell's end-to-end
metrics, a `--trace 1` run its per-layer metrics and the trace's breakdown.
The last line of standard output is one JSON object; the numbers that
decide `correct` are the last lines of standard error and the last key of
that object.

A run exits with another code than 0, and prints no result, where there is
no CUDA card (or fewer than the cell asks for), where the port or the
benchmark's own files cannot be found, and where JAX or the JAX package is
loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from types import ModuleType, SimpleNamespace
from typing import Dict

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "coocc_tpu")


class RunError(Exception):
    """A run that cannot give a result."""


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc), or
    since this module was loaded where /proc is not there."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return time.time() - (btime + start_ticks
                              / os.sysconf("SC_CLK_TCK"))
    except (OSError, StopIteration, ValueError, IndexError):
        return time.time() - _LOADED


_LOADED = time.time()


def set_cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernel builds go to its fixed coocc_tpu_torch/_build/)."""
    base = os.path.join(ROOT, ".occbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_ext")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(base, "nv")
    os.environ["USE_FLAX"] = "0"


def load_json(*parts) -> dict:
    path = os.path.join(*parts)
    if not os.path.exists(path):
        raise RunError(f"missing {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    """A Python file of the benchmark, loaded by its path."""
    if not os.path.exists(path):
        raise RunError(f"missing {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench: dict, workload: str, pkg: str = PKG) -> SimpleNamespace:
    """Everything one cell needs, found by the names in BENCHMARK.json."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.dirname(pkg), conf["file"])
    traffic = load_json(pkg, "traffic", f"{w['traffic']}.json")
    limits = load_json(pkg, "limits", f"{workload}.json")

    def reports(m):
        return workload in m.get("workloads", [workload])
    e2e = [m for m in bench["end_to_end"] if reports(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return SimpleNamespace(name=workload, chips=w["chips"], config=config,
                           traffic=traffic, limits=limits, e2e=e2e,
                           per_layer=per_layer, pkg=pkg)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def e2e_value(e2e: Dict[str, float], name: str) -> float:
    """The loop's reading of an end-to-end metric: by its name, or by its
    name's longest dotted prefix (`frames_per_s.lidar` is a cell's own
    `frames_per_s`, under a bound of its own)."""
    parts = name.split(".")
    for i in range(len(parts), 0, -1):
        key = ".".join(parts[:i])
        if key in e2e:
            return e2e[key]
    raise RunError(f"the loop gives no reading of {name}")


def reader_path(pkg: str, name: str) -> str:
    """metrics/<name>.py, or the reader of the longest dotted prefix of the
    name that has one: a quantity split by the end-to-end metric it moves
    (`pts_ms.stream.lidar` beside `pts_ms.stream`) is read alike."""
    parts = name.split(".")
    for i in range(len(parts), 0, -1):
        path = os.path.join(pkg, "metrics", ".".join(parts[:i]) + ".py")
        if os.path.exists(path):
            return path
    return os.path.join(pkg, "metrics", f"{name}.py")


def read_per_layer(spec, ctx) -> Dict[str, dict]:
    """Each per-layer metric's reader over the traced run; a reader that
    finds nothing returns None and its metric is left out."""
    out = {}
    for m in spec.per_layer:
        mod = load_module(reader_path(spec.pkg, m["name"]),
                          f"occbench_metric_{m['name'].replace('.', '_')}")
        v = mod.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(spec, seed: int, seconds: float, trace: bool, device: str,
             fault=None) -> dict:
    """Run the cell's loop and its check; -> the result object. `fault`
    (tests only) breaks the timed path: it is handed the served model."""
    loop = load_module(os.path.join(spec.pkg, "loops",
                                    f"{spec.traffic['loop']}.py"),
                       f"occbench_loop_{spec.traffic['loop']}")
    res = loop.run(spec, seed, seconds, trace, device, fault=fault)
    found = forbidden_modules()
    if found:
        raise RunError("modules of JAX or the JAX package are loaded: "
                       + ", ".join(found))
    if trace:
        metrics = read_per_layer(spec, res.ctx)
    else:
        metrics = {m["name"]: {"value": float(e2e_value(res.e2e,
                                                        m["name"])),
                               "unit": m["unit"]} for m in spec.e2e}
    out = {"correct": bool(res.correct), "attempted": int(res.attempted),
           "failed": int(res.failed), "metrics": metrics,
           "device": res.device}
    if trace:
        out["breakdown"] = res.breakdown
    out["load"] = res.load
    out["checks"] = res.checks
    return out


def build_files() -> set:
    """(path, mtime) of every file the port's kernel builds and the
    benchmark's caches hold: a run whose set-up adds or rewrites one
    compiled, and its `setup_s` is not a warm one."""
    found = set()
    for d in (os.path.join(ROOT, "coocc_tpu_torch", "_build"),
              os.path.join(ROOT, ".occbench_cache")):
        for dirpath, _, names in os.walk(d):
            for n in names:
                p = os.path.join(dirpath, n)
                try:
                    found.add((p, os.stat(p).st_mtime_ns))
                except OSError:
                    pass
    return found


def card_check(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise RunError("torch.cuda.is_available() is False: no CUDA card")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} are visible")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m occbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    before = build_files()
    try:
        bench = load_json(ROOT, "BENCHMARK.json")
        spec = cell_spec(bench, args.workload)
        card_check(spec.chips)
        result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                          "cuda")
    except (RunError, ImportError) as e:
        print(f"occbench: {e}", file=sys.stderr, flush=True)
        return 2
    # the set-up of a run that built a kernel is not a warm one: say so
    checks = result.pop("checks")
    result["setup_built"] = bool(build_files() - before)
    result["checks"] = checks
    print(f"occbench: set-up built kernels: {result['setup_built']}; "
          f"cascade load: {json.dumps(result['load'])}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
