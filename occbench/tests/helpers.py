"""A tiny cell for the CPU tests: the port's tiny_config under a small
ray-cast stream or train loop, with limits set for that size, every
per-layer reader, and no entry in BENCHMARK.json."""
from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

# the tiny cell's limits: its fp32 port (K2's plain version rounds its
# operands to bf16) reads occ_rms 3.6e-4 and occ_max 8.7e-4 against the
# reference; the fp8 control and the faults read 0.03 and more
TINY_LIMITS = {"occ_rms": 0.005, "occ_max": 0.01, "fine_miss": 0.05,
               "fine_rms": 0.005}


TINY_TRAIN_LIMITS = {"loss_gap": 0.01, "grad_gap": 0.8, "change_gap": 0.5}


STREAM_E2E = [("frames_per_s", "frames/s"), ("frame_ms_p95", "ms"),
              ("peak_gib", "GiB"), ("setup_s", "s")]
TRAIN_E2E = [("train_samples_per_s", "samples/s"), ("peak_gib", "GiB"),
             ("setup_s", "s")]


def _spec(traffic: str, limits: dict, e2e):
    """The tiny cell with the given traffic file, its limits, the
    end-to-end metrics and every per-layer metric whose reader exists."""
    from types import SimpleNamespace

    from occbench import run
    with open(os.path.join(HERE, "tiny_config.json")) as f:
        config = json.load(f)
    with open(os.path.join(HERE, traffic)) as f:
        traffic = json.load(f)
    names = sorted(n[:-3] for n in os.listdir(os.path.join(run.PKG,
                                                           "metrics"))
                   if n.endswith(".py") and n != "__init__.py")
    return SimpleNamespace(
        name="tiny", chips=1, config=config, traffic=traffic,
        limits=dict(limits), pkg=run.PKG,
        e2e=[{"name": n, "unit": u} for n, u in e2e],
        per_layer=[{"name": n, "unit": "x"} for n in names])


def tiny_train_spec():
    """The tiny cell under the train loop."""
    return _spec("tiny_train.json", TINY_TRAIN_LIMITS, TRAIN_E2E)


def tiny_spec():
    """The tiny cell under the stream loop."""
    return _spec("tiny_stream.json", TINY_LIMITS, STREAM_E2E)
