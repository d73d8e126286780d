"""Run records: a JSONL metric stream and the config/env dump in work_dir.

Counterpart of coocc_tpu/train/observe.py (reference TextLoggerHook +
TensorboardLoggerHook, _base_/default_runtime.py; the env/config dump of
tools/train.py:174-204): every run writes

  work_dir/metrics.jsonl   one JSON object per logged event
  work_dir/config.json     the full (dataclass) config
  work_dir/env.json        python, torch, CUDA and the card

with JAX's record fields (kind, wall_time, epoch, iter and the scalars).
TensorBoard event files are written too where torch.utils.tensorboard
imports.
"""
from __future__ import annotations

import dataclasses
import json
import os
import platform
import subprocess
import sys
import time
from typing import Any, Dict, Optional

import torch


def _jsonable(x: Any):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {k: _jsonable(v) for k, v in dataclasses.asdict(x).items()}
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    return repr(x)


def _card() -> Optional[str]:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def dump_run_metadata(work_dir: str, cfg) -> None:
    os.makedirs(work_dir, exist_ok=True)
    with open(os.path.join(work_dir, "config.json"), "w") as f:
        json.dump(_jsonable(cfg), f, indent=2)
    env: Dict[str, Any] = {
        "python": sys.version,
        "platform": platform.platform(),
        "argv": sys.argv,
        "time": time.strftime("%Y-%m-%d %H:%M:%S"),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_count": torch.cuda.device_count(),
    }
    if torch.cuda.is_available():
        env["devices"] = [torch.cuda.get_device_name(i)
                          for i in range(torch.cuda.device_count())]
        env["card"] = _card()
    with open(os.path.join(work_dir, "env.json"), "w") as f:
        json.dump(env, f, indent=2)


class MetricsLogger:
    """Append-only JSONL metric stream, mirrored to TensorBoard where
    torch.utils.tensorboard imports."""

    def __init__(self, work_dir: str):
        os.makedirs(work_dir, exist_ok=True)
        self._path = os.path.join(work_dir, "metrics.jsonl")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            SummaryWriter = None
        self._tb = None if SummaryWriter is None else SummaryWriter(
            log_dir=os.path.join(work_dir, "tf_logs"))

    def log(self, kind: str, *, epoch: Optional[int] = None,
            iter: Optional[int] = None, **scalars) -> None:
        rec: Dict[str, Any] = {"kind": kind, "wall_time": time.time()}
        if epoch is not None:
            rec["epoch"] = epoch
        if iter is not None:
            rec["iter"] = iter
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = _jsonable(v)
        with open(self._path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            step = (epoch or 0) * 1_000_000 + (iter or 0)
            for k, v in rec.items():
                if k in ("kind", "wall_time", "epoch", "iter"):
                    continue
                if isinstance(v, float):
                    self._tb.add_scalar(f"{kind}/{k}", v, step)
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
