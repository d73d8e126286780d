"""Checkpoints: one per epoch, the best one kept apart, a meta file.

Counterpart of coocc_tpu/train/checkpoint.py `CheckpointManager` (reference
mmcv CheckpointHook + OccDistEvalHook, coocc_multi_r50_256x704.py:287-295:
every epoch, max_keep_ckpts=1, save_best='SSC_mean'; resume restores the
optimizer and the epoch, apis/mmdet_train.py:195-198), with JAX's layout:

  work_dir/epoch_N/state.pt   the saved tree (torch.save)
  work_dir/best/              the epoch dir with the best BEST_KEY
  work_dir/ckpt_meta.json     last_epoch, epochs, metrics per epoch, best

The tree the loop saves is {"model": state_dict (parameters and BN running
statistics), "optimizer": Optimizer.state_dict(), "epoch": N}. best/ holds
hard links to the epoch's files, where JAX copies the directory: the same
files under the same names, without a second copy of the flagship's 2.5 GB,
and pruning an epoch dir leaves best/ whole. JAX's orbax checkpoints are not
read. A data-parallel run's rank 0 writes it (train/loop.py): the same
state_dict as one process's, its replicas being equal.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"
BEST_KEY = "SSC_mIoU"


class CheckpointManager:
    def __init__(self, work_dir: str, max_keep: int = 1):
        self.work_dir = os.path.abspath(work_dir)
        os.makedirs(self.work_dir, exist_ok=True)
        self.max_keep = max_keep
        self._meta_path = os.path.join(self.work_dir, "ckpt_meta.json")

    def _epoch_dir(self, epoch: int) -> str:
        return os.path.join(self.work_dir, f"epoch_{epoch}")

    def save(self, state_tree: Any, epoch: int,
             metrics: Optional[Dict[str, float]] = None):
        path = self._epoch_dir(epoch)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        torch.save(state_tree, os.path.join(path, STATE_FILE))

        meta = self._load_meta()
        meta["last_epoch"] = epoch
        meta.setdefault("epochs", []).append(epoch)
        if metrics:
            meta.setdefault("metrics", {})[str(epoch)] = metrics
            best = meta.get("best", {"value": -np.inf})
            if metrics.get(BEST_KEY, -np.inf) > best.get("value", -np.inf):
                meta["best"] = {"epoch": epoch, "key": BEST_KEY,
                                "value": metrics[BEST_KEY]}
                best_path = os.path.join(self.work_dir, "best")
                if os.path.exists(best_path):
                    shutil.rmtree(best_path)
                shutil.copytree(path, best_path, copy_function=os.link)
        self._save_meta(meta)

        # keep only the newest max_keep epoch dirs (best/ is kept separately)
        for old in sorted(meta["epochs"])[:-self.max_keep]:
            p = self._epoch_dir(old)
            if os.path.exists(p):
                shutil.rmtree(p)

    def restore(self, map_location=None):
        """-> (the tree saved at the last epoch, with its tensors on
        map_location; that epoch), or (None, None) before any save."""
        epoch = self._load_meta().get("last_epoch")
        if epoch is None:
            return None, None
        # the tree holds tensors, numbers and dicts only
        return torch.load(os.path.join(self._epoch_dir(epoch), STATE_FILE),
                          map_location=map_location, weights_only=True), epoch

    def _load_meta(self) -> Dict:
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                return json.load(f)
        return {}

    def _save_meta(self, meta: Dict):
        with open(self._meta_path, "w") as f:
            json.dump(meta, f, indent=2, default=float)
