"""coocc_tpu_torch and chip_smoke.py import no JAX and nothing of coocc_tpu.

Each check runs in a fresh interpreter, so modules this test process has
already imported cannot hide an import.
"""
import os
import pkgutil
import subprocess
import sys

import pytest

import coocc_tpu_torch
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import sys
{imports}
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "jaxlib", "coocc_tpu")
             or m.startswith(("jax.", "flax.", "jaxlib.", "coocc_tpu.")))
assert not bad, bad
print("clean", len(sys.modules))
"""


def _run_clean(imports: str):
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK.format(imports=imports)], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("clean")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        coocc_tpu_torch.__path__, "coocc_tpu_torch."))


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    for m in ("ops.window_knn", "ops.subm_conv", "ops.knn",
              "nn.sparse_enc_packed", "bench", "nn.nerf_mlp",
              "models.renderer", "models.losses", "losses.ssc",
              "losses.lovasz", "losses.gt_pool", "losses.depth",
              "config.nuscenes", "train.state", "train.__main__",
              "parallel.train_step", "parity", "evaluation.ssc_metrics",
              "evaluation.formatting", "evaluation.savers", "train.loop",
              "train.checkpoint", "train.observe", "test.__main__",
              "config.semantic_kitti", "evaluation.render_metrics",
              "parallel.distributed", "parallel.mesh", "ops.interpolate",
              "data.loader", "data.nuscenes_dataset",
              "data.semantic_kitti_dataset", "data.pipelines.image_loading",
              "data.pipelines.lidar2depth", "data.pipelines.load_occupancy",
              "data.pipelines.loading_bevdet", "tools.nuscenes_tree",
              "ops.sparse_conv", "ops.fps", "nn.sparse_enc",
              "nn.sparse_encoder_hd", "nn.swin", "nn.occnet",
              "nn.efficientnet", "nn.alt_necks", "nn.alt_fusers", "nn.moe",
              "nn.flosp", "models.temporal", "ops.ms_deform_attn",
              "nn.image2bev", "nn.mask2former_occ", "models.render_ray",
              "evaluation.panoptic", "evaluation.visualize",
              "evaluation.video", "utils.profiling", "utils.native"):
        assert f"coocc_tpu_torch.{m}" in mods
    _run_clean("\n".join(["import coocc_tpu_torch"]
                         + [f"import {m}" for m in mods]))


def test_lidar_only_sample_imports_no_pil(tmp_path):
    """Building and collating a coocc_lidar sample from a nuScenes tree
    (camera-free geometry, sweeps, depth maps, ground truth, lidarseg)
    imports no PIL, in a fresh interpreter; the camera path's entry raises
    ImportError naming the image path where PIL is missing."""
    code = f"""
import sys
import numpy as np
from coocc_tpu_torch.config import get_config
from coocc_tpu_torch.data.nuscenes_dataset import NuScenesOccDataset, collate
from coocc_tpu_torch.data.pipelines import image_loading
from coocc_tpu_torch.tools.nuscenes_tree import write_tree
f = write_tree({str(tmp_path)!r}, points=2000, sweeps=2, occupied=1000)
cfg = get_config("coocc_lidar")
for train in (True, False):
    ds = NuScenesOccDataset(cfg, f["data_root"], f["ann_file"],
                            f["occ_path"], is_train=train)
    b = collate([ds.get_sample(0, np.random.RandomState(0))], cfg)
    assert b.imgs is None and b.gt_depths.shape == (1, 6, 896, 1600)
assert "PIL" not in sys.modules and image_loading.pil_image.calls == 0
sys.modules["PIL"] = None  # as where Pillow is not installed
try:
    image_loading.load_image("x.jpg")
except ImportError as e:
    assert "camera configs' image path" in str(e)
else:
    raise AssertionError("no ImportError without PIL")
print("clean")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "clean"


def test_chip_smoke_imports_without_jax():
    _run_clean("import importlib.util\n"
               "spec = importlib.util.spec_from_file_location("
               "'chip_smoke', 'chip_smoke.py')\n"
               "mod = importlib.util.module_from_spec(spec)\n"
               "spec.loader.exec_module(mod)\n"
               "assert callable(mod.main)")


@pytest.mark.parametrize("env,error", [
    ({}, "torch.cuda.is_available() is False"),
    ({"BENCH_CONFIG": "coocc_kitti"}, "torch.cuda.is_available() is False")])
def test_bench_prints_no_result_without_a_card(env, error):
    """`python -m coocc_tpu_torch.bench` raises, and prints no JSON line,
    without a card: for the flagship, and for coocc_kitti, whose model
    builds (its forward would raise ValueError past the pts prefix)."""
    proc = subprocess.run(
        [sys.executable, "-m", "coocc_tpu_torch.bench"], cwd=ROOT,
        env={**os.environ, **env}, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert error in proc.stderr


def test_train_cli_raises_without_a_card():
    """`python -m coocc_tpu_torch.train` runs on the card unless `--device
    cpu` is given: without one it raises before any step, and imports no
    JAX on the way (its module is in the list above)."""
    proc = subprocess.run(
        [sys.executable, "-m", "coocc_tpu_torch.train",
         "coocc_multi_r50_256x704", "--synthetic", "--steps-per-epoch", "1",
         "--max-epochs", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "work dir" not in proc.stdout and "epoch 0" not in proc.stderr
    assert "torch.cuda.is_available() is False" in proc.stderr


def test_eval_cli_raises_without_a_card():
    """`python -m coocc_tpu_torch.test` too: it raises before building a
    model, and prints no table."""
    proc = subprocess.run(
        [sys.executable, "-m", "coocc_tpu_torch.test",
         "coocc_multi_r50_256x704", "--synthetic", "--max-steps", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "torch.cuda.is_available() is False" in proc.stderr
