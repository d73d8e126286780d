"""coocc_tpu_torch and chip_smoke.py import no JAX and nothing of coocc_tpu.

Each check runs in a fresh interpreter, so modules this test process has
already imported cannot hide an import.
"""
import os
import pkgutil
import subprocess
import sys

import coocc_tpu_torch

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
    assert "coocc_tpu_torch.ops.window_knn" in mods
    _run_clean("\n".join(["import coocc_tpu_torch"]
                         + [f"import {m}" for m in mods]))


def test_chip_smoke_imports_without_jax():
    _run_clean("import importlib.util\n"
               "spec = importlib.util.spec_from_file_location("
               "'chip_smoke', 'chip_smoke.py')\n"
               "mod = importlib.util.module_from_spec(spec)\n"
               "spec.loader.exec_module(mod)\n"
               "assert callable(mod.main)")
