"""What a run and the reference load: no module whose top-level name is
jax, jaxlib, flax, optax, orbax or coocc_tpu (compared whole, so the port
coocc_tpu_torch does not match), and nothing of the port in the
reference."""
import subprocess
import sys

from occbench import run

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "coocc_tpu")

RUN = """
import json, sys
from occbench import run
from occbench.tests.helpers import tiny_spec
res = run.run_cell(tiny_spec(), 9, 0.5, True, "cpu")
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""

REF = """
import json, sys
import occbench.reference.serve, occbench.reference.compare
import occbench.reference.control, occbench.reference.weights
import occbench.reference.occref.models.losses
import occbench.reference.occref.train.state
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def _top_names(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=600)
    import json
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_names(RUN)
    assert "coocc_tpu_torch" in names
    assert not names & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    names = _top_names(REF)
    assert not names & (set(FORBIDDEN) | {"coocc_tpu_torch"})


def test_forbidden_names_compare_whole():
    before = dict(sys.modules)
    try:
        sys.modules["coocc_tpu_torch_x"] = sys
        assert "coocc_tpu_torch_x" not in run.forbidden_modules()
        sys.modules["jax.numpy"] = sys
        assert run.forbidden_modules() == ["jax"]
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]
