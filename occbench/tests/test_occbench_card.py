"""On the card only: one short run of each cell of BENCHMARK.json,
correct (`python -m pytest occbench/tests -m card` on a card)."""
import json
import os

import pytest

from occbench import run


def _cells():
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return bench, [w["name"] for w in bench["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("i", range(24))
def test_cell_on_card(i):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench, cells = _cells()
    if i >= len(cells):
        pytest.skip(f"BENCHMARK.json has {len(cells)} cells")
    cell = cells[i]
    spec = run.cell_spec(bench, cell)
    res = run.run_cell(spec, 2 ** 31 + 99, 2.0, False, "cuda")
    assert res["correct"], res["checks"]
