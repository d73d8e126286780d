"""The cascade's load: the empty-class shift makes the reference call the
frame's LiDAR cells occupied, and a frame on which the reference refines
no cell cannot pass the check."""
import torch

from occbench import frames, port
from occbench.reference import compare, occupancy
from occbench.reference import serve as ref
from occbench.tests.helpers import tiny_spec


def test_shift_sets_the_occupied_cells_to_the_lidar_cells():
    spec = tiny_spec()
    cfg = port.config(spec.config)
    frame = frames.make_frame(cfg, spec.traffic, 2 ** 31 + 5, 0, "cpu",
                              frames.EVAL_FIELDS)
    occ = occupancy.shift("tiny", 2 ** 31 + 5, frame, "cpu", train=False)
    rcfg = occupancy.ref_config("tiny")
    n_cells = 1
    for s in occupancy.coarse_grid(rcfg):
        n_cells *= s
    assert 0 < occ["target_cells"] < n_cells
    model = ref.build("tiny", 2 ** 31 + 5, "cpu", occ["shift"])
    out = ref.forward(model, frame, "cpu")
    got = occupancy.counts(out, rcfg.occ_head.cascade_ratio)
    assert got["occupied"] == occ["target_cells"]
    assert got["refined"] == min(occ["target_cells"],
                                 rcfg.occ_head.max_coarse_occupied)


def test_no_reference_cell_reads_inf():
    n, c = 16, 17
    out = {"occ": torch.zeros(1, 2, 2, 2, c),
           "fine_logits": torch.randn(1, n, c),
           "fine_coords": torch.zeros(1, n, 3, dtype=torch.int32),
           "fine_valid": torch.zeros(1, n, dtype=torch.bool)}
    nums = compare.fine_numbers(out, out)
    assert all(v == float("inf") for v in nums.values())


def test_extra_cells_count_as_misses():
    n, c = 16, 17
    coords = torch.arange(n * 3, dtype=torch.int32).reshape(1, n, 3)
    logits = torch.randn(1, n, c)
    ref_out = {"fine_logits": logits, "fine_coords": coords,
               "fine_valid": torch.arange(n)[None] < 8}
    port_out = dict(ref_out, fine_valid=torch.ones(1, n, dtype=torch.bool))
    nums = compare.fine_numbers(port_out, ref_out)
    assert nums["fine_miss"] == 1.0 and nums["fine_rms"] == 0.0
