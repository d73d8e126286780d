"""One cell end to end on the CPU at the port's tiny_config, through the
kernels' plain versions: the result's keys, a passing check, and the check
failing when the timed path is broken underneath."""
import torch

from occbench import run
from occbench.tests.helpers import tiny_spec

SEED = 2 ** 31 + 7


def test_tiny_cell_untraced():
    res = run.run_cell(tiny_spec(), SEED, 1.0, False, "cpu")
    assert res["correct"] is True
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"frames_per_s", "frame_ms_p95",
                                   "peak_gib", "setup_s"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def test_tiny_cell_traced():
    res = run.run_cell(tiny_spec(), SEED, 1.0, True, "cpu")
    assert res["correct"] is True
    assert "breakdown" in res and "window_s" in res["device"]
    # no device on the CPU: the device readers find nothing, mfu counts
    assert "k2_roofline.stream" not in res["metrics"]
    assert "mfu.stream" in res["metrics"]


class _Altered:
    """The served model with its answer altered where it is produced."""

    def __init__(self, model, key, fn):
        self.model, self.key, self.fn = model, key, fn

    def __call__(self, batch):
        out = self.model(batch)
        out[self.key] = self.fn(out[self.key])
        return out


def test_altered_answer_is_not_correct():
    res = run.run_cell(tiny_spec(), SEED, 1.0, False, "cpu",
                       fault=lambda m: _Altered(m, "occ", lambda t: t + 0.5))
    assert res["correct"] is False
    assert res["checks"]["occ_rms"]["value"] > \
        res["checks"]["occ_rms"]["limit"]


def test_altered_fine_answer_is_not_correct():
    res = run.run_cell(
        tiny_spec(), SEED, 1.0, False, "cpu",
        fault=lambda m: _Altered(m, "fine_logits",
                                 lambda t: t.flip(-1)))
    assert res["correct"] is False


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        return
    rc = run.main(["--workload", "lidar.stream", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
