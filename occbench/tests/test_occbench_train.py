"""The train loop end to end on the CPU at the port's tiny_config: a sound
run passes, and a step that leaves the state unchanged does not."""
import torch

from occbench import run
from occbench.tests.helpers import tiny_train_spec

SEED = 2 ** 31 + 21


def test_tiny_train_cell():
    res = run.run_cell(tiny_train_spec(), SEED, 0.5, False, "cpu")
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"train_samples_per_s", "peak_gib",
                                   "setup_s"}
    assert list(res)[-1] == "checks"


class _Frozen:
    """A step that computes as usual and returns the state unchanged."""

    def __init__(self, trainer):
        self.trainer = trainer

    def __call__(self, batch):
        params = list(self.trainer.model.parameters())
        keep = [p.detach().clone() for p in params]
        out = self.trainer.step(batch)
        with torch.no_grad():
            for p, k in zip(params, keep):
                p.copy_(k)
        return out


def test_unchanged_state_is_not_correct():
    res = run.run_cell(tiny_train_spec(), SEED, 0.5, False, "cpu",
                       fault=_Frozen)
    assert res["correct"] is False
    assert res["checks"]["change_gap"]["value"] > 0.9
