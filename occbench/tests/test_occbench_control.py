"""The control at a size a test run holds: the fp8 reference in the
program's place fails the tiny cell's limits, which the program passes.
At the cells' own sizes the control's readings come from
`python3 -m occbench.calibrate` on the card (PERF.md)."""
import numpy as np

from occbench import frames
from occbench.reference import compare, control
from occbench.reference import serve as ref
from occbench.tests.helpers import tiny_spec


def test_fp8_control_fails_tiny_limits():
    spec = tiny_spec()
    from occbench import port
    cfg = port.config(spec.config)
    fails = 0
    for seed in (3, 2 ** 31 + 11):
        fs = [frames.make_frame(cfg, spec.traffic, seed, i, "cpu",
                                frames.EVAL_FIELDS) for i in range(2)]
        model = ref.build("tiny", seed, "cpu")
        r = [ref.forward(model, f, "cpu") for f in fs]
        control.make_fp8(model)
        c = [ref.forward(model, f, "cpu") for f in fs]
        ok, _ = compare.judge(compare.stream_numbers(c, r), spec.limits)
        fails += not ok
    assert fails == 2


def test_fp8_round_is_coarser_than_bf16():
    import torch
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    e8 = float((control.fp8_round(x) - x).abs().max())
    e16 = float((x.bfloat16().float() - x).abs().max())
    assert e8 > 8 * e16
    assert np.isfinite(e8)
