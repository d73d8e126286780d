"""launches_per_step: kernel launches the host issues inside a train step
(the window's copy, forward, losses, backward and optimizer), per step,
from the trace. Layer "host dispatch"; moves train_samples_per_s."""
from occbench.trace import LAUNCH_NAMES


def read(ctx):
    if ctx.kind != "train" or not ctx.trace.device \
            or "step" not in ctx.trace.ranges:
        return None
    return ctx.trace.count_runtime(LAUNCH_NAMES, "step") / ctx.units
