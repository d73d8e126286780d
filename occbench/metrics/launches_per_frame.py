"""launches_per_frame: kernel launches the host issues inside the port's
eval forward, per frame (runtime calls in the trace). Layer "host
dispatch"; moves frames_per_s."""
from occbench.trace import LAUNCH_NAMES


def read(ctx):
    if ctx.kind != "stream" or not ctx.trace.device \
            or "forward" not in ctx.trace.ranges:
        return None
    return ctx.trace.count_runtime(LAUNCH_NAMES, "forward") / ctx.units
