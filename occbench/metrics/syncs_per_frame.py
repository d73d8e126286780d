"""syncs_per_frame: calls inside the port's eval forward at which the host
waits for the device (stream, event and device synchronizations and
synchronous copies), per frame, from the trace. Layer "host dispatch";
moves frames_per_s."""
from occbench.trace import SYNC_NAMES


def read(ctx):
    if ctx.kind != "stream" or not ctx.trace.device \
            or "forward" not in ctx.trace.ranges:
        return None
    return ctx.trace.count_runtime(SYNC_NAMES, "forward") / ctx.units
