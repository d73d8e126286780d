"""head_ms.stream: device ms a frame of the kernels launched inside the
port's occupancy head and its cascade (layer "head"), read from the trace.
Moves frames_per_s."""


def read(ctx):
    if ctx.kind != "stream" or not ctx.trace.device \
            or "head" not in ctx.trace.ranges:
        return None
    return ctx.trace.kernel_us(None, within="head") / ctx.units / 1e3
