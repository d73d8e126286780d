"""fuse_ms.stream: device ms a frame of the kernels launched inside the
port's fuser, BiFuserN with K1 (layer "fuse"), read from the trace.
Moves frames_per_s."""


def read(ctx):
    if ctx.kind != "stream" or not ctx.trace.device \
            or "fuse" not in ctx.trace.ranges:
        return None
    return ctx.trace.kernel_us(None, within="fuse") / ctx.units / 1e3
