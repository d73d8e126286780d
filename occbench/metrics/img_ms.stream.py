"""img_ms.stream: device ms a frame of the kernels launched inside the
port's image branch: backbone, neck and the LSS view
transformer (layer "img"), read from the trace.
Moves frames_per_s."""


def read(ctx):
    if ctx.kind != "stream" or not ctx.trace.device \
            or "img" not in ctx.trace.ranges:
        return None
    return ctx.trace.kernel_us(None, within="img") / ctx.units / 1e3
