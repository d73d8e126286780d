"""sem_ms.stream: device ms a frame of the kernels launched inside the
port's semantic stack, CustomResNet3D and FPN3D (layer "sem"), read
from the trace.
Moves frames_per_s."""


def read(ctx):
    if ctx.kind != "stream" or not ctx.trace.device \
            or "sem" not in ctx.trace.ranges:
        return None
    return ctx.trace.kernel_us(None, within="sem") / ctx.units / 1e3
