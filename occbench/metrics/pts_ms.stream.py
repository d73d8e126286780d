"""pts_ms.stream: device ms a frame of the kernels launched inside the
port's LiDAR branch: voxelization and the sparse encoder,
with SECOND3D and its FPN where the config has them (layer "pts"),
read from the trace.
Moves frames_per_s."""


def read(ctx):
    if ctx.kind != "stream" or not ctx.trace.device \
            or "pts" not in ctx.trace.ranges:
        return None
    return ctx.trace.kernel_us(None, within="pts") / ctx.units / 1e3
