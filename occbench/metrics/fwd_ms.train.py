"""fwd_ms.train: device ms a step of the kernels launched inside the
model's training forward. Layer "model"; moves train_samples_per_s."""


def read(ctx):
    if ctx.kind != "train" or not ctx.trace.device \
            or "forward" not in ctx.trace.ranges:
        return None
    return ctx.trace.kernel_us(None, within="forward") / ctx.units / 1e3
