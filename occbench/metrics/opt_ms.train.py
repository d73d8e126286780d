"""opt_ms.train: device ms a step of the kernels launched inside the
optimizer's step (clip, AdamW, schedule). Layer "optimizer"; moves
train_samples_per_s."""


def read(ctx):
    if ctx.kind != "train" or not ctx.trace.device \
            or "opt" not in ctx.trace.ranges:
        return None
    return ctx.trace.kernel_us(None, within="opt") / ctx.units / 1e3
