"""idle_share.train: the share of the traced window in which no kernel,
copy or memset runs on the card, in %. Layer "device"; moves
train_samples_per_s."""


def read(ctx):
    if ctx.kind != "train" or not ctx.trace.device or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / 1e6 / ctx.window_s)
