"""idle_share.stream: the share of the traced window in which no kernel,
copy or memset runs on the card, in %. Layer "device"; moves
frames_per_s."""


def read(ctx):
    if ctx.kind != "stream" or not ctx.trace.device or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / 1e6 / ctx.window_s)
