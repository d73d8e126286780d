"""mfu.stream: the model's FLOP over the traced window against the card's
bf16 peak, in %: the dense layers at their shapes and the sparse encoder
by its rulebook (occbench/work), per frame, times the frames traced,
over 989e12 FLOP/s times the window. Layer "device"; moves frames_per_s."""
from occbench.work.peaks import BF16_FLOP_PER_S


def read(ctx):
    if ctx.kind != "stream" or ctx.dense_flop is None or ctx.window_s <= 0:
        return None
    flop = ctx.units * ctx.dense_flop + sum(w.flop for w in ctx.sparse)
    return 100.0 * flop / (BF16_FLOP_PER_S * ctx.window_s)
