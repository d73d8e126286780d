"""mfu.train: the model's FLOP over the traced window against the card's
bf16 peak, in %: a step counts three forwards (the dense layers at their
shapes and the sparse encoder by its rulebook, occbench/work) times the
steps traced, over 989e12 FLOP/s times the window. Layer "device"; moves
train_samples_per_s."""
from occbench.work.peaks import BF16_FLOP_PER_S


def read(ctx):
    if ctx.kind != "train" or ctx.dense_flop is None or ctx.window_s <= 0:
        return None
    flop = ctx.units * ctx.dense_flop + sum(w.flop for w in ctx.sparse)
    return 100.0 * ctx.train_forwards * flop / (
        BF16_FLOP_PER_S * ctx.window_s)
