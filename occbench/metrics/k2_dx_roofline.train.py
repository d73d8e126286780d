"""k2_dx_roofline.train: the share of its roofline of K2's dX kernel in the
train step, in %: the least time the card could take for the SubM
convolutions K2 computes (each the larger of its rulebook FLOP, 2 Ci Co a
pair, over the bf16 peak and its active rows' and weights' bytes over
HBM's rate; occbench/work) over the device time of the kernels named
here. Layer "kernels"; moves train_samples_per_s."""
from occbench.work.sparse import k2_least_s

KERNELS = ("subm_ext_conv_dx_kernel",)


def read(ctx):
    if ctx.kind != "train":
        return None
    t = ctx.trace.kernel_us(KERNELS) / 1e6
    least = k2_least_s(ctx.sparse)
    if t <= 0 or least <= 0:
        return None
    return 100.0 * least / t
