"""k2_roofline.stream: K2's share of its roofline in the served forward,
in %: the least time the card could take for the SubM convolutions K2
computes (each the larger of its rulebook FLOP over the bf16 peak and its
bytes over HBM's rate, occbench/work) over the device time of the kernels
named here. Layer "kernels"; moves frames_per_s."""
from occbench.work.sparse import k2_least_s

KERNELS = ("subm_ext_conv_kernel",)


def read(ctx):
    if ctx.kind != "stream":
        return None
    t = ctx.trace.kernel_us(KERNELS) / 1e6
    least = k2_least_s(ctx.sparse)
    if t <= 0 or least <= 0:
        return None
    return 100.0 * least / t
