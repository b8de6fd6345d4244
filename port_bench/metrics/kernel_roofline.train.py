"""The hand-written kernels' share of their roofline in training: the least time of their calls in the window's steps over their device time, in %."""

from port_bench import harness as H


def read(ctx):
    return H.kernel_roofline(ctx, "port_bench.step.")
