"""The hand-written kernels' share of their roofline in bulk synthesis, as kernel_roofline.train reads it."""

from port_bench import harness as H


def read(ctx):
    return H.kernel_roofline(ctx, "port_bench.request.")
