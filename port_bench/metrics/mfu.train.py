"""The whole train step's share of the fp32 peak: the plain reference's FLOPs of the window's steps over the traced window, in %."""

from port_bench import harness as H


def read(ctx):
    return H.mfu(ctx, "port_bench.step.")
