"""The whole request's share of the fp32 peak in bulk synthesis: the plain reference's FLOPs of the window's requests over the traced window, in %."""

from port_bench import harness as H


def read(ctx):
    return H.mfu(ctx, "port_bench.request.")
