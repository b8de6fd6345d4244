"""The whole request's share of the fp32 peak in online serving, as mfu.bulk reads it."""

from port_bench import harness as H


def read(ctx):
    return H.mfu(ctx, "port_bench.request.")
