"""The device's idle share of the traced bulk-synthesis window, in %."""

from port_bench import harness as H


def read(ctx):
    return H.idle_share(ctx)
