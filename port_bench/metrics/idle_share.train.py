"""The device's idle share of the traced training window: 1 - the union of its operations' intervals over the window, in %."""

from port_bench import harness as H


def read(ctx):
    return H.idle_share(ctx)
