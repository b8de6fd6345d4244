"""The device's idle share of the traced online-serving window, in %."""

from port_bench import harness as H


def read(ctx):
    return H.idle_share(ctx)
