"""The median of each request's own service time, from the benchmark's
spans: its return minus the later of its due time and the previous
request's return (the server runs one request at a time), in ms."""

import statistics


def read(ctx):
    s = ctx.data.get("service_s")
    return statistics.median(s) * 1e3 if s else None
