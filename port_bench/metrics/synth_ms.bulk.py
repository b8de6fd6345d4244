"""Device ms of the synthesis stage of a request: the median over the window's requests of the device time of the operations its first CUDA graph launch issued."""

from port_bench import harness as H


def read(ctx):
    return H.median_launch_ms(ctx.data["trace"], "port_bench.request.", 0)
