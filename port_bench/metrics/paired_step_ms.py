"""Device ms of a paired train step: the median over the window's paired steps of the device time of the operations their CUDA graph launches issued (by the profiler's correlation ids)."""

from port_bench import harness as H


def read(ctx):
    return H.median_launch_ms(ctx.data["trace"], "port_bench.step.paired")
