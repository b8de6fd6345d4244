"""Device ms of the vocoder stage of a request: its second CUDA graph launch, as synth_ms.bulk reads the first."""

from port_bench import harness as H


def read(ctx):
    return H.median_launch_ms(ctx.data["trace"], "port_bench.request.", 1)
