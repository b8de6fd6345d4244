"""Device ms of a speech-first train step, as paired_step_ms reads a paired one."""

from port_bench import harness as H


def read(ctx):
    return H.median_launch_ms(ctx.data["trace"], "port_bench.step.speech_first")
