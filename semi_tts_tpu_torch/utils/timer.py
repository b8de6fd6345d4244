"""Step-time breakdown and the profiler window (counterpart of
`semi_tts_tpu/utils/timer.py`).

`Timer` adds host wall time to the categories a loop names (read, forward,
backward) and reports ``sec/step (rd x% | fw y% | bw z%)``. It reads the
host's clock only and never synchronises the card, so a loop whose steps
are queued ahead of the card (CUDA graph replays) keeps them queued: the
time a step waits for the card shows in the category that waits.
`profile_trace` is a `torch.profiler` window over a block of steps whose
trace (CPU and CUDA activities) lands in a log directory.
"""

from __future__ import annotations

import contextlib
import time


class Timer:
    def __init__(self, categories=("rd", "fw", "bw")):
        self.categories = tuple(categories)
        self.prev_t = time.time()
        self.clear()

    def set(self):
        self.prev_t = time.time()

    def cnt(self, mode):
        """Add the time since the last mark to ``mode``; the last category
        ends a step."""
        self.time_table[mode] += time.time() - self.prev_t
        self.set()
        if mode == self.categories[-1]:
            self.click += 1

    def show(self):
        """``{seconds a step} sec/step ({category share}, ...)`` since the
        last `show`, which clears the table."""
        total = sum(self.time_table.values())
        avg = total / max(self.click, 1)
        parts = " | ".join(
            f"{k} {100 * v / total:.1f}%" for k, v in self.time_table.items()) if total else ""
        self.clear()
        return f"{avg:.3f} sec/step ({parts})"

    def clear(self):
        self.time_table = {c: 0.0 for c in self.categories}
        self.click = 0


def profile_window(start_step: int, max_step: int):
    """(first, end) step of a run's ``--profile`` window, anchored to the
    step the run starts at (so a resumed run profiles too): up to 20 steps
    from step ``start + min(40, max(1, (max_step - start) // 2))``, ending
    at ``max_step`` at the latest."""
    first = start_step + min(40, max(1, (max_step - start_step) // 2))
    return first, min(max_step, first + 20)


@contextlib.contextmanager
def profile_trace(logdir):
    """A `torch.profiler` window over the block: CPU and CUDA activities,
    the trace exported into ``logdir`` (``*.pt.trace.json``, which
    TensorBoard's profiler plugin and chrome://tracing read)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))):
        yield
