"""Of the device's idle time inside the traced decode steps, the share
during which the host was inside the program's `lm.decode_step` span
(enqueueing the step's launches), in %.  Under the profiler, whose
cost on each launch lengthens the span and the idle time alike."""

from h100_bench import spans


def read(run):
    p = spans.program(run)
    return None if p is None else p.idle_in_enqueue()
