"""The median host time of the traced decode steps' model call (the
program's `lm.decode_step` span: the launches of `lm_decode_step`), in
ms.  A reading under the profiler: CUPTI's cost on each launch about
doubles the call (on an H100 host, 149-175 ms against 71 ms under
`spans.recording()` alone), so it scales with the step's launches times
the tracer's cost a launch as much as with the program's own enqueue
work."""

from h100_bench import spans


def read(run):
    p = spans.program(run)
    return None if p is None else p.decode_enqueue_ms()
