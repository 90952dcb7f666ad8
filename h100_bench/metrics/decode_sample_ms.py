"""The median over the traced decode steps of the host time in the
program's `serve.sample` and `serve.emit` spans (sampling, `.tolist()`
and the appends), in ms."""

from h100_bench import spans


def read(run):
    p = spans.program(run)
    return None if p is None else p.decode_sample_ms()
