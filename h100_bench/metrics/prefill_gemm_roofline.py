"""The traced prefill's weight products (the program's `lm.dense` spans):
least time (max of 2·M·K·N over 989 TFLOP/s and (M·K + K·N + M·N)·elt
bytes over 3.35 TB/s, from each span's shapes) over the device time
launched inside them, in %."""

from h100_bench import spans


def read(run):
    p = spans.program(run)
    return None if p is None else p.gemm_roofline()
