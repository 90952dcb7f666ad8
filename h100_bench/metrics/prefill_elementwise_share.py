"""Device time launched in the traced prefill (the program's `lm.prefill`
span) outside its weight products (`lm.dense`) and its attention
(`lm.attend`), over all device time launched in it, in %: norms, RoPE,
casts, cache copies, residual adds, the embedding."""

from h100_bench import spans


def read(run):
    p = spans.program(run)
    return None if p is None else p.elementwise_share()
