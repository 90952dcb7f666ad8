"""Pad tokens over all tokens the traced prefill ran through the layers
(the program's `serve.prefill_tokens` counter: B x the padded width
against the prompts' own tokens), in %."""

from h100_bench import spans


def read(run):
    p = spans.program(run)
    return None if p is None else p.pad_share()
