"""The requests' own KV cache rows (prompt and tokens so far, of the
requests still served) over the rows reserved (B x max_len), from the
program's `serve.kv_rows` counter, the mean over the traced decode
steps, in %."""

from h100_bench import spans


def read(run):
    p = spans.program(run)
    return None if p is None else p.kv_used_share()
