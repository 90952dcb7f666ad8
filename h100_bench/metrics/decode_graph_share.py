"""The share of the traced decode steps whose layers ran from replayed
CUDA graphs, in %: the program's `serve.decode_graph` counter (one a
decode call: graphs replayed, graphs captured, eager 1 where the step ran
eager), steps with graphs > 0 and eager 0 over all its records in the
traced slice.  None where the program counts no such record."""

from h100_bench import spans


def read(run):
    p = spans.program(run)
    if p is None:
        return None
    c = p.named("serve.decode_graph")
    if not c:
        return None
    return 100.0 * sum(r.attrs["graphs"] > 0 and not r.attrs["eager"]
                       for r in c) / len(c)
