"""Device time launched inside the program's `lm.moe` spans (the routed
experts and the shared MLP) of the traced decode steps over all device
time launched in those steps (`lm.decode_step`), in %.  None where the
program records no such span."""

from h100_bench import spans


def read(run):
    p = spans.program(run)
    if p is None:
        return None
    steps = p.named("lm.decode_step")
    total = sum(p.device_s(r) for r in steps)
    part = sum(p.device_s(r) for r in p.named("lm.moe", steps))
    return 100.0 * part / total if total > 0 and part > 0 else None
