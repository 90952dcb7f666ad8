"""Model flops the prefills' requests need (their own prompt tokens, the
pads left out) over the prefills' wall (host clock, to a synchronize)
times 989 TFLOP/s, over the window's unprofiled prefills."""

from h100_bench import yardstick


def read(run):
    steps = [s for s in run.window.steps
             if s.kind == "prefill" and not s.profiled]
    wall = sum(s.seconds for s in steps)
    if not steps or wall <= 0:
        return None
    flops = sum(yardstick.prefill_flops(run.cfg, s.prompt_lens)
                for s in steps)
    return 100.0 * flops / (wall * yardstick.PEAK_FLOPS)
