"""Model flops of the decode steps' rows still serving over the decode
calls' wall (host clock, to a synchronize) times 989 TFLOP/s, over the
window's unprofiled decode steps."""

from h100_bench import yardstick


def read(run):
    steps = [s for s in run.window.steps
             if s.kind == "decode" and not s.profiled]
    wall = sum(s.seconds for s in steps)
    if not steps or wall <= 0:
        return None
    flops = sum(yardstick.decode_flops(run.cfg, s.contexts) for s in steps)
    return 100.0 * flops / (wall * yardstick.PEAK_FLOPS)
