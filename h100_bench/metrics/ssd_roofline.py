"""The traced ssd calls' least time (max of operations over 989 TFLOP/s
and bytes over 3.35 TB/s, by `yardstick.ssd_work` from the shapes each
call received) over their device time, in %."""


def read(run):
    return None if run.trace is None else run.trace.roofline("ssd")
