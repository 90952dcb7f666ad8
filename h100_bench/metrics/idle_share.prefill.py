"""The share of the traced prefill's wall (to its synchronize) in which
no device record ran, in %."""


def read(run):
    return None if run.trace is None else run.trace.idle_share("prefill")
