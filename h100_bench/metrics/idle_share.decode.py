"""The share of the traced decode steps' wall (from one decode call to
the next: the model's step, sampling and the host's wait for the tokens)
in which no device record ran, in %."""


def read(run):
    return None if run.trace is None else run.trace.idle_share("step")
