"""Kernel records launched in the traced decode steps, a step: the host
loop's launches (`ServeEngine.generate` and the layers under it)."""


def read(run):
    return None if run.trace is None else \
        run.trace.kernels_launched_in("step")
