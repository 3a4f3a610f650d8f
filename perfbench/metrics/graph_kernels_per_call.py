"""CUDA kernels launched in the traced window (``torch.profiler``) per
call completed in it: a count of the graph's launches, which repeats
exactly for one seed."""


def read(run):
    if run.trace is None or not run.calls:
        return None
    kernels = run.trace.kernels()
    if not kernels:
        return None
    return len(kernels) / len(run.calls)
