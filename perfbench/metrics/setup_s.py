"""Process start to the first timed call, host clock: imports, the CUDA
context, the kernels' and the codec's library (built on a checkout's
first run), the inputs made from the seed, the warm-up."""


def read(run):
    return run.setup_s
