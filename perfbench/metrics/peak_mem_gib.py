"""``torch.cuda.max_memory_allocated()`` over the window (reset once the
warm-up has finished), in GiB: the staged inputs and everything the
calls allocate."""


def read(run):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / 2**30
