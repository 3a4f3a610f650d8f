"""The limiter front end (rectify, hard-clip gain, centred sliding max)
against its byte bound, in %.  Work per call on a target of n samples:
the stereo track read once (2n values), the hard-clip gain and the slided
envelope written once (2n values), at the card's HBM bandwidth; time: the
kernels named in ``limiter_front_end_roofline/kernels/``."""

from perfbench import arithmetic


def read(run):
    return arithmetic.roofline(run, __file__, values_per_sample=4)
