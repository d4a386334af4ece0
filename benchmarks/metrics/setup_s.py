"""setup_s: seconds from the process's start to the first timed call: the
kernels built or found, the model and traffic made from the seed, every
shape of the cell warmed, ending on a synchronize (host clock)."""


def read(run, name):
    return run.setup_s
