"""The traced slice's least device time over its kernels' busy time, in %
(``Run.kernel_roofline``)."""


def read(run):
    return run.kernel_roofline()
