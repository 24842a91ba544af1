"""Requests whose correct answer reached the host inside the window, over
the window's seconds (``Run.throughput``)."""


def read(run):
    return run.throughput()
