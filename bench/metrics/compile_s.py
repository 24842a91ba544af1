"""Seconds of ``gcv.serve``'s construction, which traces and compiles each
model function through ``gcv.compile(fn, example)`` (one per graph
bucket)."""


def read(run):
    return run.compile_s
