"""Seconds from the process's start to the window's first request:
imports, the weights and requests drawn, compile, captures, the warm
pass through every bucket."""


def read(run):
    return run.setup_s
