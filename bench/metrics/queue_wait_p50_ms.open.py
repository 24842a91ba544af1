"""Median of ``t_dispatch - t_submit`` (the engine's own stamps) over the
window's requests that were dispatched, in ms."""
import numpy as np


def read(run):
    waits = [(r.t_dispatch - r.t_submit) * 1e3 for r in run.window.reqs
             if r.t_dispatch]
    return float(np.median(waits)) if waits else None
