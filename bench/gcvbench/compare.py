"""The comparison that decides ``correct``: every answer of the window
held to the plain reference of the request it answered.

A reference module names its one compared number and limit in ``CHECK``
(``{"name": ..., "limit": ...}``).  The number is the largest, over the
window's answered requests, of a request's gap to the reference: the
largest absolute difference over its outputs, divided by the largest
magnitude of the reference's outputs for that request.  An answer that is
not finite reads ``NOT_FINITE``; a request with no answer is not read here
but counts as failed.
"""
from __future__ import annotations

import numpy as np

NOT_FINITE = 3.4e38


def gap(got, want) -> float:
    """One request's relative gap (module docstring)."""
    scale = max(float(np.max(np.abs(w))) for w in want)
    worst = 0.0
    for g, w in zip(got, want):
        g = np.asarray(g, np.float64)
        if g.shape != np.shape(w) or not np.isfinite(g).all():
            return NOT_FINITE
        worst = max(worst, float(np.max(np.abs(g - w))))
    return worst / scale if scale > 0 else (0.0 if worst == 0 else
                                            NOT_FINITE)


def hold(reference, got: list, want: list) -> tuple[dict, np.ndarray]:
    """-> (``{name: {"value", "limit"}}``, per request: answered and within
    the limit).  ``got[i]`` is the served tuple of outputs (None: no
    answer), ``want[i]`` the reference's for the same request."""
    limit = float(reference.CHECK["limit"])
    gaps = np.array([gap(g, w) if g is not None else np.nan
                     for g, w in zip(got, want)], float)
    answered = ~np.isnan(gaps)
    value = float(gaps[answered].max()) if answered.any() else NOT_FINITE
    ok = answered & (np.nan_to_num(gaps, nan=np.inf) <= limit)
    return {reference.CHECK["name"]: {"value": value, "limit": limit}}, ok
