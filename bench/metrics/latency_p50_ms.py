"""Median, over every request due in the window, of (scores on the host)
- (due time), in ms; a request with no answer counts as later than any."""
from gcvbench.record import percentile


def read(run):
    lat = run.latencies_ms()
    v = percentile(lat, 50) if lat.size else float("inf")
    return v if v != float("inf") else None
