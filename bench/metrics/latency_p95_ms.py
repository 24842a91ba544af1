"""The 95th percentile (nearest rank) of the same latencies as
``latency_p50_ms``."""
from gcvbench.record import percentile


def read(run):
    lat = run.latencies_ms()
    v = percentile(lat, 95) if lat.size else float("inf")
    return v if v != float("inf") else None
