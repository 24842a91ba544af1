"""What one run recorded, as the metric readers see it (``run`` in each
``bench/metrics/<name>.py``'s ``read(run)``), and the arithmetic they
share."""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from gcvbench import peaks


def percentile(values, q: float) -> float:
    """Nearest-rank ``q``-th percentile (``inf`` sorts last)."""
    xs = np.sort(np.asarray(values, float))
    if xs.size == 0:
        return float("nan")
    rank = max(1, math.ceil(q / 100.0 * xs.size))
    return float(xs[rank - 1])


@dataclasses.dataclass
class Run:
    cell: object                      # spec.Cell
    seed: int
    seconds: float
    trace: bool
    chips: int
    setup_s: float
    compile_s: float
    capture_s: float
    window: object                    # window.Window
    counters0: dict                   # engine counters as the window opens
    counters1: dict                   # and as it closes
    device: object | None             # devtrace.DeviceWindow, traced runs
    flops: np.ndarray                 # reference FLOPs of each pool entry
    io_bytes: np.ndarray              # its inputs + outputs, bytes
    weight_bytes: int                 # every weight once
    ok: np.ndarray | None = None      # per window request: answer correct

    # ----------------------------------------------------------- helpers --
    def counter(self, name: str) -> float:
        """A counter's (or a histogram's count's) rise over the window."""
        return self.counters1.get(name, 0) - self.counters0.get(name, 0)

    def counter_names(self) -> list[str]:
        return sorted(set(self.counters0) | set(self.counters1))

    def latencies_ms(self) -> np.ndarray:
        """Every window request's (scores on the host) - (due time), ms;
        ``inf`` where no answer came or the engine shed the request."""
        w = self.window
        done = np.asarray(w.t_done, float)
        lat = (done - np.asarray(w.t_due)) * 1e3
        none = np.isnan(done) | np.array([r.result is None for r in w.reqs],
                                         bool)
        return np.where(none, np.inf, lat)

    def completed_in_window(self) -> np.ndarray:
        """Mask of the requests whose correct answer came inside the
        window."""
        w = self.window
        done = np.asarray(w.t_done, float)
        inside = (done >= w.t0) & (done <= w.t_end)
        return inside & (self.ok if self.ok is not None else True)

    def least_device_seconds(self, t_a: float, t_b: float) -> float:
        """The least device-seconds (``peaks.least_seconds``) of the batches
        dispatched in ``[t_a, t_b)``: each batch's reference FLOPs at its
        requests' real sizes, against its requests' input and output bytes
        plus every weight read once on each card."""
        w = self.window
        disp: dict[float, list[int]] = {}
        for i, req in enumerate(w.reqs):
            t = req.t_dispatch
            if t and t_a <= t < t_b:
                disp.setdefault(t, []).append(w.pool_idx[i])
        total = 0.0
        for ks in disp.values():
            total += peaks.least_seconds(
                float(self.flops[ks].sum()),
                float(self.io_bytes[ks].sum())
                + self.weight_bytes * self.chips)
        return total

    def idle_share(self) -> float | None:
        """Share of the traced slice in which no operation ran on the
        device, in % (the merged intervals of the profiler's device events;
        the mean over the cards), or None without a trace."""
        dev = self.device
        if dev is None or dev.window_s() <= 0:
            return None
        return 100.0 * (1.0 - dev.busy_s() / dev.window_s())

    def kernel_roofline(self) -> float | None:
        """The least device-seconds of the batches dispatched in the traced
        slice (``least_device_seconds``) over the device-seconds in which a
        kernel (not a copy) ran there, in %, or None without a trace."""
        dev = self.device
        if dev is None:
            return None
        busy = dev.kernel_busy_s()
        least = self.least_device_seconds(*dev.host)
        return 100.0 * least / busy if busy > 0 and least > 0 else None

    def throughput(self) -> float:
        """Requests whose correct answer reached the host inside the
        window, over the window's seconds."""
        return float(self.completed_in_window().sum()) / self.seconds

    def host_ms_per_batch(self) -> float | None:
        """The benchmark's clock around each ``poll()`` of the window that
        dispatched or harvested, summed, over the window's dispatches, in
        ms."""
        batches = self.counter("dispatches")
        return self.window.busy_poll_s * 1e3 / batches if batches else None

    def window_mfu(self) -> float | None:
        """The reference FLOPs of the requests answered correctly in the
        window over (window seconds x cards x 495 TFLOP/s), in %."""
        done = self.completed_in_window()
        flops = float(np.sum(self.flops[np.asarray(self.window.pool_idx)]
                             [done]))
        if flops <= 0:
            return None
        return 100.0 * flops / (self.seconds * self.chips
                                * peaks.FP32_MODEL_PEAK)
