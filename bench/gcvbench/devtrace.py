"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
last ``SLICE_S`` seconds of the measured window, reduced to busy and
idle time, the device operations that took most time, and the idle gaps
by what the benchmark's host loop was doing.

The profiler is entered before the window, waiting; it warms up
``LEAD_S`` before the slice and records the slice, so that nothing it
sets up falls into the slice.  It stops where the window closes.  Its
events carry the profiler's own clock; one ``record_function`` marker,
stamped on the benchmark's clock as it starts, maps the benchmark's host
spans onto that clock.

The interval merge (``busy``) is ``chip_smoke.device_busy``'s.
"""
from __future__ import annotations

import time

SLICE_S = 2.0
LEAD_S = 0.3
MARK = "gcvbench.mark"

clock = time.perf_counter


def busy(spans) -> float:
    """The time some interval of ``spans`` (``(start, end)`` pairs) covers."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    total, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s)


def gaps(spans) -> list[tuple[float, float]]:
    """The holes between the merged intervals of ``spans``."""
    spans = sorted(spans)
    out = []
    if not spans:
        return out
    cur_e = spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            out.append((cur_e, s))
        cur_e = max(cur_e, e)
    return out


def kernel_base(name: str) -> str:
    """A profiled kernel's bare function name (``chip_smoke.kernel_base``):
    ``void ns::shift_conv_tf32x3_kernel<64, false>(...)`` ->
    ``shift_conv_tf32x3_kernel``; a copy keeps its whole name."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return head.split("<", 1)[0].split()[-1].split("::")[-1]


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


class NullTracer:
    """``--trace 0``: no profiler, no host spans."""
    result = None

    def arm(self, t_end: float) -> None:
        pass

    def tick(self, now: float) -> None:
        pass

    def recording(self, t: float) -> bool:
        return False

    def close(self) -> None:
        pass


class DeviceTracer(NullTracer):
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, schedule
        self._prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=1, warmup=1, active=1, repeat=1))
        self._prof.__enter__()
        self._stage = 0          # 0 waiting, 1 warming, 2 recording, 3 done
        self._marks = None
        self.t_rec = (float("inf"), float("inf"))

    def arm(self, t_end: float) -> None:
        self.t_rec = (t_end - SLICE_S, t_end)

    def recording(self, t: float) -> bool:
        return self._stage == 2 and self.t_rec[0] <= t < self.t_rec[1]

    def tick(self, now: float) -> None:
        import torch
        if self._stage == 0 and now >= self.t_rec[0] - LEAD_S:
            self._prof.step()
            self._stage = 1
        elif self._stage == 1 and now >= self.t_rec[0]:
            self._prof.step()
            self._stage = 2
            with torch.profiler.record_function(MARK):
                self._marks = clock()
            self.t_rec = (self._marks, self.t_rec[1])
        elif self._stage == 2 and now >= self.t_rec[1]:
            self.t_rec = (self.t_rec[0], now)
            self._prof.step()
            self._stage = 3

    def close(self) -> None:
        """Stop the profiler (if the window did not) and read its events."""
        if self._stage < 3:
            self._stage = 3
        self._prof.__exit__(None, None, None)
        self.result = self._read()

    def _read(self):
        """``DeviceWindow`` of the recorded slice, or None where the
        profiler recorded no device operation (then no metric of the
        trace is read: a reader finds nothing and returns None)."""
        from torch.autograd import DeviceType
        dev, mark, seen = {}, None, set()
        for e in self._prof.events():
            key = (e.name, e.time_range.start, e.time_range.end)
            if key in seen:
                continue
            seen.add(key)
            if e.device_type == DeviceType.CUDA:
                if e.name.startswith("ProfilerStep"):
                    continue
                dev.setdefault(e.device_index, []).append(
                    (e.time_range.start * 1e-6, e.time_range.end * 1e-6,
                     e.name))
            elif e.name == MARK:
                mark = e.time_range.start * 1e-6
        if not dev or mark is None or self._marks is None:
            return None
        return DeviceWindow(dev, offset=self._marks - mark,
                            host=self.t_rec)


class DeviceWindow:
    """The recorded slice, on the benchmark's clock (seconds)."""

    def __init__(self, per_device: dict, offset: float, host: tuple):
        self.host = host                           # (start, end), host
        self.devices = {d: [(s + offset, e + offset, n) for s, e, n in evs]
                        for d, evs in sorted(per_device.items())}

    def _each(self, keep=lambda name: True):
        for evs in self.devices.values():
            yield [(s, e) for s, e, n in evs if keep(n)]

    def window_s(self) -> float:
        """Mean over the cards of the span from the first device
        operation's start to the last one's end."""
        lens = [max(e for _, e in sp) - min(s for s, _ in sp)
                for sp in self._each()]
        return sum(lens) / len(lens)

    def busy_s(self) -> float:
        """Mean over the cards of the time some operation ran."""
        vals = [busy(sp) for sp in self._each()]
        return sum(vals) / len(vals)

    def kernel_busy_s(self) -> float:
        """The time some kernel (not a copy or fill) ran, summed over the
        cards: device-seconds of compute."""
        return sum(busy(sp) for sp in self._each(lambda n: not is_copy(n)))

    def device_ops(self, top: int = 10) -> list:
        """The operations that took most time, by bare name, in seconds
        summed over the cards."""
        tot: dict[str, float] = {}
        for evs in self.devices.values():
            for s, e, n in evs:
                k = kernel_base(n)
                tot[k] = tot.get(k, 0.0) + (e - s)
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, spans, top: int = 10) -> list:
        """Idle device time by what the host loop was doing meanwhile: each
        gap's time split over the host spans that overlap it, by overlap
        (``untraced`` for the part no span covers), in seconds summed over
        the cards, largest first."""
        spans = sorted(spans)
        tot: dict[str, float] = {}
        for sp in self._each():
            j = 0
            for g0, g1 in gaps(sp):
                while j < len(spans) and spans[j][1] <= g0:
                    j += 1
                covered, k = 0.0, j
                while k < len(spans) and spans[k][0] < g1:
                    part = min(g1, spans[k][1]) - max(g0, spans[k][0])
                    if part > 0:
                        tot[spans[k][2]] = tot.get(spans[k][2], 0.0) + part
                        covered += part
                    k += 1
                if g1 - g0 > covered:
                    tot["untraced"] = tot.get("untraced", 0.0) + (
                        g1 - g0 - covered)
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]
