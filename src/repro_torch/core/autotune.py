"""Measured kernel autotuning — the optional refinement of Step 4b.

Port of ``src/repro/core/autotune.py``.  The analytic
``perf_model.predict_kernel_seconds`` is a fitted model: it ranks
realizations correctly in the regimes it was fitted on, but the real
crossover between (say) cuBLAS and the DDMM kernel depends on details no
closed form captures.  ``kernels="measured"`` times each candidate
realization once per unique

    (kind, shapes, dtype, nnz-bucket, backend)

signature — actual op arrays where they exist (conv weights, ELL
structures, masks), deterministic random activations otherwise — and binds
the winner.  Results persist in an on-disk JSON cache
(``REPRO_AUTOTUNE_CACHE`` env var or ``.autotune_cache.json`` in the cwd)
so repeated compiles never re-measure: a warm cache makes the measured mode
as cheap as the predicted one.

nnz is bucketed to the nearest power of two: two adjacencies with 1000 vs
1100 edges share one measurement — the micro-benchmark characterizes a
*regime*, not an exact matrix.

On the card each candidate is timed by CUDA events around a loop of calls
after a warm-up (a launch-bound call's time is its host time, which one
call cannot show), the candidates in turns, best of several loops (the
host's jitter only ever adds time); on the CPU by the host clock, best of
``repeats``.  Off the card a ``cuda_*`` candidate cannot run (its wrapper
would run the plain version), so it is not measured: ``measure_op`` leaves
it out and the selector binds the twin with the reason recorded.

Selection stays compile-time-only (FlowGNN discussion, paper §VII-D2): the
measurements happen during compilation, never during serving.
"""
from __future__ import annotations

import gc
import json
import math
import os
import pathlib
import tempfile
import time

import numpy as np

DEFAULT_CACHE = ".autotune_cache.json"
_VERSION = 1
# CUDA-event timing: calls before the timed loops, calls in one loop, and
# the least number of loops per candidate (the best one counts).
WARMUP_CALLS = 3
TIMED_CALLS = 20
CARD_ROUNDS = 7


def _nnz_bucket(nnz: int | None) -> str:
    if nnz is None or nnz <= 0:
        return "none"
    return f"2^{max(0, math.ceil(math.log2(nnz)))}"


def op_signature(op, backend: str) -> str:
    """Measurement identity of one MatOp: everything that changes which
    realization wins, nothing that doesn't (weights' values don't)."""
    a = op.attrs
    dims = "x".join(str(a.get(k, 0)) for k in ("s1", "s2", "s3"))
    if op.kind == "conv":
        w = op.weights["w"]
        dims = "x".join(str(d) for d in (*w.shape, *op.out_shape))
        dims += f"|st{a.get('stride')}|{a.get('padding')}"
        groups = a.get("groups", 1)
        dil = a.get("dilation", (1, 1))
        dil = (dil, dil) if isinstance(dil, int) else tuple(dil)
        if groups != 1 or dil != (1, 1):
            dims += f"|g{groups}|d{dil[0]}x{dil[1]}"
    facet = a.get("weight_side", a.get("exec", ""))
    ell_l = op.ell[0].shape[1] if op.ell is not None else 0
    return "|".join([op.kind, str(facet), dims, f"L{ell_l}",
                     _nnz_bucket(a.get("nnz")), backend, "f32"])


class AutotuneCache:
    """On-disk ``signature -> {kernel: seconds}`` store.

    ``measured_now`` counts signatures measured by *this* process — a warm
    cache round-trips with it at zero.

    Writes are concurrency-safe: ``save`` re-reads the file, merges disk
    entries under this process's (per signature, this process's kernel
    timings win, foreign signatures are kept), and publishes via tempfile
    + ``os.replace`` — atomic on POSIX, so a reader never sees a torn JSON
    and two writers lose nothing but a re-measurement.
    """

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = pathlib.Path(
            path or os.environ.get("REPRO_AUTOTUNE_CACHE", DEFAULT_CACHE))
        self.entries: dict[str, dict[str, float]] = {}
        self.dirty = False
        self.measured_now = 0
        self.hits = 0
        blob = self._read()
        if blob.get("version") == _VERSION:
            self.entries = blob.get("entries", {})

    def _read(self) -> dict:
        if not self.path.exists():
            return {}
        try:
            blob = json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError):
            return {}                  # torn/corrupt file: start cold
        return blob if isinstance(blob, dict) else {}

    def lookup(self, sig: str) -> dict[str, float] | None:
        return self.entries.get(sig)

    def store(self, sig: str, timings: dict[str, float]) -> None:
        self.entries[sig] = {k: float(v) for k, v in timings.items()}
        self.dirty = True

    def save(self) -> None:
        if not self.dirty:
            return
        blob = self._read()
        if blob.get("version") == _VERSION:
            # merge-on-save: keep signatures another writer added; on
            # shared signatures our timings win per kernel
            for sig, timings in blob.get("entries", {}).items():
                mine = self.entries.get(sig)
                self.entries[sig] = dict(timings) if mine is None \
                    else {**timings, **mine}
        payload = json.dumps({"version": _VERSION, "entries": self.entries},
                             indent=1, sort_keys=True)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = None
        try:
            fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                       prefix=self.path.name + ".",
                                       suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            os.replace(tmp, self.path)    # atomic publish
            tmp = None
        finally:
            if tmp is not None and os.path.exists(tmp):
                os.unlink(tmp)
        self.dirty = False


# ------------------------------------------------------------ measurement --
def _time_calls(calls: dict, repeats: int, device) -> dict[str, float]:
    """Seconds per call of each ``name -> (fn, args)``, timed in turns
    (the order reversed every round, so drift hits every candidate alike),
    best of the rounds.  On the card a round is CUDA events around
    ``TIMED_CALLS`` calls after ``WARMUP_CALLS``, and there are at least
    ``CARD_ROUNDS``; on the CPU a round is one host-clock call after one
    warm-up call, and there are ``repeats``.  The garbage collector is off
    while timing, as ``timeit`` keeps it: a collection's pause would land
    on whichever candidate happened to allocate."""
    cuda = device.type == "cuda"
    for fn, args in calls.values():
        for _ in range(WARMUP_CALLS if cuda else 1):
            fn(*args)
    names = list(calls)
    best = dict.fromkeys(names, float("inf"))
    collecting = gc.isenabled()
    gc.disable()
    try:
        for r in range(max(repeats, CARD_ROUNDS) if cuda else repeats):
            for name in (names if r % 2 == 0 else names[::-1]):
                best[name] = min(best[name],
                                 _one_round(*calls[name], device))
    finally:
        if collecting:
            gc.enable()
    return best


def _one_round(fn, args, device) -> float:
    """Seconds per call over one round (``_time_calls``)."""
    import torch
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_CALLS):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3 / TIMED_CALLS


def _realization(op, kernel: str, rng, device):
    """(fn, args) micro-benchmark for one candidate: the call the runtime
    makes for ``op`` under ``kernel`` (``core/runtime``), on random
    activations of the op's shapes; None when the kernel has no standalone
    measurable form (single-candidate families are never measured)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.ddmm import ddmm
    from repro_torch.kernels.knn import knn
    from repro_torch.kernels.sddmm import sddmm
    from repro_torch.kernels.shift_conv import shift_conv2d
    from repro_torch.kernels.spdmm import spdmm, spdmm_rows

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def rand(*shape):
        return t(rng.standard_normal(shape))

    a = op.attrs
    cuda = kernel.startswith("cuda_")
    if op.kind == "conv":
        k1, k2, cin_g, cout = op.weights["w"].shape
        groups = a.get("groups", 1)
        dil = a.get("dilation", (1, 1))
        dil = (dil, dil) if isinstance(dil, int) else tuple(dil)
        ke1, ke2 = (k1 - 1) * dil[0] + 1, (k2 - 1) * dil[1] + 1
        ho, wo = op.out_shape[-2:]
        st = a["stride"]
        sh, sw = (st, st) if isinstance(st, int) else st
        if a["padding"] == "SAME":
            h, w = ho * sh, wo * sw
        else:
            h, w = (ho - 1) * sh + ke1, (wo - 1) * sw + ke2
        x = rand(*op.out_shape[:-3], cin_g * groups, h, w)
        conv = shift_conv2d if cuda else ref.conv2d_ref
        return (lambda xi, wi: conv(xi, wi, stride=st, padding=a["padding"],
                                    groups=groups, dilation=dil),
                (x, t(op.weights["w"])))
    s1, s2, s3 = a.get("s1", 1), a.get("s2", 1), a.get("s3", 1)
    side = a.get("weight_side")
    if kernel in ("torch_ell_spdmm", "cuda_ell_spdmm"):
        idx = t(op.ell[0], torch.int32)
        val = t(op.ell[1])
        if side in ("right", "right_t"):      # rows layout, (s1, s2) in
            x2 = rand(s1, s2)
            fn = spdmm_rows if cuda else ref.spdmm_rows_ref
            return fn, (idx, val, x2)
        fn = spdmm if cuda else ref.spdmm_ref
        return fn, (idx, val, rand(s2, s3))
    if kernel in ("torch_knn", "cuda_knn"):
        kk = int(a.get("k", 1))
        sl = bool(a.get("self_loops", False))
        fn = knn if cuda else ref.knn_ref
        return (lambda xi: fn(xi, kk, self_loops=sl), (rand(s1, s2),))
    if kernel in ("torch_dense", "cuda_ddmm"):
        x, y = rand(s1, s2), rand(s2, s3)
        return (ddmm if cuda else torch.matmul), (x, y)
    if kernel in ("torch_sddmm", "cuda_sddmm"):
        x = rand(s1, s2)
        mask = op.weights.get("mask")
        if mask is None:                      # the runtime's x @ xᵀ
            return (lambda xi: ddmm(xi, xi.T) if cuda else xi @ xi.T,
                    (x,))
        fn = sddmm if cuda else ref.sddmm_ref
        return (lambda xi, m: fn(xi, xi.T, m), (x, t(mask)))
    return None


def measure_op(op, candidates: list[str], cache: AutotuneCache, *,
               backend: str, repeats: int = 2) -> dict[str, float]:
    """Seconds per call of each candidate, through the cache.  ``backend``
    is where the plan runs (``"cuda"`` or ``"cpu"``); off the card ``cuda_*``
    candidates are left out (module docstring)."""
    import torch
    runnable = [k for k in candidates
                if backend == "cuda" or not k.startswith("cuda_")]
    sig = op_signature(op, backend)
    hit = cache.lookup(sig)
    if hit is not None and all(k in hit for k in runnable):
        cache.hits += 1
        return {k: hit[k] for k in runnable}
    timings = dict(hit or {})
    rng = np.random.default_rng(0)
    device = torch.device(backend)
    with torch.inference_mode():
        calls = {}
        for kernel in runnable:
            if kernel not in timings:
                real = _realization(op, kernel, rng, device)
                if real is not None:
                    calls[kernel] = real
        timings.update(_time_calls(calls, repeats, device))
    cache.store(sig, timings)
    cache.measured_now += 1
    return {k: v for k, v in timings.items() if k in runnable}
