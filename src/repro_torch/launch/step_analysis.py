"""Per-device costs of one step, counted on the host while it runs.

The port's counterpart of ``src/repro/launch/hlo_analysis.py``, which
parses XLA's partitioned HLO for each device's FLOPs, HBM bytes and
collective bytes.  The port has no HLO: it runs eager, each aten op and
each custom op (the flash kernels') one kernel, nothing fused, so a step
costs what its ops cost, and ``StepCounter`` counts them as they run, on
the card's tensors or on ``meta`` tensors that hold shapes and no data
(``launch/dryrun.py``).  While it is open it counts:

- ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s, the matrix
  products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, SDPA)
  by aten's formulas and the flash custom ops by theirs
  (``kernels/flash_attention.flash_fwd_flops`` / ``flash_bwd_flops``, the
  kernel table's operation counts).  Elementwise work is not counted, as
  the reference's ``program_costs`` counts dots only.  A step under
  ``torch.utils.checkpoint`` counts its recomputed forward.
- ``bytes``: what an eager, unfused step moves through HBM: each op reads
  its operands and writes its results there, so every op adds its
  operand and result bytes, but a view (it moves nothing) and a
  collective (``collective_bytes``).  A gather is charged twice its
  result and an in-place scatter twice its source (the rows they touch),
  as the reference charges ``gather`` and ``dynamic-update-slice``.
  ``rows`` keeps those bytes per ``(op name, operand shapes)`` (their sum
  is ``bytes``) and ``row_calls`` the calls of each: what
  ``launch/perf_probe.py`` ranks.
- ``collective_bytes``: the per-kind bytes of ``distributed.collectives
  .Tally`` (the reference's ring model).
- memory: each storage an op allocates (an op whose results alias none of
  its inputs) counts from its allocation until it is freed (a
  ``weakref.finalize`` on the untyped storage); ``peak`` is the most
  counted at once.  ``memory(arguments, outputs)`` gives the reference's
  ``argument_bytes``, ``output_bytes`` (the outputs' storages allocated
  in the step) and ``temp_bytes`` (the rest of the peak).
"""
from __future__ import annotations

import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.distributed import collectives as col

__all__ = ["StepCounter", "tensor_bytes", "held_bytes"]

_aten = torch.ops.aten
# ops that read only the rows they return: charged 2 x their result
_GATHERS = {_aten.index.Tensor, _aten.index_select.default,
            _aten.gather.default, _aten.embedding.default}
# in-place scatters: charged 2 x the rows they write, their source (the
# argument at this position)
_SCATTERS = {_aten.index_put_.default: 2, _aten._index_put_impl_.default: 2,
             _aten.index_add_.default: 3, _aten.index_copy_.default: 3,
             _aten.scatter_.src: 3, _aten.scatter_add_.default: 3}


def _bmm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """aten's ``bmm`` count, 2·b·m·n·k, taking ``bmm.dtype``'s
    ``out_dtype`` argument too (``layers._mm32``'s fp32-out products),
    which aten's own formula takes for ``out_shape``."""
    b, m, k = a_shape
    return 2 * b * m * b_shape[2] * k


def _local(t):
    return t._local_tensor if col.is_dtensor(t) else t


def tensor_bytes(t) -> int:
    """The bytes of ``t``'s elements (a ``DTensor``'s local block)."""
    t = _local(t)
    return t.numel() * t.element_size()


def held_bytes(tree) -> int:
    """The bytes of the tensors of ``tree`` (nested dicts, lists, tuples,
    ``QTensor``s; a ``DTensor`` by its local block, a view by its own
    elements), each tensor counted once: what a rank holds of them."""
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if torch.is_tensor(t) and id(t) not in seen:
            seen.add(id(t))
            total += tensor_bytes(t)
    return total


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if torch.is_tensor(t)]


class _Ops(TorchDispatchMode):
    """The dispatch mode under ``StepCounter``: bytes, calls and the
    storages ops allocate."""

    def __init__(self, counter: "StepCounter"):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        c = self.counter
        c.calls[func.name()] += 1
        if func.namespace == "c10d":
            return out
        outs = _tensors(out)
        aliased = any(r.alias_info is not None
                      for r in func._schema.returns)
        nbytes = 0
        if func in _GATHERS:
            nbytes = 2 * sum(map(tensor_bytes, outs))
        elif func in _SCATTERS:
            nbytes = 2 * tensor_bytes(args[_SCATTERS[func]])
        elif not func.is_view:
            nbytes = sum(map(tensor_bytes, _tensors((args, kwargs))))
            nbytes += sum(map(tensor_bytes, outs))
        if nbytes:
            c.bytes += nbytes
            key = (func.name(), tuple(tuple(_local(t).shape)
                                      for t in _tensors((args, kwargs))))
            c.rows[key] += nbytes
            c.row_calls[key] += 1
        if not aliased:
            for t in outs:
                c._allocated(t)
        return out


class StepCounter:
    """Count one step's FLOPs, HBM bytes, collective bytes and memory
    (module docstring): ``with StepCounter() as sc: step(...)``, then
    ``sc.flops``, ``sc.bytes``, ``sc.collective_bytes()``, ``sc.peak``,
    ``sc.calls`` (aten and custom op calls by name), ``sc.rows`` and
    ``sc.row_calls`` (bytes and calls per ``(op name, operand shapes)``;
    ``sc.top_rows(n)``) and ``sc.memory(arguments, outputs)``."""

    def __init__(self):
        self.bytes = 0
        self.calls: Counter = Counter()
        self.rows: Counter = Counter()
        self.row_calls: Counter = Counter()
        self.live = self.peak = 0
        self._held: dict[int, int] = {}
        self._flops = FlopCounterMode(
            display=False, custom_mapping={_aten.bmm: _bmm_flops})
        self._ops = _Ops(self)
        self._tally = None
        self._tallied = None

    def _allocated(self, t) -> None:
        st = _local(t).untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._freed, key)

    def _freed(self, key) -> None:
        self.live -= self._held.pop(key, 0)

    def __enter__(self) -> "StepCounter":
        self._tallied = col.tallied()
        self._tally = self._tallied.__enter__()
        self._flops.__enter__()
        self._ops.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._ops.__exit__(*exc)
        self._flops.__exit__(*exc)
        self._tallied.__exit__(*exc)

    @property
    def flops(self) -> int:
        return int(self._flops.get_total_flops())

    def flops_by_op(self) -> dict:
        return {str(k): int(v) for k, v in
                self._flops.get_flop_counts().get("Global", {}).items()}

    def top_rows(self, n: int | None = None) -> list:
        """``(bytes, calls, op name, operand shapes)`` of the ``n`` rows
        that moved the most bytes (all of them with ``n`` None), most
        first."""
        rows = sorted(((b, self.row_calls[k], *k)
                       for k, b in self.rows.items()),
                      key=lambda r: (-r[0], r[2], r[3]))
        return rows if n is None else rows[:n]

    def collective_bytes(self) -> dict:
        return self._tally.per_device()

    def memory(self, arguments, outputs) -> dict:
        """The reference's memory record: ``argument_bytes`` (what the
        rank holds of ``arguments``), ``output_bytes`` (the storages of
        ``outputs`` allocated in the step and still held), ``temp_bytes``
        (the rest of the step's peak), and ``peak_bytes`` (arguments plus
        the step's peak)."""
        args = held_bytes(arguments)
        seen, out_b = set(), 0
        for t in _tensors(outputs):
            key = id(_local(t).untyped_storage())
            if key in self._held and key not in seen:
                seen.add(key)
                out_b += self._held[key]
        return {"argument_bytes": args, "output_bytes": out_b,
                "temp_bytes": max(0, self.peak - out_b),
                "generated_code_bytes": 0, "peak_bytes": args + self.peak}
