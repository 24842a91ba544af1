"""Device-resident weight planning — the paper's on-chip parameter story.

Port of ``src/repro/core/runtime/residency.py``.  GCV-Turbo keeps model
parameters resident in on-chip buffers so execution is pure data movement
(§VII-D2).  ``collect_params`` walks an ``ExecutionPlan`` once at
runner-build time and uploads every live compile-time array (weights, ELL
structures, COO triples) to the device exactly once, **deduplicated by
array identity and then by content**: a shared adjacency referenced by five
message-passing ops is one buffer, and Step 4's per-op ELL copies of one
structure fold into one.  Handlers read the store through ``weight`` /
``opt_weight`` / ``ell_pair`` / ``row_order``.  ELL ``idx`` stays int32.

Every runner reads the store by address, eager or as a CUDA graph, so a
``swap`` writes the new value into the existing buffer (``copy_``: same
shape and dtype) and a captured graph reads it at its next replay without
a re-capture — the counterpart of the reference's zero-retrace swap.
Un-aliasing a content-folded slot needs a buffer of its own, so it bumps
``version``; runners compare it on every call and re-capture once.  The
reference's trace-constants mode (weights baked into a jitted program) has
no counterpart: ``trace_constants`` stays ``False``.

COO reductions (``segment_sum`` in ``elementwise.py``) read a **row
order** the store derives once at upload: the permutation that sorts the
edges stably by row, and each row's length.  A segmented reduce over the
sorted edges adds each row in a fixed order, the same on every run, where
``index_add_``'s atomics added in a different order every run on the
card.  Row orders live in ``derived``, beside ``arrays``: they are not plan
arrays, and ``nbytes()`` counts what the reference's store counts.

Over a device mesh (``collect_params(plan, device, mesh=)``, the
batch-sharded path) the store keeps one full copy per mesh entry, the
reference's replicated ``NamedSharding(mesh, P())``: each replica its own
buffers on its own device, folded the same way.  ``replicas`` counts them,
``nbytes()`` is their total and ``swap`` writes every replica.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.plan import ELL_KERNELS, ExecutionPlan, MatOp

# Slot names for the two halves of an op's ELL structure (``op.ell`` is a
# positional (idx, val) pair, unlike the keyed ``op.weights``).
ELL_IDX, ELL_VAL = "ell_idx", "ell_val"


def _content_key(arr: np.ndarray) -> tuple:
    """Value-equality key for equal-shaped arrays: shape + dtype + a digest
    of the raw bytes.  Step-4 ELL conversions materialize per-op copies of
    the same structure that identity dedup cannot catch; two arrays with
    the same key fold into one resident buffer."""
    digest = hashlib.blake2b(np.ascontiguousarray(arr).tobytes(),
                             digest_size=16).digest()
    return (arr.shape, arr.dtype.str, digest)


def op_param_slots(op: MatOp):
    """Yield ``(slot, host_array)`` for the op's *live* compile-time
    arrays: an ELL-family kernel executes from (idx, val), so the dense
    'adj'/'w' it was built from is dead; any other kernel executes from the
    dense operand, so the ELL halves are dead instead."""
    ell_live = op.ell is not None and op.kernel in ELL_KERNELS
    dead = {"adj", "w"} if ell_live else set()
    for name, value in op.weights.items():
        if value is not None and name not in dead:
            yield name, value
    if ell_live:
        yield ELL_IDX, op.ell[0]
        yield ELL_VAL, op.ell[1]


def row_order_slots(op: MatOp):
    """Yield ``(slot, n)`` for the op's segment-id arrays that a COO sum
    reduces over: a ``left_coo`` sum's ``coo_rows`` and a segment softmax's
    ``segments`` (``n`` segments each)."""
    if op.kind == "mm" and op.attrs.get("weight_side") == "left_coo" \
            and op.attrs.get("reduce", "sum") != "max":
        yield "coo_rows", op.attrs["n"]
    elif op.kind == "ew" and op.attrs.get("fn") == "segment_softmax":
        yield "segments", op.attrs["num_segments"]


def plan_slots(plan: ExecutionPlan) -> set[tuple[str, str]]:
    """Every ``(op_name, slot)`` a collected store would hold — cheap
    (no hashing, no uploads); the validation surface for hot swaps."""
    return {(op.name, slot) for op in plan.ops
            for slot, _ in op_param_slots(op)}


def host_row_order(seg: np.ndarray, n: int) -> tuple[np.ndarray,
                                                    np.ndarray]:
    """-> ``(perm, lengths)``, int64: ``perm`` sorts the edges stably by
    segment id (each row's edges stay in edge order), ``lengths[r]`` is
    how many edges row ``r`` of ``n`` has."""
    seg = np.asarray(seg).astype(np.int64).reshape(-1)
    return (np.argsort(seg, kind="stable"),
            np.bincount(seg, minlength=n)[:n].astype(np.int64))


def _to_tensor(value, device=None) -> torch.Tensor:
    return torch.tensor(np.asarray(value), device=device)


@dataclasses.dataclass
class ResidentParams:
    """A plan's compile-time arrays, resident on ``device``.

    ``arrays``   ref -> tensor (deduplicated storage).
    ``slots``    (op.name, slot) -> ref.
    ``origins``  (op.name, slot) -> opaque label of the host array the slot
                 came from.  Slots with one label are identity-shared (the
                 model author reused one array — swapping one swaps all);
                 slots with different labels on one ref were folded by
                 content, and ``swap`` un-aliases them first.
    ``derived``  (ref, n) -> the row order ``(perm, lengths)`` of a
                 segment-id array (``host_row_order``), for the COO sums.
    ``version``  bumped whenever a slot moves to another buffer; a runner
                 whose CUDA graphs read the old addresses re-captures.
    ``mirrors``  the other mesh entries' replicas of a store collected over
                 a mesh (each a ``ResidentParams`` on its entry's device,
                 with the same slots); empty for one device.
    """

    arrays: dict[str, torch.Tensor]
    slots: dict[tuple[str, str], str]
    device: torch.device
    value_dedup_bytes: int = 0
    origins: dict[tuple[str, str], int] | None = None
    derived: dict[tuple[str, int], tuple] = dataclasses.field(
        default_factory=dict)
    version: int = 0
    # No runner bakes weights into a program (see the module docstring).
    trace_constants: bool = False
    mirrors: list = dataclasses.field(default_factory=list)

    @property
    def replicas(self) -> int:
        """How many devices hold a full copy (the mesh size, or 1)."""
        return 1 + len(self.mirrors)

    def stores(self) -> list["ResidentParams"]:
        """Every replica, this one (the mesh's first entry) first."""
        return [self, *self.mirrors]

    def has(self, op: MatOp, slot: str) -> bool:
        return (op.name, slot) in self.slots

    def get(self, op: MatOp, slot: str) -> torch.Tensor:
        return self.arrays[self.slots[(op.name, slot)]]

    def row_order(self, op: MatOp, slot: str, n: int) -> tuple:
        return self.derived[(self.slots[(op.name, slot)], n)]

    def nbytes(self) -> int:
        """Resident bytes over every replica."""
        return sum(t.numel() * t.element_size()
                   for r in self.stores() for t in r.arrays.values())

    def swap(self, op_name: str, slot: str, value) -> None:
        """Replace one weight in every replica (``_swap_one``)."""
        for r in self.stores():
            r._swap_one(op_name, slot, value)

    def _swap_one(self, op_name: str, slot: str, value) -> None:
        """Replace one weight.  The common case writes into the existing
        buffer, so every runner — a captured graph included — reads the new
        value at its next call, with no re-capture.

        Identity-shared slots share the buffer and all follow the swap.
        Slots folded by *content* dedup (incidentally byte-equal at compile
        time) are un-aliased first: the swapped slot's identity group moves
        to a new buffer and every other group keeps the old one.  That
        changes an address, so ``version`` goes up and graph runners
        re-capture once.  A segment-id array's row order is derived again,
        into its buffers (its shapes follow the array's)."""
        key = (op_name, slot)
        ref = self.slots[key]
        old = self.arrays[ref]
        new = (value if isinstance(value, torch.Tensor)
               else torch.as_tensor(np.asarray(value))).to(old.dtype)
        assert tuple(new.shape) == tuple(old.shape), \
            f"swap {op_name!r}/{slot!r}: shape {tuple(new.shape)} != " \
            f"{tuple(old.shape)}"
        group = self.origins.get(key) if self.origins else None
        sharers = [k for k, r in self.slots.items() if r == ref]
        foreign = group is not None and any(
            self.origins.get(k) != group for k in sharers)
        orders = {n: host_row_order(new.cpu().numpy(), n)
                  for r, n in self.derived if r == ref}
        if foreign:
            split = f"{ref}s{len(self.arrays)}"
            self.arrays[split] = new.to(self.device, copy=True)
            for k in sharers:
                if self.origins.get(k) == group:
                    self.slots[k] = split
            for n, order in orders.items():
                self.derived[(split, n)] = tuple(_to_tensor(a, self.device)
                                                 for a in order)
            self.version += 1
            return
        with torch.inference_mode():
            old.copy_(new)
            for n, order in orders.items():
                for buf, a in zip(self.derived[(ref, n)], order):
                    buf.copy_(torch.from_numpy(a))


def collect_params(plan: ExecutionPlan, device, mesh=None) -> ResidentParams:
    """One pass over the plan: upload every live compile-time array once.

    Dedup is two-level, as the reference's: first by host-array identity
    (``id``) — ``GraphBuilder`` and the passes share ndarrays when layers
    share structure — then by *content*: equal-shaped arrays with
    identical bytes fold into one buffer even when they are distinct host
    objects (Step 4's per-op ELL pairs, repeated zero biases).  The folded
    bytes are reported in ``value_dedup_bytes``.  The fold is a storage
    optimization, never a semantic merge: ``swap`` un-aliases first.

    ``mesh`` (a 1-D data mesh) uploads one replica per entry, the first on
    ``device`` (the mesh's first entry) and the others in ``mirrors``:
    one upload per device, so each replica's runner reads its weights
    where it runs.  Two entries naming one device get two copies."""
    device = torch.device(device)
    with obs.span("residency.upload", cat="runtime", plan=plan.name,
                  device=str(device),
                  devices=(mesh.size if mesh is not None else 1)) as sp:
        res = _collect_params(plan, device)
        if mesh is not None:
            res.mirrors = [_replica(res, torch.device(d))
                           for d in list(mesh.devices.flat)[1:]]
        sp.set(bytes=res.nbytes(), slots=len(res.slots),
               value_dedup_bytes=res.value_dedup_bytes)
        return res


def _replica(res: ResidentParams, device: torch.device) -> ResidentParams:
    """A copy of ``res``'s buffers on ``device`` (new buffers even on
    ``res``'s own device), with its slot map."""
    def copy(t: torch.Tensor) -> torch.Tensor:
        return t.to(device, copy=True)
    return ResidentParams(
        {ref: copy(t) for ref, t in res.arrays.items()}, dict(res.slots),
        device, value_dedup_bytes=res.value_dedup_bytes,
        origins=dict(res.origins or {}),
        derived={k: tuple(copy(t) for t in v)
                 for k, v in res.derived.items()})


def _collect_params(plan: ExecutionPlan, device) -> ResidentParams:
    arrays: dict[str, torch.Tensor] = {}
    slots: dict[tuple[str, str], str] = {}
    origins: dict[tuple[str, str], int] = {}
    host: dict[str, np.ndarray] = {}
    by_id: dict[int, str] = {}
    by_content: dict[tuple, str] = {}
    folded = 0

    def ref_for(host_array) -> str:
        nonlocal folded
        key = id(host_array)
        if key not in by_id:
            arr = np.asarray(host_array)
            ckey = _content_key(arr)
            ref = by_content.get(ckey)
            if ref is not None:
                folded += arr.nbytes
            else:
                ref = f"p{len(arrays)}"
                by_content[ckey] = ref
                arrays[ref] = _to_tensor(arr, device)
                host[ref] = arr
            by_id[key] = ref
        return by_id[key]

    for op in plan.ops:
        for name, value in op_param_slots(op):
            slots[(op.name, name)] = ref_for(value)
            origins[(op.name, name)] = id(value)
    derived = {}
    for op in plan.ops:
        for name, n in row_order_slots(op):
            ref = slots[(op.name, name)]
            if (ref, n) not in derived:
                derived[(ref, n)] = tuple(_to_tensor(a, device) for a in
                                          host_row_order(host[ref], n))
    return ResidentParams(arrays, slots, device, value_dedup_bytes=folded,
                          origins=origins, derived=derived)


def plan_param_bytes(plan: ExecutionPlan) -> int:
    """Deduplicated parameter footprint of a plan, without uploading —
    mirrors ``collect_params``'s two-level (identity, then content) dedup
    so the model matches what the store would hold."""
    seen_ids: set[int] = set()
    seen_content: dict[tuple, int] = {}
    for op in plan.ops:
        for _, v in op_param_slots(op):
            if id(v) in seen_ids:
                continue
            seen_ids.add(id(v))
            arr = np.asarray(v)
            seen_content.setdefault(_content_key(arr), arr.nbytes)
    return int(sum(seen_content.values()))


# ---------------------------------------------------------- handler seam --
def weight(op: MatOp, key: str, params: ResidentParams | None):
    """A required compile-time array: resident when params are bound, else
    staged per call on the CPU (direct ``run_op`` use)."""
    if params is not None:
        return params.get(op, key)
    return _to_tensor(op.weights[key])


def opt_weight(op: MatOp, key: str, params: ResidentParams | None):
    """An optional compile-time array, or None if the op doesn't carry it."""
    if op.weights.get(key) is None:
        return None
    return weight(op, key, params)


def ell_pair(op: MatOp, params: ResidentParams | None):
    """The op's (idx, val) ELL structure."""
    if params is not None:
        return params.get(op, ELL_IDX), params.get(op, ELL_VAL)
    return tuple(_to_tensor(a) for a in op.ell)


def row_order(op: MatOp, key: str, n: int, params: ResidentParams | None):
    """The row order ``(perm, lengths)`` (``host_row_order``) of the op's
    segment-id array ``key`` over ``n`` segments: derived at upload when
    params are bound, else per call on the CPU."""
    if params is not None:
        return params.row_order(op, key, n)
    return tuple(_to_tensor(a) for a in host_row_order(op.weights[key], n))
