"""Mesh builders.  Port of ``src/repro/launch/mesh.py``.

A ``Mesh`` here is what ``jax.sharding.Mesh`` is there: a numpy grid of
devices (``torch.device``s) with one name per axis.  The functions build
meshes; nothing here touches a device at import.

Every builder degrades gracefully when the host has fewer devices than the
requested shape: the largest fitting mesh is built instead (later axes —
the model/TP axes — keep their extent first, since those shard actual
tensors; leading DP axes give way), a ``UserWarning`` names the
substitution, and with tracing on an ``obs.instant("mesh.degraded")``
marker records it in the timeline.  The devices a host has are its cards
(``torch.cuda.device_count()``); a host with none has one, the CPU.

An explicit device sequence may name one device more than once: each entry
is then a replica of its own, with its own weights, CUDA graphs and
stream.  That is how one host stands in for several devices, as the
reference forces host devices (``--xla_force_host_platform_device_count``):
the CPU tests serve over ``["cpu"] * n``, and the card check over
``[cuda:0, cuda:0]`` on a one-card host.

The batch-sharded GNN-CV path (``gcv.compile(devices=)`` /
``gcv.serve(devices=)``) runs over a 1-D ``("data",)`` mesh in one
process.  The LM's sharded paths run one process (rank) per mesh entry:
``init_process_group`` joins a rank to its group (NCCL on cuda, gloo on
the CPU; a rank's card is made current first), and ``make_process_mesh``
binds a ``Mesh`` to a ``torch.distributed.device_mesh.DeviceMesh`` with
the same axis names, degrading as the builders above do when the group
has fewer ranks than the shape asks.  Spawning the ranks is the caller's
job (the reference is one controller and has no launcher to port); the
tests and ``chip_smoke.py`` use ``tools/ranks.py``.  The dry run
(``launch/dryrun.py``) is rank 0 of a ``fake`` group (``init_fake_group``),
whose mesh holds ``meta`` devices.
"""
from __future__ import annotations

import datetime
import warnings

import numpy as np
import torch

from repro_torch import obs


class Mesh:
    """A grid of devices with named axes: the port's ``jax.sharding.Mesh``.

    ``devices`` is the numpy grid (dtype object) of ``torch.device``s,
    ``axis_names`` one name per grid axis, ``shape`` the ordered map axis
    -> size, ``size`` the number of entries.  Two meshes are equal when
    their grids and axis names are, so equal meshes share a runner-cache
    entry (``core.runtime.cache``).

    A mesh from ``make_process_mesh`` is also bound to a ``DeviceMesh``
    (``device_mesh``): entry ``i`` (row-major) is rank ``i``, and
    ``group``, ``axis_index`` and ``axis_ranks`` name this rank's process
    groups and place along each axis.  Other meshes have none."""

    def __init__(self, devices, axis_names, *, device_mesh=None):
        src = np.asarray(devices, dtype=object)
        grid = np.empty(src.shape, dtype=object)
        for i, d in np.ndenumerate(src):
            grid[i] = torch.device(d)
        self.devices = grid
        self.axis_names = tuple(axis_names)
        assert grid.ndim == len(self.axis_names), \
            f"a {grid.ndim}-D device grid needs {grid.ndim} axis names, " \
            f"got {self.axis_names}"
        self.device_mesh = device_mesh

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _bound(self):
        if self.device_mesh is None:
            raise ValueError(
                "this mesh is not bound to torch.distributed: build it with "
                "launch.mesh.make_process_mesh on every rank")
        return self.device_mesh

    @property
    def rank(self) -> int:
        """This process's rank: its entry in the row-major grid."""
        return int(self._bound().get_rank())

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices.flat[self.rank]

    def group(self, axis: str):
        """The process group of the ranks that share this rank's place on
        every axis but ``axis``."""
        return self._bound().get_group(axis)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return int(np.unravel_index(self.rank, self.devices.shape)[
            self.axis_names.index(axis)])

    def axis_ranks(self, axis: str) -> list[int]:
        """The global ranks along ``axis`` through this rank, in order."""
        where = list(np.unravel_index(self.rank, self.devices.shape))
        k = self.axis_names.index(axis)
        out = []
        for i in range(self.devices.shape[k]):
            where[k] = i
            out.append(int(np.ravel_multi_index(where, self.devices.shape)))
        return out

    def _key(self) -> tuple:
        return (self.devices.shape, self.axis_names,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices.flat]}, "
                f"shape={self.shape})")


def available_devices() -> list[torch.device]:
    """The devices a mesh may take without naming them: every card, or
    the CPU alone on a host with none."""
    n = torch.cuda.device_count()
    if n == 0:
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(n)]


def fit_shape(shape, available: int) -> tuple:
    """Largest mesh shape elementwise <= ``shape`` whose product fits in
    ``available`` devices.  Later axes are satisfied first (innermost =
    model/TP, where extent matters most); each axis takes what it can and
    leaves the integer remainder for the axes before it."""
    assert available >= 1, f"need at least one device, got {available}"
    out = []
    remaining = available
    for size in reversed(tuple(shape)):
        take = min(int(size), remaining)
        out.append(take)
        remaining //= take
    return tuple(reversed(out))


def _build(shape, axes, *, requested=None) -> Mesh:
    """Mesh over the first ``prod(shape)`` devices, degrading to the
    largest fitting shape when fewer exist."""
    devices = available_devices()
    want = tuple(int(s) for s in shape)
    n = int(np.prod(want))
    if n > len(devices):
        got = fit_shape(want, len(devices))
        warnings.warn(
            f"mesh shape {want} needs {n} devices but only "
            f"{len(devices)} exist; degrading to {got} "
            f"(axes {tuple(axes)})", UserWarning, stacklevel=3)
        obs.instant("mesh.degraded", cat="launch",
                    requested=list(requested if requested is not None
                                   else want),
                    got=list(got), devices=len(devices))
        want, n = got, int(np.prod(got))
    return Mesh(np.asarray(devices[:n], dtype=object).reshape(want),
                tuple(axes))


def production_shape(*, multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axis names) of the reference's production mesh: (16, 16)
    ``("data", "model")``, one pod of 256, or (2, 16, 16) with a leading
    ``"pod"`` axis."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes (``production_shape``), degraded
    to the devices the host has."""
    return _build(*production_shape(multi_pod=multi_pod))


def make_host_mesh(shape=(2, 4), axes=("data", "model")) -> Mesh:
    """Small mesh over whatever devices the host has."""
    return _build(shape, axes)


def make_data_mesh(devices=None) -> Mesh:
    """1-D ``("data",)`` mesh for batch-axis data parallelism — what
    ``gcv.compile(devices=)`` / ``gcv.serve(devices=)`` shard over.

    ``devices`` is ``None`` (every card), an int (the first N cards,
    degrading with a warning when fewer exist; a host with no card has
    one device, the CPU), or an explicit sequence of devices, which may
    repeat one (see the module docstring).  A pre-built ``Mesh`` goes
    through ``as_data_mesh`` instead."""
    if devices is None:
        devs = available_devices()
    elif isinstance(devices, int):
        assert devices >= 1, f"devices must be >= 1, got {devices}"
        avail = available_devices()
        if devices > len(avail):
            warnings.warn(
                f"requested {devices} devices but only {len(avail)} "
                f"exist; using all {len(avail)}", UserWarning, stacklevel=2)
            obs.instant("mesh.degraded", cat="launch",
                        requested=[devices], got=[len(avail)],
                        devices=len(avail))
        devs = avail[:devices]
    else:
        assert not isinstance(devices, Mesh), \
            "a pre-built Mesh goes in mesh=, not devices="
        devs = [torch.device(d) for d in devices]
        assert devs, "empty device sequence"
    return Mesh(devs, ("data",))


def as_data_mesh(mesh) -> Mesh:
    """Validate a user-supplied mesh for the batch-sharded serving path:
    1-D with a ``data`` axis."""
    assert isinstance(mesh, Mesh), \
        f"mesh= expects a repro_torch.launch.mesh.Mesh, got " \
        f"{type(mesh).__name__}"
    assert tuple(mesh.axis_names) == ("data",), \
        f"batch sharding needs a 1-D ('data',) mesh, got axes " \
        f"{tuple(mesh.axis_names)} — build one with " \
        f"launch.mesh.make_data_mesh(...)"
    return mesh


def mesh_axes(mesh):
    """(dp_axes, model_axis, fsdp_axes) conventions for a mesh."""
    names = mesh.axis_names
    model = "model" if "model" in names else names[-1]
    dp = tuple(n for n in names if n != model)
    return dp, model, dp


# ------------------------------------------------------------ processes --
# How long a rank waits in a collective before its group fails (NCCL's
# watchdog, gloo's timeout): long enough for one rank's one-card
# comparison step while the others wait at a barrier.
GROUP_TIMEOUT = datetime.timedelta(seconds=300)


def init_process_group(rank: int, world_size: int, init_method: str, *,
                       device_type: str = "cuda") -> torch.device:
    """Join this process to its group as ``rank`` of ``world_size``
    (``init_method`` e.g. ``"tcp://localhost:<port>"``): NCCL on cuda,
    where the rank's card (``rank`` mod the cards) is made current first
    and the group binds to it; gloo on cpu.  Returns the rank's device.
    A rank that cannot join raises; there is no one-process fallback."""
    import torch.distributed as dist
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        dist.init_process_group(
            "nccl", init_method=init_method, world_size=world_size,
            rank=rank, device_id=dev, timeout=GROUP_TIMEOUT)
    elif device_type == "cpu":
        dev = torch.device("cpu")
        dist.init_process_group(
            "gloo", init_method=init_method, world_size=world_size,
            rank=rank, timeout=GROUP_TIMEOUT)
    else:
        raise ValueError(f"device_type must be cuda or cpu, got "
                         f"{device_type!r}")
    return dev


def make_process_mesh(shape=(2, 4), axes=("data", "model")) -> Mesh:
    """A ``Mesh`` over the ranks of the initialized group, bound to a
    ``DeviceMesh`` of the same shape and axis names (every rank calls it,
    in the same order).  With fewer ranks than ``shape`` asks, the
    largest fitting shape is built instead, with the builders' warning and
    trace marker; the (fitted) shape must then use every rank.  On a
    one-card host that is a ``(1, 1)`` mesh: NCCL takes one rank a card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    want = tuple(int(s) for s in shape)
    if int(np.prod(want)) > world:
        got = fit_shape(want, world)
        warnings.warn(
            f"mesh shape {want} needs {int(np.prod(want))} ranks but only "
            f"{world} exist; degrading to {got} (axes {tuple(axes)})",
            UserWarning, stacklevel=2)
        obs.instant("mesh.degraded", cat="launch", requested=list(want),
                    got=list(got), devices=world)
        want = got
    if int(np.prod(want)) != world:
        raise ValueError(f"mesh shape {want} holds {int(np.prod(want))} "
                         f"ranks, the group {world}")
    backend = dist.get_backend()
    device_type = "cpu" if backend == "gloo" else "cuda"
    dm = init_device_mesh(device_type, want, mesh_dim_names=tuple(axes))
    if "fake" in backend:
        # the dry run's group (launch/dryrun.py): its collectives move
        # nothing and its tensors are meta, shapes without data
        grid = [torch.device("meta")] * world
    else:
        n_cards = torch.cuda.device_count() if device_type == "cuda" else 0
        grid = [torch.device("cuda", r % n_cards) if n_cards
                else torch.device("cpu") for r in range(world)]
    return Mesh(np.asarray(grid, dtype=object).reshape(want), tuple(axes),
                device_mesh=dm)


def init_fake_group(world_size: int) -> None:
    """Join this process, as rank 0, to a group of ``world_size`` ranks on
    the ``fake`` backend, whose collectives move nothing and return at
    once: the dry run's group (``launch/dryrun.py``), where the other
    ranks exist only as the shapes of their blocks, on ``meta`` tensors
    (``make_process_mesh`` gives its mesh meta devices)."""
    import torch.distributed as dist
    # importing this module registers the fake backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    # meta tensors need the backend too (``batch_isend_irecv`` looks it
    # up by the tensors' device)
    dist.init_process_group("cpu:fake,cuda:fake,meta:fake",
                            store=FakeStore(), rank=0,
                            world_size=world_size)


def destroy_process_group() -> None:
    """Leave the group (each phase of a run ends with it, or the next
    group's setup waits on the last one's)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
