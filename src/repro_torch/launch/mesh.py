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
process.  Binding a mesh to ``torch.distributed.device_mesh`` for the LM's
multi-process sharding is ROADMAP queue 1 item 6's second half.
"""
from __future__ import annotations

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
    entry (``core.runtime.cache``)."""

    def __init__(self, devices, axis_names):
        src = np.asarray(devices, dtype=object)
        grid = np.empty(src.shape, dtype=object)
        for i, d in np.ndenumerate(src):
            grid[i] = torch.device(d)
        self.devices = grid
        self.axis_names = tuple(axis_names)
        assert grid.ndim == len(self.axis_names), \
            f"a {grid.ndim}-D device grid needs {grid.ndim} axis names, " \
            f"got {self.axis_names}"

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes: (16, 16) ``("data", "model")``,
    or (2, 16, 16) with a leading ``"pod"`` axis — degraded to the devices
    the host has."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _build(shape, axes)


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
