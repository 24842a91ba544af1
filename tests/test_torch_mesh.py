"""The port's mesh builders (``repro_torch/launch/mesh.py``) against the
reference's (``src/repro/launch/mesh.py``) and its ``tests/test_mesh.py``.

The reference's nine tests, each with its counterpart here, written
against whatever device count the host has (no card here: one device, the
CPU), degradation provoked by asking for more devices than exist.  Beside
them: ``fit_shape`` equal to the reference's over a grid of shapes, the
``Mesh`` grid itself (equality, hashing, a device named more than once)
and ``mesh_axes`` equal to the reference's.
"""
import itertools
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.launch import mesh as ref_lm
from repro_torch import obs
from repro_torch.launch import mesh as lm

AVAIL = len(lm.available_devices())


# ------------------------------------------------------------ fit_shape --
def test_fit_shape_prefers_later_axes():
    """Later (model/TP) axes keep their extent first; leading DP axes
    give way."""
    assert lm.fit_shape((2, 4), 8) == (2, 4)
    assert lm.fit_shape((2, 4), 4) == (1, 4)
    assert lm.fit_shape((2, 4), 2) == (1, 2)
    assert lm.fit_shape((2, 4), 1) == (1, 1)
    assert lm.fit_shape((2, 16, 16), 16) == (1, 1, 16)
    assert lm.fit_shape((4,), 3) == (3,)


def test_fit_shape_equals_the_reference():
    shapes = [(4,), (3,), (2, 4), (4, 2), (16, 16), (2, 16, 16), (3, 5, 2)]
    for shape, n in itertools.product(shapes, range(1, 40)):
        assert lm.fit_shape(shape, n) == ref_lm.fit_shape(shape, n), \
            (shape, n)


# ------------------------------------------- builders, degradation path --
def test_host_mesh_degrades_with_warning():
    """Request double the available devices on the model axis: the mesh
    must shrink to what exists, model axis first."""
    with pytest.warns(UserWarning, match="degrading"):
        mesh = lm.make_host_mesh((2, 2 * AVAIL))
    assert dict(mesh.shape) == {"data": 1, "model": AVAIL}
    assert mesh.size == AVAIL


def test_host_mesh_exact_fit_stays_silent():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mesh = lm.make_host_mesh((1, AVAIL))
    assert mesh.size == AVAIL


def test_production_mesh_degrades_to_available():
    with pytest.warns(UserWarning):       # (16, 16) never fits here
        mesh = lm.make_production_mesh()
    assert mesh.size == AVAIL
    with pytest.warns(UserWarning):
        pods = lm.make_production_mesh(multi_pod=True)
    assert pods.axis_names == ("pod", "data", "model")
    assert pods.devices.shape == lm.fit_shape((2, 16, 16), AVAIL)


def test_degradation_emits_trace_marker():
    tracer = obs.get_tracer()
    tracer.clear()
    tracer.enable()
    try:
        with pytest.warns(UserWarning):
            lm.make_host_mesh((2, 2 * AVAIL))
    finally:
        tracer.disable()
    marks = [e for e in tracer.events if e["name"] == "mesh.degraded"]
    assert len(marks) == 1
    assert marks[0]["args"]["requested"] == [2, 2 * AVAIL]
    assert marks[0]["args"]["got"] == [1, AVAIL]
    assert marks[0]["args"]["devices"] == AVAIL


# ----------------------------------------------------------- data mesh ----
def test_data_mesh_int_degrades_with_warning():
    tracer = obs.get_tracer()
    tracer.clear()
    tracer.enable()
    try:
        with pytest.warns(UserWarning, match="only"):
            mesh = lm.make_data_mesh(2 * AVAIL)
    finally:
        tracer.disable()
    assert mesh.size == AVAIL
    assert tuple(mesh.axis_names) == ("data",)
    (mark,) = [e for e in tracer.events if e["name"] == "mesh.degraded"]
    assert mark["args"] == {"requested": [2 * AVAIL], "got": [AVAIL],
                            "devices": AVAIL}


def test_data_mesh_default_and_explicit():
    assert lm.make_data_mesh().size == AVAIL
    mesh = lm.make_data_mesh(lm.available_devices())
    assert tuple(mesh.axis_names) == ("data",)
    assert lm.as_data_mesh(mesh) is mesh


def test_data_mesh_int_exact_stays_silent():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mesh = lm.make_data_mesh(1)
    assert mesh.size == 1


def test_as_data_mesh_rejects_wrong_axes():
    grid = np.asarray(lm.available_devices(), dtype=object).reshape(
        1, AVAIL)
    wrong = lm.Mesh(grid, ("data", "model"))
    with pytest.raises(AssertionError, match="1-D"):
        lm.as_data_mesh(wrong)
    with pytest.raises(AssertionError, match="Mesh"):
        lm.as_data_mesh(lm.available_devices())
    with pytest.raises(AssertionError, match="Mesh"):
        lm.as_data_mesh(jax.sharding.Mesh(np.asarray(jax.devices()),
                                          ("data",)))


# -------------------------------------------------------------- the grid --
def test_a_device_named_twice_is_two_entries():
    """The stand-in for several devices: each entry a replica."""
    mesh = lm.make_data_mesh(["cpu"] * 4)
    assert mesh.size == 4 and mesh.shape == {"data": 4}
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    same = lm.make_data_mesh([torch.device("cpu")] * 4)
    assert same == mesh and hash(same) == hash(mesh)
    assert lm.make_data_mesh(["cpu"] * 2) != mesh
    assert lm.Mesh(mesh.devices, ("other",)) != mesh
    with pytest.raises(AssertionError, match="empty"):
        lm.make_data_mesh([])
    with pytest.raises(AssertionError, match=">= 1"):
        lm.make_data_mesh(0)
    with pytest.raises(AssertionError, match="mesh="):
        lm.make_data_mesh(mesh)


def test_mesh_axes_equal_the_reference():
    class Named:
        def __init__(self, names):
            self.axis_names = names
    for names in [("data",), ("data", "model"), ("pod", "data", "model"),
                  ("a", "b")]:
        assert lm.mesh_axes(Named(names)) == ref_lm.mesh_axes(Named(names))
