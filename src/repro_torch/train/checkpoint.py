"""Checkpointing in the reference's on-disk format.

Port of ``src/repro/train/checkpoint.py``.  Each checkpoint is a directory
``step_<N>/`` holding ``arrays.npz`` (one array per leaf) and
``manifest.json`` (step, ``extra`` such as the data cursor, and each leaf's
shape and dtype).  Leaf keys join the tree path with ``"\\x1e"`` as the
reference's do: dict keys in sorted order, a ``QTensor``'s fields as
``.codes`` and ``.scale``.  bf16 is stored as ``uint16`` with dtype
``"bfloat16"`` in the manifest, so either package restores what the other
saved.  Writes are atomic (``step_<N>.tmp``, then a rename), the oldest
checkpoints beyond ``keep`` are deleted, and ``install_preemption_hook``
makes SIGTERM set a flag the train loop polls (checkpoint and exit).

Arrays are copied to the host leaf by leaf and restored onto each leaf's
device and dtype in ``like``.

On a mesh (``DTensor`` leaves, ``distributed.sharding.device_put``) every
rank calls ``save``: each leaf is gathered whole on every rank, in one
order, and rank 0 alone writes, then all ranks wait for the rename.
``restore(shardings=)`` is the reference's elastic restore: every rank
reads the global arrays and places each leaf by its ``NamedSharding``
(``sharding.place``), whatever mesh shape wrote them, one device
included; a leaf without one is restored as it is.  An int8 moment
(``optim.QTensor``) is saved in the reference's layout (``QTensor.whole``:
a moment whose shards cut its blocks holds its codes unpadded) and
restored as its ``like`` moment holds it (``QTensor.fit``);
``optim.moment_shardings`` gives the moments' shardings.
"""
from __future__ import annotations

import json
import os
import shutil
import signal

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import place
from repro_torch.train.optim import QTensor

_SEP = "\x1e"  # record separator — safe vs '/' in keys


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix=(), *, moments=False) -> dict:
    """Leaves by joined path; with ``moments`` a ``QTensor`` is one leaf
    (its fields' paths are its path's ``.codes`` and ``.scale``)."""
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_flatten(tree[key], prefix + (str(key),),
                                moments=moments))
        return out
    if moments and isinstance(tree, QTensor):
        return {_SEP.join(prefix): tree}
    if _is_namedtuple(tree):
        out = {}
        for name in tree._fields:
            out.update(_flatten(getattr(tree, name), prefix + ("." + name,),
                                moments=moments))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, leaf in enumerate(tree):
            out.update(_flatten(leaf, prefix + (str(i),), moments=moments))
        return out
    return {_SEP.join(prefix): tree}


def _fields(key: str, leaf) -> dict:
    """A flattened leaf as the arrays the npz holds: a ``QTensor``'s
    codes and scale under their own paths."""
    if isinstance(leaf, QTensor):
        return {key + _SEP + "." + f: t for f, t in leaf._asdict().items()}
    return {key: leaf}


def tree_paths(tree) -> list[str]:
    return list(_flatten(tree).keys())


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the numpy array the npz stores, and its dtype's name."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:          # npz can't store bfloat16
            return t.view(torch.int16).cpu().numpy().view(np.uint16), \
                "bfloat16"
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str | None) -> torch.Tensor:
    arr = np.asarray(arr, order="C")           # keeps a 0-d array 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._preempted = False

    # ------------------------------------------------------------- save ---
    def save(self, step: int, state, *, extra: dict | None = None):
        """state: a nested dict of tensors (params, opt state, ...).
        Atomic; returns the checkpoint's directory.  On a mesh every rank
        calls it (module docstring)."""
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        group = any(col.is_dtensor(t) for t in _flatten(state).values())
        writer = not group or dist.get_rank() == 0
        arrays = {}
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        for key, leaf in _flatten(state, moments=True).items():
            whole = leaf.whole() if isinstance(leaf, QTensor) \
                else col.whole(leaf)
            for k, t in _fields(key, whole).items():
                if writer:
                    arr, dtype = _to_host(t)
                    arrays[k] = arr
                    manifest["leaves"][k] = {"shape": list(arr.shape),
                                             "dtype": dtype}
        if writer:
            self._write(tmp, final, arrays, manifest)
        if group:
            dist.barrier()
        return final

    def _write(self, tmp, final, arrays, manifest):
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ---------------------------------------------------------- restore ---
    def restore(self, step: int, like, *, shardings=None):
        """Restore into the structure of ``like`` (a nested dict of tensors,
        ``QTensor``s included): each leaf takes its ``like`` leaf's dtype
        and device.  ``shardings``: a matching (partial) tree of
        ``NamedSharding``s; each leaf that has one is placed by it (module
        docstring)."""
        man = self.manifest(step)["leaves"]
        flat_like = _flatten(like, moments=True)
        shard_flat = _flatten(shardings, moments=True) \
            if shardings is not None else {}
        with np.load(os.path.join(self.dir, f"step_{step}",
                                  "arrays.npz")) as z:
            missing = set(_flatten(like)) - set(z.files)
            if missing:
                raise KeyError(f"checkpoint missing leaves: "
                               f"{sorted(missing)}")

            def read(k):
                return _from_host(z[k], man.get(k, {}).get("dtype"))

            restored = {}
            for key, leaf in flat_like.items():
                if isinstance(leaf, QTensor):
                    got = QTensor(*(read(k) for k in _fields(key, leaf)))
                    got = QTensor(*map(_restored, got.fit(leaf), leaf,
                                       shard_flat.get(key, (None, None))))
                else:
                    got = _restored(read(key), leaf, shard_flat.get(key))
                restored[key] = got
        return _unflatten_like(like, restored)

    def manifest(self, step: int):
        with open(os.path.join(self.dir, f"step_{step}",
                               "manifest.json")) as f:
            return json.load(f)

    # --------------------------------------------------------- preempt ----
    def install_preemption_hook(self):
        def handler(signum, frame):
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)

    @property
    def preempted(self):
        return self._preempted


def _restored(t, like, sharding):
    """A read array as its ``like`` leaf: placed by ``sharding`` when
    given, else on the leaf's device; in its dtype."""
    if sharding is not None:
        return place(t.to(dtype=like.dtype), sharding)
    return t.to(device=col.local(like).device, dtype=like.dtype)


def _unflatten_like(like, flat_map, prefix=()):
    if isinstance(like, QTensor):
        return flat_map[_SEP.join(prefix)]
    if isinstance(like, dict):
        return {key: _unflatten_like(like[key], flat_map, prefix + (str(key),))
                for key in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten_like(getattr(like, name), flat_map,
                                            prefix + ("." + name,))
                            for name in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(leaf, flat_map, prefix + (str(i),))
                          for i, leaf in enumerate(like))
    return flat_map[_SEP.join(prefix)]
