"""Step 1 — layer fusion (paper §V-B/§V-C2).

Port of ``src/repro/core/passes/fusion.py``
(numpy/stdlib only; imports rewritten).

Three fusions, each mirroring the paper:
  1. inference BatchNorm folded into the *producing* conv/linear weights
     (w' = w·γ/√(σ²+ε), b' = (b-μ)·γ/√(σ²+ε) + β) — removes the layer.
  2. activation folded into the producing compute layer (``fused_act`` —
     executed in the matmul epilogue, one pass over RB).
  3. DM-layer fusion (§V-C2): a DM layer feeding a compute layer is marked
     ``fused`` — Step 2 then folds the layout change into the consumer's
     matmul indexing (the B2P-routing trick) instead of materializing it.

Residual ``add`` whose left input is a single-consumer conv/linear is fused
as the matmul's residual epilogue.
"""
from __future__ import annotations

import numpy as np

from repro_torch import obs
from repro_torch.core.ir import Graph, Layer

_COMPUTE = {"conv", "linear", "mp"}


def _light_copy(g: Graph) -> Graph:
    """Copy graph structure with *shared* weight arrays (folding writes new
    arrays into fresh dicts, never mutating the originals) — deepcopy of a
    VGG-scale graph would double peak memory."""
    ng = Graph(g.name)
    for l in g.layers.values():
        ng.layers[l.name] = Layer(l.name, l.kind, tuple(l.inputs),
                                  dict(l.params), dict(l.weights),
                                  l.out_shape)
    ng.outputs = list(g.outputs)
    ng.meta = dict(getattr(g, "meta", None) or {})
    return ng


def _consumers(g: Graph) -> dict[str, list[str]]:
    cons: dict[str, list[str]] = {name: [] for name in g.layers}
    for layer in g.layers.values():
        for inp in layer.inputs:
            cons[inp].append(layer.name)
    return cons


def _fold_batchnorm(prod: Layer, bn: Layer) -> None:
    eps = bn.params.get("eps", 1e-5)
    mean = bn.weights.get("mean", 0.0)
    var = bn.weights.get("var", 1.0)
    scale = bn.weights.get("scale", 1.0)
    bias = bn.weights.get("bias", 0.0)
    inv = scale / np.sqrt(var + eps)
    w = prod.weights["w"]
    if prod.kind == "conv":         # w: (k1, k2, c_in, c_out)
        prod.weights["w"] = (w * inv[None, None, None, :]).astype(w.dtype)
    else:                           # linear w: (f_in, f_out)
        prod.weights["w"] = (w * inv[None, :]).astype(w.dtype)
    b = prod.weights.get("b", np.zeros(w.shape[-1], w.dtype))
    prod.weights["b"] = ((b - mean) * inv + bias).astype(w.dtype)


def fuse_layers(g: Graph, *, enable: bool = True,
                dm_fusion: bool = True) -> Graph:
    """Returns a new graph with fused/eliminated layers. ``enable=False``
    keeps every layer standalone (the §VII-C ablation baseline)."""
    with obs.span("pass.fusion", cat="compile", graph=g.name,
                  layers_in=len(g.layers), enable=enable,
                  dm_fusion=dm_fusion) as sp:
        out = _fuse_layers(g, enable=enable, dm_fusion=dm_fusion)
        sp.set(layers_out=len(out.layers))
        return out


def _fuse_layers(g: Graph, *, enable: bool, dm_fusion: bool) -> Graph:
    g = _light_copy(g)
    if not enable:
        return g
    cons = _consumers(g)
    order = {name: i for i, name in enumerate(g.layers)}
    dead: set[str] = set()
    rename: dict[str, str] = {}

    def resolve(name: str) -> str:
        while name in rename:
            name = rename[name]
        return name

    for layer in list(g.layers.values()):
        if layer.name in dead:
            continue
        src = resolve(layer.inputs[0]) if layer.inputs else None
        prod = g.layers[src] if src else None
        single = prod is not None and len(cons[prod.name]) == 1
        # 1. BatchNorm folding (static statistics only)
        if (layer.kind == "norm" and layer.params.get("norm") == "batch"
                and "mean" in layer.weights and prod is not None
                and prod.kind in {"conv", "linear"} and single):
            _fold_batchnorm(prod, layer)
            dead.add(layer.name)
            rename[layer.name] = prod.name
            continue
        # 2. activation folding (after a fused residual the activation runs
        #    post-add, e.g. ResNet's relu(conv + shortcut))
        if (layer.kind == "act" and prod is not None
                and prod.kind in _COMPUTE and single
                and "fused_act" not in prod.params):
            prod.params["fused_act"] = layer.params["fn"]
            if layer.params.get("alpha") is not None:
                prod.params["fused_act_alpha"] = layer.params["alpha"]
            if "fused_residual" in prod.params:
                prod.params["act_pos"] = "post_res"
            dead.add(layer.name)
            rename[layer.name] = prod.name
            continue
        # 3. residual-add folding into the left producer's epilogue
        #    (only if the residual operand is computed before the producer —
        #    the epilogue reads it from the result buffer)
        if (layer.kind == "add" and prod is not None
                and prod.kind in {"conv", "linear"} and single
                and "fused_residual" not in prod.params
                and "fused_act" not in prod.params
                and order[resolve(layer.inputs[1])] < order[prod.name]):
            prod.params["fused_residual"] = resolve(layer.inputs[1])
            dead.add(layer.name)
            rename[layer.name] = prod.name
            continue
        # 4. DM fusion marker (consumed by Step 2)
        if layer.kind == "dm" and dm_fusion:
            nxt = [g.layers[c] for c in cons[layer.name]]
            if nxt and all(n.kind in _COMPUTE for n in nxt):
                layer.params["fused"] = True

    fused = Graph(g.name)
    fused_count = 0
    for layer in g.layers.values():
        if layer.name in dead:
            fused_count += 1
            continue
        layer.inputs = tuple(resolve(i) for i in layer.inputs)
        # fused_residual may reference a renamed layer
        if "fused_residual" in layer.params:
            layer.params["fused_residual"] = resolve(
                layer.params["fused_residual"])
        fused.layers[layer.name] = layer
    fused.outputs = [resolve(o) for o in g.outputs]
    fused_count += sum(1 for l in fused.layers.values()
                       if l.kind == "dm" and l.params.get("fused"))
    fused.meta = {**(getattr(g, "meta", None) or {}),
                  "fused_layers": fused_count}
    return fused
