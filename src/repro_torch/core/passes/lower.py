"""Step 2 — layer-to-matrix-operation mapping (paper §V-B, §V-C3/4).

Port of ``src/repro/core/passes/lower.py``
(numpy/stdlib only; imports rewritten).

Uniform mapping: *both* Conv layers and MP layers become matrix operations.

  Conv  -> the Fig. 7 shift-add scheme (a single fused 'conv' MatOp whose
           realization is k1·k2 DDMMs + PVVA merges; kernels/shift_conv.py).
  MP    -> adjacency x features matmul:  2-D features (N,F): A @ X;
           3-D (C,T,V) features (ST-GCN style): (C·T,V) @ Aᵀ — the layout
           chosen so no transform is needed between CNN and GNN layers.
  Linear-> X @ W (+bias); VIP -> SDDMM(X, Xᵀ, mask).
  DM    -> fused DM layers lower to zero-cost 'identity' (the layout shuffle
           rides the consumer's matmul indexing / B2P network); unfused ones
           lower to explicit transpose/reshape ops charged at memory cost —
           the §VII-C ablation contrast.

Shape inference runs inline; every MatOp records (s1, s2, s3) and static
operand density for Steps 3-5.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch import obs
from repro_torch.core.ir import Graph
from repro_torch.core.plan import ExecutionPlan, MatOp


def _density(w: np.ndarray) -> float:
    return float((w != 0).sum()) / max(w.size, 1)


def _act_attrs(p: dict) -> dict:
    """The fused-activation epilogue attrs every compute MatOp carries
    (one definition, so a new epilogue parameter lands everywhere)."""
    return {"fused_act": p.get("fused_act"),
            "fused_act_alpha": p.get("fused_act_alpha")}


def lower_to_matops(g: Graph) -> ExecutionPlan:
    with obs.span("pass.lower", cat="compile", graph=g.name,
                  layers=len(g.layers)) as sp:
        plan = _lower_to_matops(g)
        sp.set(ops=len(plan.ops))
        return plan


def _lower_to_matops(g: Graph) -> ExecutionPlan:
    shapes: dict[str, tuple[int, ...]] = {}
    ops: list[MatOp] = []
    inputs: list[str] = []

    def emit(op: MatOp) -> None:
        shapes[op.name] = op.out_shape
        ops.append(op)

    for layer in g.toposorted():
        name, kind, p = layer.name, layer.kind, layer.params
        portion = p.get("portion", "other")
        ish = [shapes[i] for i in layer.inputs] if layer.inputs else []

        if kind == "input":
            shapes[name] = p["shape"]
            inputs.append(name)

        elif kind == "conv":
            lead = ish[0][:-3]                   # optional batch dim
            c, h, w_sp = ish[0][-3:]
            k1, k2, cin, cout = layer.weights["w"].shape
            groups = int(p.get("groups", 1))
            dil = p.get("dilation", 1)
            dh, dw = (dil, dil) if isinstance(dil, int) else tuple(dil)
            # weights hold *per-group* input channels
            assert cin * groups == c, (name, ish[0], groups,
                                       layer.weights["w"].shape)
            assert cout % groups == 0, (name, groups, cout)
            stride = p.get("stride", 1)
            sh, sw = (stride, stride) if isinstance(stride, int) else stride
            ke1, ke2 = (k1 - 1) * dh + 1, (k2 - 1) * dw + 1
            if p.get("padding", "SAME") == "SAME":
                ho, wo = -(-h // sh), -(-w_sp // sw)
            else:
                ho = (h - ke1) // sh + 1
                wo = (w_sp - ke2) // sw + 1
            extra = {}
            if groups != 1:
                extra["groups"] = groups
            if (dh, dw) != (1, 1):
                extra["dilation"] = (dh, dw)
            emit(MatOp(name, "conv", layer.inputs, dict(layer.weights),
                       {"stride": (sh, sw),
                        "padding": p.get("padding", "SAME"),
                        **extra,
                        **_act_attrs(p),
                        "act_pos": p.get("act_pos"),
                        "fused_residual": p.get("fused_residual"),
                        "k": (k1, k2), "batch": int(np.prod(lead)) if lead
                        else 1,
                        "density": _density(layer.weights["w"])},
                       tuple(lead) + (cout, ho, wo), portion))

        elif kind == "linear":
            fin, fout = layer.weights["w"].shape
            lead = ish[0][:-1]
            emit(MatOp(name, "mm", layer.inputs, dict(layer.weights),
                       {"weight_side": "right",
                        **_act_attrs(p),
                        "fused_residual": p.get("fused_residual"),
                        "s1": int(np.prod(lead)) if lead else 1,
                        "s2": fin, "s3": fout,
                        "density": _density(layer.weights["w"])},
                       tuple(lead) + (fout,), portion))

        elif kind == "mp":
            x_shape = ish[0]
            if p.get("runtime_knn"):
                # connectivity itself is a runtime value: inputs are
                # (features (N, F), neighbor indices (N, k)); unweighted
                # gather + reduce over each row's k neighbors
                nv, feat = x_shape
                kk = ish[1][1]
                emit(MatOp(name, "mm", layer.inputs, {},
                           {"weight_side": "left_knn",
                            "runtime_knn": True,
                            **_act_attrs(p),
                            "reduce": p.get("reduce", "sum"),
                            "n": nv, "nnz": nv * kk, "k": kk,
                            "s1": nv, "s2": nv, "s3": feat,
                            "density": kk / float(nv)},
                           x_shape, portion))
            elif "coo_rows" in layer.weights:
                nv = p["n"]
                nnz = layer.weights["coo_rows"].size
                emit(MatOp(name, "mm", layer.inputs, dict(layer.weights),
                           {"weight_side": "left_coo",
                            "runtime_edge": bool(p.get("runtime_edge")),
                            **_act_attrs(p),
                            "reduce": p.get("reduce", "sum"),
                            "n": nv, "nnz": nnz,
                            "s1": nv, "s2": nv, "s3": x_shape[-1],
                            "density": nnz / float(nv) ** 2},
                           x_shape, portion))
            elif p.get("runtime_adj"):
                nv = x_shape[0]
                emit(MatOp(name, "mm", layer.inputs, {},
                           {"weight_side": "left_runtime",
                            **_act_attrs(p),
                            "s1": nv, "s2": nv, "s3": x_shape[1],
                            "density": 1.0},
                           x_shape, portion))
            else:
                adj = layer.weights["adj"]
                nv = adj.shape[0]
                if p.get("reduce", "sum") == "max":
                    emit(MatOp(name, "maxagg", layer.inputs,
                               {"adj": adj},
                               {"nnz": int((adj != 0).sum()),
                                "s3": x_shape[-1]},
                               x_shape, portion))
                elif len(x_shape) == 2:          # (N, F): A @ X
                    emit(MatOp(name, "mm", layer.inputs, {"adj": adj},
                               {"weight_side": "left",
                                **_act_attrs(p),
                                "s1": nv, "s2": nv, "s3": x_shape[1],
                                "density": _density(adj)},
                               x_shape, portion))
                else:                            # (C, T, V): (C·T,V) @ Aᵀ
                    c, t, v = x_shape
                    assert v == nv, (name, x_shape, adj.shape)
                    emit(MatOp(name, "mm", layer.inputs, {"adj": adj},
                               {"weight_side": "right_t",
                                **_act_attrs(p),
                                "s1": c * t, "s2": v, "s3": v,
                                "density": _density(adj)},
                               x_shape, portion))

        elif kind == "knn_graph":
            n_pts, feat = ish[0]
            emit(MatOp(name, "knn_graph", layer.inputs, {},
                       {"k": int(p["k"]),
                        "self_loops": bool(p.get("self_loops")),
                        "masked": bool(p.get("masked")),
                        "s1": n_pts, "s2": feat, "s3": n_pts,
                        "nnz": n_pts * int(p["k"]),
                        "density": int(p["k"]) / float(n_pts)},
                       (n_pts, int(p["k"])), portion))

        elif kind == "vip":
            n, f = ish[0]
            if "coo_rows" in layer.weights:   # per-edge scores (nnz,)
                nnz = layer.weights["coo_rows"].size
                emit(MatOp(name, "sddmm", layer.inputs,
                           dict(layer.weights),
                           {"exec": "coo", "s1": n, "s2": f, "s3": n,
                            "nnz": nnz},
                           (nnz,), portion))
            else:
                mask = layer.weights.get("mask")
                emit(MatOp(name, "sddmm", layer.inputs,
                           {} if mask is None else {"mask": mask},
                           {"s1": n, "s2": f, "s3": n,
                            "nnz": int((mask != 0).sum()) if mask is not None
                            else n * n},
                           (n, n), portion))

        elif kind == "dm":
            mode = p["mode"]
            fused = bool(p.get("fused"))
            src = ish[0]
            if mode == "channel_to_node":        # (C,H,W) -> (C, H·W)
                out = (src[0], src[1] * src[2])
            elif mode == "patch_to_node":        # (C,H,W) -> (H·W, C)
                out = (src[1] * src[2], src[0])
            elif mode == "node_to_channel":      # (N,F) -> (F, h, w)
                hw = p.get("hw")
                if hw is None:
                    side = int(math.isqrt(src[0]))
                    hw = (side, src[0] // side)
                out = (src[1], hw[0], hw[1])
            else:
                raise ValueError(mode)
            emit(MatOp(name, "identity" if fused else "transpose",
                       layer.inputs, {},
                       {"mode": mode, "fused": fused,
                        "bytes": int(np.prod(src)) * 2},
                       out, "dm"))

        elif kind == "pool":
            lead = ish[0][:-3]
            c, h, w_sp = ish[0][-3:]
            s = p.get("stride", p["window"])
            # window/stride are scalars (square, the builder's spelling)
            # or (kh, kw) tuples (rectangular, from traced reduce_window)
            s1, s2 = (s, s) if isinstance(s, int) else s
            emit(MatOp(name, "pool2d", layer.inputs, {},
                       {"window": p["window"], "stride": s,
                        "pool": p.get("pool", "max")},
                       tuple(lead) + (c, -(-h // s1), -(-w_sp // s2)),
                       portion))

        elif kind == "globalpool":
            src = ish[0]
            if len(src) == 4:                    # (B,C,H,W) -> (B,C)
                out = (src[0], src[1])
            elif len(src) == 3:                  # (C,H,W) -> (C,)
                out = (src[0],)
            else:                                # (N,F) -> (F,)
                out = (src[-1],)
            emit(MatOp(name, "globalpool", layer.inputs, {},
                       {"pool": p.get("pool", "avg"), "in_rank": len(src)},
                       out, portion))

        elif kind == "matmul":
            a, bsh = ish[0], ish[1]
            out = a[:-1] + bsh[1:]
            emit(MatOp(name, "mm", layer.inputs, {},
                       {"weight_side": "both_runtime",
                        **_act_attrs(p),
                        "s1": int(np.prod(a[:-1])) if a[:-1] else 1,
                        "s2": a[-1],
                        "s3": int(np.prod(bsh[1:])) if bsh[1:] else 1,
                        "density": 1.0},
                       out, portion))

        elif kind == "norm":
            emit(MatOp(name, "ew", layer.inputs, dict(layer.weights),
                       {"fn": "norm_" + p.get("norm", "batch"),
                        "eps": p.get("eps", 1e-5)},
                       ish[0], portion))

        elif kind == "act":
            attrs = {"fn": p["fn"]}
            if p.get("alpha") is not None:
                attrs["alpha"] = p["alpha"]
            emit(MatOp(name, "ew", layer.inputs, {}, attrs,
                       ish[0], portion))

        elif kind == "add":
            emit(MatOp(name, "ew", layer.inputs, {}, {"fn": "add"},
                       ish[0], portion))

        elif kind == "mul":
            emit(MatOp(name, "ew", layer.inputs, {}, {"fn": "mul"},
                       tuple(np.broadcast_shapes(ish[0], ish[1])), portion))

        elif kind == "softmax":
            if "segments" in layer.weights:
                emit(MatOp(name, "ew", layer.inputs, dict(layer.weights),
                           {"fn": "segment_softmax",
                            "num_segments": p["num_segments"]},
                           ish[0], portion))
            else:
                emit(MatOp(name, "ew", layer.inputs, dict(layer.weights),
                           {"fn": "softmax", "axis": p.get("axis", -1),
                            "masked": "mask" in layer.weights},
                           ish[0], portion))

        elif kind == "concat":
            axis = p.get("axis", 0)
            base = list(ish[0])
            base[axis] = sum(s[axis] for s in ish)
            emit(MatOp(name, "concat", layer.inputs, {}, {"axis": axis},
                       tuple(base), portion))

        elif kind == "flatten":
            emit(MatOp(name, "reshape", layer.inputs, {},
                       {"shape": (int(np.prod(ish[0])),)},
                       (int(np.prod(ish[0])),), portion))

        elif kind == "reshape":
            emit(MatOp(name, "reshape", layer.inputs, {},
                       {"shape": p["shape"]}, tuple(p["shape"]), portion))

        else:
            raise NotImplementedError(kind)

    gmeta = getattr(g, "meta", None) or {}
    return ExecutionPlan(
        g.name, inputs, ops, list(g.outputs),
        meta={"fused_layers": gmeta.get("fused_layers", 0),
              "frontend": gmeta.get("frontend", "builder"),
              "input_shapes": {i: shapes[i] for i in inputs}})
