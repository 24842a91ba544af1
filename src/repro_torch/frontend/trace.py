"""Tracing frontend, stage 1: aten graph -> proto-layer trace graph (§V-A).

Port of ``src/repro/frontend/trace.py``.  ``trace_model`` is the paper's
PyTorch input parser: it takes a *plain torch callable* or an ``nn.Module``
in eval mode plus example inputs, records its aten graph with
``make_fx`` (fake tensors: nothing is computed, closed-over weights stay
real constants), and interprets every aten node into a ``TraceNode`` — a
proto-layer in the reference's own vocabulary (``dot``, ``conv``,
``reduce``, ``ew``, ``ew1``, ``bcast``, ``reshape``, ``transpose``,
``sort``, ``slice``, ...), which ``canonicalize`` rewrites into the
``Graph`` layer IR.

Interpretation rules:

  * nodes whose operands are all constants are folded eagerly (weight
    arithmetic done inside the model — ``w.T``, ``b[:, None, None]``,
    ``torch.as_tensor(array)`` — collapses back into plain weight arrays);
  * the ``gcv.*`` ops of ``frontend.nn`` map 1:1 onto ``mp`` / ``vip`` /
    ``norm`` / ``knn_graph`` / segment-``softmax`` proto-layers, with a
    *traced* adjacency read as the runtime-valued affinity case (b1) and a
    constant one as model structure;
  * **broadcasting is made explicit, as jaxpr spells it**: where a traced
    operand of an elementwise op has lower rank than the result, a
    ``bcast`` proto-node promotes its rank first; ``unsqueeze`` and
    ``expand`` are ``bcast`` nodes; a ``keepdim=True`` reduction is a
    reduce plus a ``bcast``.  So ``canonicalize`` stays a near-copy of the
    reference's and its idiom table (softmax chains, bias folds, the KNN
    distance expression, masked softmax) carries across;
  * padding: the IR knows SAME (TF-style, ``before = total // 2``) and
    VALID.  A ``constant_pad_nd`` (zeros before a conv or an average pool,
    ``-inf`` before a max pool) is folded into its consumer, and the
    total padding must equal SAME or VALID; any other padding raises
    naming the pads (torch's symmetric ``padding=1`` on a stride-2 3x3
    conv is not SAME);
  * sorting is accepted only as a *stable* ascending sort (the KNN
    argsort idiom); an unstable ``aten.sort`` raises;
  * any other aten op raises ``UnsupportedOpError`` naming it — no silent
    mis-lowering.

Proto-node names count nodes in creation order (``dot.7``); they differ
from the reference's jaxpr-equation numbering, and plans are compared with
it up to names.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Any, Mapping

import numpy as np
import torch

import repro_torch.frontend.nn  # noqa: F401  (registers the gcv:: ops)
from repro_torch import obs
from repro_torch.core.runtime.elementwise import LEAKY_SLOPE


class UnsupportedOpError(NotImplementedError):
    """An aten node (or post-trace pattern) the frontend cannot map onto
    the layer vocabulary.  The message always names the offending aten op,
    so users know which part of their model to rewrite (typically: express
    it through ``repro_torch.frontend.nn``)."""


@dataclasses.dataclass
class TraceNode:
    """One proto-layer: an aten node lifted to the frontend's working
    vocabulary.  ``inputs`` holds node names (str) for traced operands and
    ``np.ndarray`` for constant operands; layer-weight constants live in
    ``weights``.  ``src`` accumulates the aten nodes this node was
    recovered from (``aten.mm.default:(196, 192)``) — canonicalization
    folds pattern partners' provenance into the surviving node, and
    ``frontend.lint`` reports it."""
    name: str
    op: str
    inputs: list
    params: dict
    weights: dict
    shape: tuple
    dtype: Any
    src: list = dataclasses.field(default_factory=list)

    def refs(self) -> list[str]:
        return [i for i in self.inputs if isinstance(i, str)]


@dataclasses.dataclass
class TraceGraph:
    name: str
    nodes: dict[str, TraceNode]          # insertion order is topological
    input_names: list[str]
    output_names: list[str]


# ---------------------------------------------------------------------------
# helpers

def _is_const(atom) -> bool:
    return not isinstance(atom, str)


def _same_padding(sizes, windows, strides):
    pads = []
    for h, k, s in zip(sizes, windows, strides):
        out = -(-h // s)
        total = max((out - 1) * s + k - h, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _np_dtype(dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (tuple, list)):
        return type(v)(_to_numpy(x) for x in v)
    return v


def _to_torch(v):
    if isinstance(v, np.ndarray):
        return torch.tensor(v)
    if isinstance(v, (tuple, list)):
        return type(v)(_to_torch(x) for x in v)
    return v


def _bind(target, args, kwargs) -> dict:
    """Every schema argument of an aten/``gcv`` op by name, defaults
    filled (the names are the schema's own, so they hold across torch
    versions)."""
    out = {}
    schema = target._schema
    for i, arg in enumerate(schema.arguments):
        if i < len(args) and not arg.kwarg_only:
            out[arg.name] = args[i]
        elif arg.name in kwargs:
            out[arg.name] = kwargs[arg.name]
        elif arg.has_default_value():
            out[arg.name] = arg.default_value
        else:
            out[arg.name] = None
    return out


def _op_label(target) -> str:
    return str(target) if isinstance(target, torch._ops.OpOverload) \
        else getattr(target, "__name__", str(target))


class _Multi:
    """A multi-result aten node (``sort``, ``topk``, max pool with
    indices): each ``getitem`` makes the node of the result it reads, so
    unread results make none (the reference skips jaxpr ``DropVar``s)."""

    def __init__(self, label: str, make):
        self.label, self.make = label, make


class _Interpreter:
    def __init__(self, gm: torch.fx.GraphModule, graph_name: str):
        self.gm = gm
        self.tg = TraceGraph(graph_name, {}, [], [])
        self._n = 0
        self._label = None                 # aten node being interpreted

    # ---- node/env plumbing ----
    def fresh(self, prefix: str) -> str:
        self._n += 1
        return f"{prefix}.{self._n}"

    def node(self, prefix: str, op: str, inputs, params, weights, shape,
             dtype=torch.float32) -> str:
        name = self.fresh(prefix)
        shape = tuple(int(d) for d in shape)
        src = [f"{self._label}:{shape}"] if self._label else []
        self.tg.nodes[name] = TraceNode(name, op, list(inputs), params,
                                        weights, shape, dtype, src)
        return name

    def shape(self, ref) -> tuple:
        if isinstance(ref, str):
            return self.tg.nodes[ref].shape
        return tuple(np.shape(ref))

    def _get_attr(self, target: str):
        obj = self.gm
        for part in target.split("."):
            obj = getattr(obj, part)
        return _to_numpy(obj)

    def _resolve(self, env, a):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, (tuple, list)):
            return type(a)(self._resolve(env, x) for x in a)
        return a

    # ---- the interpreter loop ----
    def run(self, names):
        graph = self.gm.graph
        graph.eliminate_dead_code()
        env: dict = {}
        placeholders = iter(names)
        for n in graph.nodes:
            if n.op == "placeholder":
                name = next(placeholders)
                val = n.meta["val"]
                self.tg.nodes[name] = TraceNode(
                    name, "input", [], {}, {}, tuple(val.shape),
                    _np_dtype(val.dtype))
                self.tg.input_names.append(name)
                env[n] = name
            elif n.op == "get_attr":
                env[n] = self._get_attr(n.target)
            elif n.op == "call_function":
                env[n] = self.call(n, env)
            elif n.op == "output":
                outs = n.args[0]
                outs = outs if isinstance(outs, (tuple, list)) else (outs,)
                for o in outs:
                    ref = self._resolve(env, o)
                    if not isinstance(ref, str):
                        raise UnsupportedOpError(
                            "model output is a compile-time constant — "
                            "nothing to compile")
                    self.tg.output_names.append(ref)
            else:
                raise UnsupportedOpError(
                    f"fx node kind {n.op!r} ({n.target}) is not supported")
        self._prune_pads()
        return self.tg

    def _prune_pads(self):
        """Drop the pad nodes that every consumer folded in."""
        used = {r for nd in self.tg.nodes.values() for r in nd.refs()}
        used.update(self.tg.output_names)
        for name in [k for k, v in self.tg.nodes.items()
                     if v.op == "pad" and k not in used]:
            del self.tg.nodes[name]

    def call(self, n: torch.fx.Node, env):
        target = n.target
        if target is operator.getitem:
            src, idx = env[n.args[0]], n.args[1]
            if isinstance(src, _Multi):
                self._label = src.label
                try:
                    return src.make(idx, n)
                finally:
                    self._label = None
            return src[idx]
        label = _op_label(target)
        traced = any(isinstance(env[a], (str, _Multi))
                     for a in n.all_input_nodes)
        args = self._resolve(env, n.args)
        kwargs = self._resolve(env, dict(n.kwargs))
        if not traced:                    # constant folding
            with torch.no_grad():
                return _to_numpy(target(*_to_torch(args),
                                        **_to_torch(kwargs)))
        if not isinstance(target, torch._ops.OpOverload):
            raise UnsupportedOpError(
                f"{label} is not supported by the tracing frontend")
        if target.namespace == "gcv":
            prefix = "gcv_"
        elif target.namespace == "aten":
            prefix = "a_"
        else:
            prefix = None
        handler = prefix and getattr(
            self, prefix + target.overloadpacket.__name__, None)
        if handler is None:
            raise UnsupportedOpError(
                f"aten op '{label}' is not supported by the tracing "
                f"frontend (operand shapes "
                f"{[self.shape(a) for a in self._tensor_args(args)]}); "
                f"express this op via repro_torch.frontend.nn or the "
                f"declarative GraphBuilder")
        self._label = label
        try:
            return handler(n, _bind(target, args, kwargs))
        finally:
            self._label = None

    @staticmethod
    def _tensor_args(args):
        return [a for a in args if isinstance(a, (str, np.ndarray))]

    @staticmethod
    def _out(n):
        val = n.meta["val"]
        return tuple(val.shape), val.dtype

    def _refuse(self, why: str):
        raise UnsupportedOpError(f"aten op '{self._label}': {why}")

    # ---- identities -------------------------------------------------------
    def _identity(self, n, a):
        return a["self"]

    a_alias = a_detach = a_clone = a_lift_fresh_copy = _identity

    def a__to_copy(self, n, a):
        want = a.get("dtype")
        if want is not None and want != n.args[0].meta["val"].dtype:
            self._refuse(f"a cast to {want} is not supported (traced "
                         f"models stay in one dtype)")
        return a["self"]

    # ---- frontend ops -----------------------------------------------------
    def gcv_message_passing(self, n, a):
        x, adj, reduce = a["x"], a["adj"], a["reduce"]
        if _is_const(x):
            self._refuse("message passing over constant node features")
        shape, _ = self._out(n)
        if _is_const(adj):
            adj = np.asarray(adj)
            if not np.issubdtype(adj.dtype, np.floating):
                # indices traced from static points folded to a constant:
                # the equivalent unweighted COO (same numerics)
                ia = adj.astype(np.int32)
                nv, kk = ia.shape
                return self.node(
                    "mp", "mp", [x],
                    {"mode": "coo", "n": nv, "reduce": reduce},
                    {"coo_rows": np.repeat(np.arange(nv, dtype=np.int32),
                                           kk),
                     "coo_cols": ia.reshape(-1),
                     "coo_vals": np.ones(nv * kk, np.float32)}, shape)
            return self.node("mp", "mp", [x],
                             {"mode": "dense", "reduce": reduce},
                             {"adj": adj}, shape)
        if not torch.empty((), dtype=n.args[1].meta["val"].dtype) \
                .is_floating_point():
            return self.node("mp", "mp", [x, adj],
                             {"mode": "knn", "reduce": reduce}, {}, shape)
        if reduce != "sum":
            self._refuse("message passing with a runtime adjacency supports "
                         "reduce='sum' only (the paper's DDMM mapping)")
        return self.node("mp", "mp", [x, adj], {"mode": "dense_runtime"},
                         {}, shape)

    def gcv_message_passing_coo(self, n, a):
        x, rows, cols, vals = a["x"], a["rows"], a["cols"], a["vals"]
        if _is_const(x):
            self._refuse("message passing over constant node features")
        if not (_is_const(rows) and _is_const(cols)):
            self._refuse("message passing with traced COO connectivity is "
                         "not supported (edge *values* may be traced; "
                         "rows/cols must be static)")
        weights = {"coo_rows": np.asarray(rows, np.int32),
                   "coo_cols": np.asarray(cols, np.int32)}
        params = {"mode": "coo", "n": int(a["n"]), "reduce": a["reduce"]}
        inputs = [x]
        if _is_const(vals):
            weights["coo_vals"] = np.asarray(vals, np.float32)
        else:                                # GAT-style runtime edge values
            params["runtime_edge"] = True
            inputs.append(vals)
        return self.node("mp", "mp", inputs, params, weights,
                         self._out(n)[0])

    def gcv_vip(self, n, a):
        x = a["x"]
        if _is_const(x):
            self._refuse("vip over constant features")
        weights, mode = {}, "dense"
        if a["rows"] is not None:
            if not (_is_const(a["rows"]) and _is_const(a["cols"])):
                self._refuse("vip edges must be static")
            mode = "edges"
            weights["coo_rows"] = np.asarray(a["rows"], np.int32)
            weights["coo_cols"] = np.asarray(a["cols"], np.int32)
        elif a["mask"] is not None:
            if not _is_const(a["mask"]):
                self._refuse("vip mask must be static")
            mode = "mask"
            weights["mask"] = np.asarray(a["mask"])
        return self.node("vip", "vip", [x], {"mode": mode}, weights,
                         self._out(n)[0])

    def gcv_batch_norm(self, n, a):
        x = a["x"]
        stats = [a[k] for k in ("scale", "bias", "mean", "var")]
        return self._norm(n, x, stats, a["eps"])

    def _norm(self, n, x, stats, eps):
        if _is_const(x):
            self._refuse("batch norm over a constant input")
        if not all(_is_const(s) for s in stats):
            self._refuse("batch norm statistics must be compile-time "
                         "constants (inference-mode norm)")
        scale, bias, mean, var = (np.asarray(s) for s in stats)
        return self.node(
            "norm", "norm", [x], {"eps": float(eps)},
            {"scale": scale, "bias": bias, "mean": mean, "var": var},
            self.shape(x))

    def gcv_knn_graph(self, n, a):
        x, mask = a["x"], a["mask"]
        if _is_const(x):
            self._refuse("knn_graph over constant points")
        inputs = [x]
        if mask is not None:
            if _is_const(mask):
                self._refuse("knn_graph with a constant mask is not "
                             "supported (the mask is a runtime validity "
                             "input)")
            inputs.append(mask)
        return self.node(
            "knn", "knn_graph", inputs,
            {"k": int(a["k"]), "self_loops": bool(a["self_loops"]),
             "masked": mask is not None}, {}, self._out(n)[0], torch.int32)

    def gcv_segment_softmax(self, n, a):
        x, seg = a["x"], a["seg"]
        if _is_const(x):
            self._refuse("segment softmax over constant scores")
        if not _is_const(seg):
            self._refuse("segment softmax ids must be static (the GAT "
                         "neighborhood structure is compile-time graph "
                         "connectivity)")
        return self.node(
            "softmax", "softmax", [x],
            {"segments": True, "num_segments": int(a["n"])},
            {"segments": np.asarray(seg, np.int32)}, self._out(n)[0])

    # ---- compute ----------------------------------------------------------
    def _pads_of(self, x, value):
        """``(source, spatial pads)`` for a conv or pool input: a folded
        ``constant_pad_nd`` that pads only the last two axes with
        ``value`` is peeled, else the input as it is with no pads."""
        pad = self.tg.nodes.get(x) if isinstance(x, str) else None
        if pad is None or pad.op != "pad":
            return x, ((0, 0), (0, 0))
        pads = pad.params["pads"]
        if any(p != (0, 0) for p in pads[:-2]) or pad.params["value"] \
                != value:
            self._refuse(f"padding {pads} with value "
                         f"{pad.params['value']} before this op folds into "
                         f"neither SAME nor VALID")
        return pad.inputs[0], pads[-2:]

    @staticmethod
    def _add_pads(a, b):
        return tuple((int(x[0]) + int(y[0]), int(x[1]) + int(y[1]))
                     for x, y in zip(a, b))

    def a_convolution(self, n, a):
        x, w = a["input"], a["weight"]
        if not _is_const(w):
            self._refuse("a traced conv kernel is not supported (kernels "
                         "must be compile-time weights)")
        if _is_const(x):
            self._refuse("conv over a constant input")
        if a["transposed"] or any(a["output_padding"]):
            self._refuse("transposed convolution is not supported")
        if len(self.shape(x)) != 4:
            self._refuse("only 2-D convolutions on NCHW activations are "
                         "supported")
        src, pads = self._pads_of(x, 0.0)
        pads = self._add_pads(pads, [(p, p) for p in a["padding"]])
        groups = int(a["groups"])
        dilation = tuple(int(d) for d in a["dilation"])
        stride = tuple(int(s) for s in a["stride"])
        # OIHW -> HWIO (the builder's (k1, k2, c_in, c_out) convention;
        # grouped convs keep c_in as the per-group input channels)
        w = np.asarray(w).transpose(2, 3, 1, 0)
        k1, k2 = w.shape[:2]
        ke = ((k1 - 1) * dilation[0] + 1, (k2 - 1) * dilation[1] + 1)
        sizes = self.shape(src)[-2:]
        if pads == _same_padding(sizes, ke, stride):
            padding = "SAME"
        elif pads == ((0, 0), (0, 0)):
            padding = "VALID"
        else:
            self._refuse(f"explicit padding {pads} maps to neither SAME "
                         f"nor VALID (SAME pads "
                         f"{_same_padding(sizes, ke, stride)} here: pad "
                         f"with F.pad and convolve with padding=0)")
        params = {"stride": stride, "padding": padding}
        if groups != 1:
            params["groups"] = groups
        if dilation != (1, 1):
            params["dilation"] = dilation
        weights = {"w": np.ascontiguousarray(w)}
        if a["bias"] is not None:
            if not _is_const(a["bias"]):
                self._refuse("a traced conv bias is not supported")
            weights["b"] = np.asarray(a["bias"])
        return self.node("conv", "conv", [src], params, weights,
                         self._out(n)[0])

    def _dot(self, n, lhs, rhs, shape):
        return self.node("dot", "dot", [lhs, rhs],
                         {"lc": len(self.shape(lhs)) - 1, "rc": 0}, {},
                         shape)

    def a_mm(self, n, a):
        return self._dot(n, a["self"], a["mat2"], self._out(n)[0])

    def a_mv(self, n, a):
        return self._dot(n, a["self"], a["vec"], self._out(n)[0])

    def a_addmm(self, n, a):
        if a["beta"] != 1 or a["alpha"] != 1:
            self._refuse("addmm with beta/alpha other than 1")
        shape = self._out(n)[0]
        dot = self._dot(n, a["mat1"], a["mat2"], shape)
        return self._binop("add", [dot, a["self"]], shape)

    # ---- pooling / reductions ---------------------------------------------
    def _pool(self, n, a, op, value):
        x = a["self"]
        if a.get("ceil_mode"):
            self._refuse("ceil_mode pooling is not supported")
        if any(int(d) != 1 for d in a.get("dilation") or (1,)):
            self._refuse("dilated pooling is not supported")
        k1, k2 = (list(a["kernel_size"]) * 2)[:2]
        stride = a["stride"] or a["kernel_size"]
        s1, s2 = (list(stride) * 2)[:2]
        padding = (list(a["padding"]) * 2)[:2]
        if op == "avg" and any(padding) and not a["count_include_pad"]:
            self._refuse("average pooling with count_include_pad=False")
        src, pads = self._pads_of(x, value)
        pads = self._add_pads(pads, [(p, p) for p in padding])
        sizes = self.shape(src)[-2:]
        if pads != _same_padding(sizes, (k1, k2), (s1, s2)):
            self._refuse(f"pool padding {pads} is not SAME (SAME pads "
                         f"{_same_padding(sizes, (k1, k2), (s1, s2))} here)")
        # square pools keep the builder's scalar spelling
        window = k1 if k1 == k2 else (k1, k2)
        stride = s1 if s1 == s2 else (s1, s2)
        val = n.meta["val"]
        val = val[0] if isinstance(val, (tuple, list)) else val
        return self.node("pool", "pool", [src],
                         {"window": window, "stride": stride, "pool": op},
                         {}, tuple(val.shape))

    def a_max_pool2d_with_indices(self, n, a):
        def make(idx, g):
            if idx != 0:
                self._refuse("max pooling indices are not supported")
            return self._pool(n, a, "max", float("-inf"))
        return _Multi(self._label, make)

    def a_avg_pool2d(self, n, a):
        if a.get("divisor_override") is not None:
            self._refuse("avg pooling with divisor_override")
        return self._pool(n, a, "avg", 0.0)

    def _reduce(self, x, op, dims, keepdim):
        in_shape = self.shape(x)
        rank = len(in_shape)
        axes = tuple(range(rank)) if not dims else \
            tuple(sorted(int(d) % rank for d in dims))
        kept = [i for i in range(rank) if i not in axes]
        out = self.node("reduce", "reduce", [x],
                        {"op": op, "axes": axes, "in_shape": in_shape}, {},
                        tuple(in_shape[i] for i in kept))
        if not keepdim:
            return out
        return self.node("bcast", "bcast", [out],
                         {"shape": tuple(1 if i in axes else in_shape[i]
                                         for i in range(rank)),
                          "dims": tuple(kept)}, {},
                         tuple(1 if i in axes else in_shape[i]
                               for i in range(rank)))

    def a_sum(self, n, a):
        if a.get("dtype") is not None:
            self._refuse("sum with a dtype is not supported")
        return self._reduce(a["self"], "sum", a.get("dim"),
                            a.get("keepdim", False))

    def a_mean(self, n, a):
        if a.get("dtype") is not None:
            self._refuse("mean with a dtype is not supported")
        return self._reduce(a["self"], "avg", a.get("dim"),
                            a.get("keepdim", False))

    def a_amax(self, n, a):
        return self._reduce(a["self"], "max", a["dim"], a["keepdim"])

    def a_max(self, n, a):
        if "dim" not in a:                   # max over every element
            if "other" in a:
                return self._binop("max", [a["self"], a["other"]],
                                   self._out(n)[0])
            return self._reduce(a["self"], "max", None, False)

        def make(idx, g):
            if idx != 0:
                self._refuse("the indices of a max are not supported")
            return self._reduce(a["self"], "max", [a["dim"]], a["keepdim"])
        return _Multi(self._label, make)

    # ---- elementwise ------------------------------------------------------
    def _binop(self, fn, operands, shape):
        """An ``ew`` node; a traced operand of lower rank is promoted by a
        ``bcast`` node first, as jnp's rank promotion spells it."""
        rank = len(shape)
        ins = []
        for x in operands:
            if isinstance(x, str) and len(self.shape(x)) < rank:
                s = self.shape(x)
                lead = rank - len(s)
                x = self.node("bcast", "bcast", [x],
                              {"shape": (1,) * lead + s,
                               "dims": tuple(range(lead, rank))}, {},
                              (1,) * lead + s)
            elif not isinstance(x, str):
                x = np.asarray(x, dtype=np.float32
                               if isinstance(x, float) else None)
            ins.append(x)
        return self.node("ew", "ew", ins, {"fn": fn}, {}, shape)

    def _alpha_one(self, a):
        if a.get("alpha", 1) != 1:
            self._refuse("alpha other than 1 is not supported")

    def a_add(self, n, a):
        self._alpha_one(a)
        return self._binop("add", [a["self"], a["other"]], self._out(n)[0])

    def a_sub(self, n, a):
        self._alpha_one(a)
        return self._binop("sub", [a["self"], a["other"]], self._out(n)[0])

    def a_rsub(self, n, a):
        self._alpha_one(a)
        return self._binop("sub", [a["other"], a["self"]], self._out(n)[0])

    def a_mul(self, n, a):
        return self._binop("mul", [a["self"], a["other"]], self._out(n)[0])

    def a_div(self, n, a):
        if a.get("rounding_mode") is not None:
            self._refuse("rounded division is not supported")
        return self._binop("div", [a["self"], a["other"]], self._out(n)[0])

    def a_maximum(self, n, a):
        return self._binop("max", [a["self"], a["other"]], self._out(n)[0])

    def a_minimum(self, n, a):
        return self._binop("min", [a["self"], a["other"]], self._out(n)[0])

    def a_relu(self, n, a):
        return self._binop("max", [a["self"], np.float32(0.0)],
                           self._out(n)[0])

    def a_leaky_relu(self, n, a):
        # the runtime's default slope; another slope rides an 'alpha' attr
        slope = float(a["negative_slope"])
        params = {"fn": "leaky_relu"}
        if abs(slope - LEAKY_SLOPE) > 1e-6:
            params["alpha"] = slope
        return self.node("act", "act", [a["self"]], params, {},
                         self._out(n)[0])

    def _unop(self, n, a, fn):
        return self.node("ew1", "ew1", [a["self"]], {"fn": fn}, {},
                         self._out(n)[0])

    def a_exp(self, n, a):
        return self._unop(n, a, "exp")

    def a_neg(self, n, a):
        return self._unop(n, a, "neg")

    def a_tanh(self, n, a):
        return self._unop(n, a, "tanh")

    def a_sigmoid(self, n, a):
        return self._unop(n, a, "sigmoid")

    def a__softmax(self, n, a):
        x = a["self"]
        return self.node("softmax", "softmax", [x],
                         {"axis": int(a["dim"]) % len(self.shape(x))}, {},
                         self._out(n)[0])

    # comparisons + where surface only as pattern members (leaky relu,
    # masked softmax); a leftover one raises at emission
    def _cmp(self, n, a, fn):
        other = a["other"]
        if not isinstance(other, str):
            other = np.asarray(other, np.float32)
        return self.node("cmp", "cmp", [a["self"], other], {"fn": fn}, {},
                         self._out(n)[0], torch.bool)

    def a_ge(self, n, a):
        return self._cmp(n, a, "ge")

    def a_gt(self, n, a):
        return self._cmp(n, a, "gt")

    def a_where(self, n, a):
        # jaxpr's select_n(pred, on_false, on_true) operand order
        def atom(v):
            return v if isinstance(v, str) else np.asarray(
                v, np.float32 if isinstance(v, float) else None)
        return self.node("select", "select",
                         [atom(a["condition"]), atom(a["other"]),
                          atom(a["self"])], {}, {}, self._out(n)[0])

    # ---- batch norm modules (channels on axis 1 of (N, F) / NCHW) ---------
    def _bn_module(self, n, a):
        x = a["input"]
        rank = len(self.shape(x))
        if rank not in (2, 4):
            self._refuse(f"F.batch_norm on a rank-{rank} tensor: use "
                         f"frontend.nn.batch_norm (channels on axis 0 of a "
                         f"per-sample (C, H, W) map)")
        if a.get("training"):
            self._refuse("batch norm in training mode")
        c = self.shape(x)[1]
        w = a["weight"] if a["weight"] is not None else np.ones(c,
                                                                np.float32)
        b = a["bias"] if a["bias"] is not None else np.zeros(c, np.float32)
        return self._norm(n, x, [w, b, a["running_mean"], a["running_var"]],
                          a["eps"])

    def a__native_batch_norm_legit_no_training(self, n, a):
        return _Multi(self._label,
                      lambda idx, g: self._bn_module(n, a) if idx == 0
                      else self._refuse("batch norm statistics outputs"))

    def a_native_batch_norm(self, n, a):
        return self.a__native_batch_norm_legit_no_training(n, a)

    # ---- selection (the KNN-graph idiom members) ---------------------------
    def a_sort(self, n, a):
        x = a["self"]
        rank = len(self.shape(x))
        if not a.get("stable"):
            self._refuse("an unstable sort is not supported; the KNN idiom "
                         "needs torch.argsort(d, dim=1, stable=True)")
        if a["descending"]:
            self._refuse("a descending sort is not supported")
        dim = int(a["dim"]) % rank
        return _Multi(self._label, lambda idx, g: self.node(
            "sort", "sort", [x],
            {"dimension": dim, "out": ("keys", "perm")[idx]}, {},
            tuple(g.meta["val"].shape)))

    def a_topk(self, n, a):
        x = a["self"]
        rank = len(self.shape(x))
        if int(a["dim"]) % rank != rank - 1 or not a["largest"] \
                or not a["sorted"]:
            self._refuse("topk is supported only as the sorted, largest "
                         "top-k over the last axis (the KNN idiom "
                         "torch.topk(-d, k))")
        return _Multi(self._label, lambda idx, g: self.node(
            "topk", "top_k", [x],
            {"k": int(a["k"]), "out": ("values", "indices")[idx]}, {},
            tuple(g.meta["val"].shape)))

    def a_slice(self, n, a):
        x = a["self"]
        shape = self.shape(x)
        dim = int(a["dim"]) % len(shape)
        size = shape[dim]
        start = 0 if a["start"] is None else int(a["start"])
        end = size if a["end"] is None else int(a["end"])
        start = max(start + size if start < 0 else start, 0)
        end = min(end + size if end < 0 else end, size)
        step = int(a["step"])
        if (start, end, step) == (0, size, 1):
            return x
        lo = [0] * len(shape)
        hi = list(shape)
        lo[dim], hi[dim] = start, end
        strides = None
        if step != 1:
            strides = [1] * len(shape)
            strides[dim] = step
            strides = tuple(strides)
        return self.node("slice", "slice", [x],
                         {"start": tuple(lo), "limit": tuple(hi),
                          "strides": strides}, {}, self._out(n)[0])

    # ---- layout -----------------------------------------------------------
    def _reshape(self, n, a):
        return self.node("reshape", "reshape", [a["self"]],
                         {"shape": self._out(n)[0]}, {}, self._out(n)[0])

    a_view = a__unsafe_view = _reshape
    a_squeeze = a_squeeze_ = _reshape

    def a_select(self, n, a):
        x = a["self"]
        dim = int(a["dim"]) % len(self.shape(x))
        if self.shape(x)[dim] != 1:
            self._refuse(f"indexing one entry of axis {dim} (size "
                         f"{self.shape(x)[dim]}) is not supported; only "
                         f"dropping a size-1 axis is")
        return self._reshape(n, a)

    def _bcast(self, n, a):
        x = a["self"]
        out = self._out(n)[0]
        s = self.shape(x)
        if out == s:
            return x
        if len(out) == len(s) + 1 and n.target.overloadpacket in (
                torch.ops.aten.unsqueeze, torch.ops.aten.unsqueeze_):
            d = int(a["dim"]) % len(out)
            dims = tuple(i for i in range(len(out)) if i != d)
        else:
            dims = tuple(range(len(out) - len(s), len(out)))
        return self.node("bcast", "bcast", [x],
                         {"shape": out, "dims": dims}, {}, out)

    a_unsqueeze = a_unsqueeze_ = a_expand = _bcast

    def a_permute(self, n, a):
        return self.node("transpose", "transpose", [a["self"]],
                         {"perm": tuple(int(p) % len(self.shape(a["self"]))
                                        for p in a["dims"])}, {},
                         self._out(n)[0])

    def a_t(self, n, a):
        x = a["self"]
        if len(self.shape(x)) < 2:
            return x
        return self.node("transpose", "transpose", [x], {"perm": (1, 0)},
                         {}, self._out(n)[0])

    def a_transpose(self, n, a):
        x = a["self"]
        rank = len(self.shape(x))
        perm = list(range(rank))
        d0, d1 = int(a["dim0"]) % rank, int(a["dim1"]) % rank
        perm[d0], perm[d1] = perm[d1], perm[d0]
        return self.node("transpose", "transpose", [x],
                         {"perm": tuple(perm)}, {}, self._out(n)[0])

    def a_cat(self, n, a):
        xs = list(a["tensors"])
        if any(_is_const(x) for x in xs):
            self._refuse("concatenation with constant operands is not "
                         "supported")
        rank = len(self._out(n)[0])
        return self.node("concat", "concat", xs,
                         {"axis": int(a["dim"]) % rank}, {},
                         self._out(n)[0])

    def a_constant_pad_nd(self, n, a):
        x = a["self"]
        rank = len(self.shape(x))
        flat = [int(p) for p in a["pad"]]
        # torch lists (before, after) pairs from the last axis backwards
        pairs = [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]
        pads = [(0, 0)] * (rank - len(pairs)) + pairs[::-1]
        if any(lo < 0 or hi < 0 for lo, hi in pads):
            self._refuse(f"negative padding {tuple(pads)} (cropping) is not "
                         f"supported")
        return self.node("pad", "pad", [x],
                         {"pads": tuple(pads), "value": float(a["value"])},
                         {}, self._out(n)[0])


def _example_tensor(v) -> torch.Tensor:
    """Zeros on the host standing in for one example input (a tensor or an
    array: only its shape and dtype are read, so a CUDA example traces
    beside the host's constants; float64 becomes float32, the runner's
    rule)."""
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    dtype = torch.float32 if t.dtype == torch.float64 else t.dtype
    return torch.zeros(tuple(t.shape), dtype=dtype)


def trace_model(fn, example_inputs: Mapping[str, Any], *,
                name: str = "traced") -> TraceGraph:
    """Trace a plain torch callable (or an ``nn.Module`` in eval mode) into
    a ``TraceGraph`` of proto-layers.

    ``fn`` is called as ``fn(**example_inputs)``; each entry (a tensor or
    a numpy array) becomes one named graph input — only its shape and
    dtype are read.  Weights must be
    *closed over* (or be the module's parameters and buffers): they
    surface as constants and are resolved into layer weights.  Returns the
    proto graph; ``frontend.canonicalize`` turns it into a compilable
    ``Graph``.
    """
    with obs.span("frontend.trace", cat="compile", model=name,
                  inputs=len(example_inputs)) as sp:
        tg = _trace_model(fn, example_inputs, name=name)
        sp.set(nodes=len(tg.nodes))
        return tg


def _trace_model(fn, example_inputs: Mapping[str, Any], *,
                 name: str) -> TraceGraph:
    from torch.fx.experimental.proxy_tensor import make_fx
    if isinstance(fn, torch.nn.Module) and fn.training:
        raise ValueError(
            f"{type(fn).__name__} is in training mode; the compiler "
            f"compiles inference: call .eval() first")
    names = list(example_inputs)
    examples = [_example_tensor(v) for v in example_inputs.values()]

    def positional(*args):
        return fn(**dict(zip(names, args)))

    with torch.no_grad():
        gm = make_fx(positional, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*examples)
    return _Interpreter(gm, name).run(names)
