"""Tracing frontend, stage 2: proto-layer rewrites -> ``Graph`` IR.

Port of ``src/repro/frontend/canonicalize.py``, kept as close to a copy as
the vocabulary allows: the interpreter (``trace.py``) spells broadcasts,
``keepdim`` reductions and selects as jaxpr does, so the reference's
matchers read the aten trace unchanged.  What differs: ``fold_vector_dot``
(torch spells ``v @ W`` on a vector as ``unsqueeze -> mm -> squeeze``),
pools and mean reductions arrive as ``pool`` / ``reduce avg`` nodes
directly (no ``reduce_window_sum / k**2`` chain), and refusals name the aten
op a leftover node came from.

Tracing shreds layer-level structure into aten soup; this pass reassembles
exactly the idioms the layer vocabulary names, so the six-pass compiler
sees the same graphs the declarative ``GraphBuilder`` produces and Step-1
fusion / Step-4 sparsity mapping fire unchanged:

  * ``exp(x - max(x)) / sum(exp(..))`` chains  -> one ``softmax`` layer;
  * ``select(mask, -inf, x) .. softmax .. select(mask, 0, s)`` (the
    ``torch.where`` masking idiom)             -> one *masked* softmax;
  * ``max(x, 0)`` / ``tanh`` / ``sigmoid``     -> ``act`` layers;
  * ``select(x >= 0, a*x, x)``                 -> ``leaky_relu`` act layers;
  * ``add(conv|linear, const-vector)``         -> folded bias weights;
  * ``reduce_sum / n``                         -> mean reductions;
  * spatial reductions                         -> ``globalpool`` layers;
  * ``mm`` -> ``linear`` (const rhs), dense ``mp`` (const lhs),
    ``vip`` (``x @ x.T``), or runtime ``matmul``;
  * ``reshape(C·T,V) @ adjᵀ -> reshape(C,T,V)`` (static adjacency on the
    *right* operand — ST-GCN's layout)         -> a dense ``mp`` layer on
    the 3-D feature tensor, matching the builder's ``(C·T,V) @ Aᵀ`` MatOp;
  * ``x[None] -> conv -> [0]`` rank-4 wrappers around per-sample 3-D
    feature maps                               -> convs on ``(C, H, W)``;
  * ``reshape``/``transpose`` chains between the CNN ``(C, H, W)`` and GNN
    ``(N, F)`` layouts -> ``dm`` layers, so Step-1 DM fusion still applies.

Anything left over that has no layer equivalent raises
``UnsupportedOpError`` naming the aten op it came from.
"""
from __future__ import annotations

import numpy as np

from repro_torch import obs
from repro_torch.core.ir import Graph, Layer
# The runtime's default leaky_relu slope.  A traced pattern whose slope
# differs carries it as an 'alpha' attr, which Step-1 act fusion and
# lowering thread through to the runtime epilogue — any slope compiles.
from repro_torch.core.runtime.elementwise import LEAKY_SLOPE as _LEAKY_SLOPE
from repro_torch.frontend.trace import (TraceGraph, TraceNode,
                                        UnsupportedOpError)

_VIEW_OPS = frozenset({"bcast", "reshape"})
_PORTION_DEFAULT = {"conv": "cnn", "pool": "cnn", "mp": "gnn",
                    "vip": "gnn", "knn_graph": "gnn", "dm": "dm"}


def _is_const(atom) -> bool:
    return not isinstance(atom, str)


def _scalar(atom):
    """The python float of a size-1 constant, else None."""
    if _is_const(atom) and np.size(atom) == 1:
        return float(np.asarray(atom).reshape(()))
    return None


class _Rewriter:
    def __init__(self, tg: TraceGraph):
        self.tg = tg
        self.alias: dict[str, str] = {}
        self.dead: set[str] = set()

    # ---- plumbing ---------------------------------------------------------
    def resolve(self, ref):
        while isinstance(ref, str) and ref in self.alias:
            ref = self.alias[ref]
        return ref

    def flush(self) -> None:
        """Apply aliases to every live node and drop dead nodes."""
        for name in self.dead:
            self.tg.nodes.pop(name, None)
        self.dead.clear()
        for node in self.tg.nodes.values():
            node.inputs = [self.resolve(i) for i in node.inputs]
        self.tg.output_names = [self.resolve(o)
                                for o in self.tg.output_names]
        self.alias.clear()

    def consumers(self) -> dict[str, list[str]]:
        cons: dict[str, list[str]] = {n: [] for n in self.tg.nodes}
        for node in self.tg.nodes.values():
            for ref in node.refs():
                cons[ref].append(node.name)
        for o in self.tg.output_names:
            cons[o].append("<output>")
        return cons

    def node(self, ref) -> TraceNode | None:
        return self.tg.nodes.get(ref) if isinstance(ref, str) else None

    def absorb(self, into: TraceNode, *names: str) -> None:
        """Fold the aten provenance of pattern partners (about to die)
        into the surviving node, so ``frontend.lint`` can show every aten
        node a canonical layer was recovered from."""
        for n in names:
            partner = self.tg.nodes.get(n)
            if partner is not None and partner is not into:
                into.src.extend(partner.src)

    def _peel_views(self, ref, cons):
        """Follow single-consumer bcast/reshape nodes upward; returns the
        root ref and the list of peeled view-node names."""
        chain = []
        node = self.node(ref)
        while node is not None and node.op in _VIEW_OPS \
                and len(cons[node.name]) == 1:
            chain.append(node.name)
            ref = node.inputs[0]
            node = self.node(ref)
        return ref, chain

    # ---- passes -----------------------------------------------------------
    def drop_reduce_guards(self) -> None:
        """``torch.maximum(r, -inf)`` / ``minimum(r, inf)`` guards around
        reductions (jnp.max inserts them) — identities for our
        purposes."""
        for node in list(self.tg.nodes.values()):
            if node.op != "ew" or node.params["fn"] not in ("max", "min"):
                continue
            want = -np.inf if node.params["fn"] == "max" else np.inf
            consts = [a for a in node.inputs if _scalar(a) == want]
            refs = node.refs()
            if consts and len(refs) == 1:
                target = self.node(refs[0])
                if target is not None:
                    self.absorb(target, node.name)
                self.alias[node.name] = refs[0]
                self.dead.add(node.name)
        self.flush()

    def match_softmax(self) -> None:
        cons = self.consumers()
        for div in list(self.tg.nodes.values()):
            if div.op != "ew" or div.params["fn"] != "div":
                continue
            num, den = div.inputs
            exp = self.node(num)
            if exp is None or exp.op != "ew1" \
                    or exp.params["fn"] != "exp":
                continue
            root, chain = self._peel_views(den, cons)
            s = self.node(root)
            if s is None or s.op != "reduce" or s.params["op"] != "sum" \
                    or s.inputs[0] != num or len(s.params["axes"]) != 1 \
                    or len(cons[s.name]) != 1:
                continue
            if sorted(cons[exp.name]) != sorted([div.name, s.name]):
                continue
            axis = s.params["axes"][0]
            head, extra_dead = exp.inputs[0], []
            sub = self.node(head)
            if sub is not None and sub.op == "ew" \
                    and sub.params["fn"] == "sub" \
                    and cons[sub.name] == [exp.name] \
                    and isinstance(sub.inputs[1], str):
                mroot, mchain = self._peel_views(sub.inputs[1], cons)
                m = self.node(mroot)
                if m is not None and m.op == "reduce" \
                        and m.params["op"] == "max" \
                        and tuple(m.params["axes"]) == (axis,) \
                        and m.inputs[0] == sub.inputs[0] \
                        and len(cons[m.name]) == 1:
                    head = sub.inputs[0]
                    extra_dead = [sub.name, m.name, *mchain]
            div.op, div.inputs = "softmax", [head]
            div.params = {"axis": axis}
            self.absorb(div, exp.name, s.name, *chain, *extra_dead)
            self.dead.update([exp.name, s.name, *chain, *extra_dead])
        self.flush()

    def match_means(self) -> None:
        """``reduce_sum / n`` -> mean reduction (``mean`` itself arrives
        as a ``reduce avg`` node)."""
        cons = self.consumers()
        for div in list(self.tg.nodes.values()):
            if div.op != "ew" or div.params["fn"] != "div":
                continue
            ref, scale = div.inputs
            n = _scalar(scale)
            src = self.node(ref)
            if n is None or src is None or len(cons[src.name]) != 1:
                continue
            if src.op == "reduce" and src.params["op"] == "sum":
                count = int(np.prod([src.params["in_shape"][a]
                                     for a in src.params["axes"]]))
                if count == n:
                    div.op = "reduce"
                    div.inputs = [src.inputs[0]]
                    div.params = {"op": "avg", "axes": src.params["axes"],
                                  "in_shape": src.params["in_shape"]}
                    self.absorb(div, src.name)
                    self.dead.add(src.name)
        self.flush()

    def match_acts(self) -> None:
        for node in list(self.tg.nodes.values()):
            if node.op == "ew1" and node.params["fn"] in ("tanh", "sigmoid"):
                node.op, node.params = "act", {"fn": node.params["fn"]}
                continue
            if node.op != "ew" or node.params["fn"] != "max":
                continue
            refs = node.refs()
            consts = [a for a in node.inputs if _is_const(a)]
            if len(refs) == 1 and len(consts) == 1 \
                    and not np.any(np.asarray(consts[0])):
                node.op, node.inputs = "act", refs
                node.params = {"fn": "relu"}
        self.flush()

    def match_leaky_relu(self) -> None:
        """``where(x >= 0, x, slope * x)`` — leaky relu written out
        (``F.leaky_relu`` itself arrives as an ``act`` node) — becomes a
        ``leaky_relu`` act layer."""
        cons = self.consumers()
        for sel in list(self.tg.nodes.values()):
            if sel.op != "select" or len(sel.inputs) != 3:
                continue
            pred, on_neg, on_pos = sel.inputs
            cmp = self.node(pred)
            if cmp is None or cmp.op != "cmp" \
                    or cmp.params["fn"] not in ("ge", "gt") \
                    or not isinstance(cmp.inputs[0], str) \
                    or _scalar(cmp.inputs[1]) != 0.0:
                continue
            x = cmp.inputs[0]
            if on_pos != x:
                continue
            mul = self.node(on_neg)
            if mul is None or mul.op != "ew" or mul.params["fn"] != "mul" \
                    or mul.refs() != [x]:
                continue
            slopes = [_scalar(a) for a in mul.inputs if _is_const(a)]
            if len(slopes) != 1 or slopes[0] is None:
                continue
            if len(cons[cmp.name]) != 1 or len(cons[mul.name]) != 1:
                continue
            # carry the traced slope as an 'alpha' attr so Step-1 act
            # fusion and lowering preserve non-default slopes (the runtime
            # epilogue reads it; absent alpha means the 0.2 default)
            params = {"fn": "leaky_relu"}
            if abs(slopes[0] - _LEAKY_SLOPE) > 1e-6:
                params["alpha"] = slopes[0]
            sel.op, sel.inputs, sel.params = "act", [x], params
            self.absorb(sel, cmp.name, mul.name)
            self.dead.update([cmp.name, mul.name])
        self.flush()

    def match_masked_softmax(self) -> None:
        """The ``torch.where`` masking idiom around a (already-matched)
        softmax — ``where(mask, x, -inf)`` in, ``where(mask, s, 0)`` out,
        with one static boolean mask — becomes a single masked-softmax
        layer (GAT-style attention over a fixed neighborhood)."""
        cons = self.consumers()
        for sm in list(self.tg.nodes.values()):
            if sm.op != "softmax" or "axis" not in sm.params:
                continue
            sel_in = self.node(sm.inputs[0])
            if sel_in is None or sel_in.op != "select" \
                    or len(sel_in.inputs) != 3:
                continue
            mask, neg, x = sel_in.inputs
            if not (_is_const(mask) and _is_const(neg)
                    and isinstance(x, str)):
                continue
            mask_arr = np.asarray(mask)
            if mask_arr.dtype != np.bool_ \
                    or not np.all(np.isneginf(np.asarray(neg))):
                continue
            users = cons[sm.name]
            if len(users) != 1 or users[0] == "<output>" \
                    or len(cons[sel_in.name]) != 1:
                continue
            sel_out = self.tg.nodes[users[0]]
            if sel_out.op != "select" or len(sel_out.inputs) != 3:
                continue
            omask, zeros, src = sel_out.inputs
            if src != sm.name or not (_is_const(omask) and _is_const(zeros)):
                continue
            if not np.array_equal(np.asarray(omask), mask_arr) \
                    or np.any(np.asarray(zeros)):
                continue
            sel_out.op, sel_out.inputs = "softmax", [x]
            sel_out.params = {"axis": sm.params["axis"]}
            sel_out.weights = {"mask": mask_arr.astype(np.float32)}
            self.absorb(sel_out, sel_in.name, sm.name)
            self.dead.update([sel_in.name, sm.name])
        self.flush()

    def match_adj_right_mp(self) -> None:
        """Static adjacency on the *right* operand: the raw-torch spelling of
        ST-GCN message passing, ``(x.reshape(C·T, V) @ A.T).reshape(C, T,
        V)``, becomes a dense ``mp`` layer over the 3-D feature tensor —
        the exact ``(C·T,V) @ Aᵀ`` MatOp the builder's ``mp(adj=...)``
        lowers to (the left-operand case, ``adj @ x``, is handled by
        ``match_dots``)."""
        cons = self.consumers()
        for dot in list(self.tg.nodes.values()):
            if dot.op != "dot":
                continue
            lhs, rhs = dot.inputs
            if not _is_const(rhs):
                continue
            m = np.asarray(rhs)
            if m.ndim != 2 or m.shape[0] != m.shape[1]:
                continue
            if (dot.params["lc"], dot.params["rc"]) != (1, 0):
                continue
            r1 = self.node(lhs)
            if r1 is None or r1.op != "reshape" or len(cons[r1.name]) != 1:
                continue
            src = self.node(r1.inputs[0])
            if src is None or len(src.shape) != 3:
                continue
            c, t, v = src.shape
            if v != m.shape[0] or r1.params["shape"] != (c * t, v):
                continue
            users = cons[dot.name]
            if len(users) != 1 or users[0] == "<output>":
                continue
            r2 = self.tg.nodes[users[0]]
            if r2.op != "reshape" or r2.params["shape"] != (c, t, v):
                continue
            r2.op, r2.inputs = "mp", [r1.inputs[0]]
            r2.params = {"mode": "dense", "reduce": "sum"}
            # executed product is x2 @ M, i.e. (C·T,V) @ adjᵀ with adj = Mᵀ
            r2.weights = {"adj": np.ascontiguousarray(m.T)}
            self.absorb(r2, r1.name, dot.name)
            self.dead.update([r1.name, dot.name])
        self.flush()

    def fold_conv_batch1(self) -> None:
        """Per-sample models wrap 3-D ``(C, H, W)`` feature maps to rank 4
        for ``F.conv2d`` (``x[None] -> conv -> [0]``); fold the wrapper
        away so the conv layer consumes the 3-D layout directly — exactly
        the builder's per-sample conv (b2-b5's CNN portions)."""
        cons = self.consumers()
        for conv in list(self.tg.nodes.values()):
            if conv.op != "conv" or len(conv.shape) != 4 \
                    or conv.shape[0] != 1:
                continue
            src = self.node(conv.inputs[0])
            if src is None or src.op not in _VIEW_OPS \
                    or len(cons[src.name]) != 1:
                continue
            inner = self.node(src.inputs[0])
            if inner is None or tuple(src.shape) != (1, *inner.shape):
                continue
            users = cons[conv.name]
            if len(users) != 1 or users[0] == "<output>":
                continue
            sq = self.tg.nodes[users[0]]
            if sq.op != "reshape" or sq.params["shape"] != conv.shape[1:]:
                continue
            conv.inputs[0] = src.inputs[0]
            conv.shape = conv.shape[1:]
            self.absorb(conv, src.name, sq.name)
            self.alias[sq.name] = conv.name
            self.dead.update([src.name, sq.name])
        self.flush()

    def fold_vector_dot(self) -> None:
        """torch spells ``v @ W`` on a vector as ``unsqueeze(v, 0) @ W``
        then a squeeze (``F.linear``: ``view(1, K)``, ``addmm``,
        ``view(N)``); fold the wrapper so the dot contracts the vector
        itself, as jaxpr's ``dot_general`` does, and the linear layer reads
        the ``(K,)`` vector as the builder's does."""
        cons = self.consumers()
        for dot in list(self.tg.nodes.values()):
            if dot.op != "dot" or len(dot.shape) != 2 or dot.shape[0] != 1:
                continue
            view = self.node(dot.inputs[0])
            if view is None or view.op not in _VIEW_OPS \
                    or len(cons[view.name]) != 1:
                continue
            vec = self.node(view.inputs[0])
            if vec is None or len(vec.shape) != 1 \
                    or view.shape != (1, vec.shape[0]):
                continue
            n = dot.shape[1]
            chain, users = [dot], cons[dot.name]
            if len(users) == 1 and users[0] != "<output>":
                add = self.tg.nodes[users[0]]
                consts = [a for a in add.inputs if _is_const(a)]
                if add.op == "ew" and add.params["fn"] == "add" \
                        and add.refs() == [dot.name] and len(consts) == 1 \
                        and np.shape(consts[0]) in ((n,), (1, n)):
                    add.inputs = [np.asarray(a).reshape(n) if _is_const(a)
                                  else a for a in add.inputs]
                    chain.append(add)
                    users = cons[add.name]
            if len(users) != 1 or users[0] == "<output>":
                continue
            sq = self.tg.nodes[users[0]]
            if sq.op != "reshape" or sq.params["shape"] != (n,):
                continue
            dot.inputs[0] = vec.name
            dot.params = {**dot.params, "lc": 0}
            for node in chain:
                node.shape = (n,)
            self.absorb(dot, view.name)
            self.absorb(chain[-1], sq.name)
            self.alias[sq.name] = chain[-1].name
            self.dead.update([view.name, sq.name])
        self.flush()

    def match_dots(self) -> None:
        cons = self.consumers()
        for node in list(self.tg.nodes.values()):
            if node.op != "dot":
                continue
            lhs, rhs = node.inputs
            lc, rc = node.params["lc"], node.params["rc"]
            if _is_const(rhs):
                w = np.asarray(rhs)
                if w.ndim != 2 or lc != len(self.node(lhs).shape) - 1:
                    raise UnsupportedOpError(
                        f"{_label(node)} with weight shape {w.shape} "
                        f"contracting dims ({lc}, {rc}) does not map to a "
                        f"linear layer")
                node.op, node.inputs, node.params = "linear", [lhs], {}
                node.weights = {"w": w if rc == 0 else w.T}
            elif _is_const(lhs):
                a = np.asarray(lhs)
                if a.ndim != 2 or (lc, rc) != (1, 0) \
                        or len(self.node(rhs).shape) != 2:
                    raise UnsupportedOpError(
                        f"{_label(node)} with constant lhs shape {a.shape} "
                        f"does not map to dense message passing")
                node.op, node.inputs = "mp", [rhs]
                node.params = {"mode": "dense", "reduce": "sum"}
                node.weights = {"adj": a}
            else:
                t = self.node(rhs)
                if t is not None and t.op == "transpose" \
                        and t.params["perm"] == (1, 0) \
                        and t.inputs[0] == lhs and (lc, rc) == (1, 0) \
                        and cons[t.name] == [node.name]:
                    node.op, node.inputs = "vip", [lhs]
                    node.params = {"mode": "dense"}
                    self.absorb(node, t.name)
                    self.dead.add(t.name)
                elif lc == len(self.node(lhs).shape) - 1 and rc == 0:
                    node.op, node.params = "matmul", {}
                else:
                    raise UnsupportedOpError(
                        f"{_label(node)} contracting dims ({lc}, {rc}) "
                        f"with two traced operands does not map to a "
                        f"matmul layer")
        self.flush()

    def fold_biases(self) -> None:
        cons = self.consumers()
        for node in list(self.tg.nodes.values()):
            if node.op != "ew" or node.params["fn"] != "add":
                continue
            refs = node.refs()
            consts = [a for a in node.inputs if _is_const(a)]
            if len(refs) != 1 or len(consts) != 1:
                continue
            prod = self.node(refs[0])
            if prod is None or prod.op not in ("conv", "linear") \
                    or "b" in prod.weights or cons[prod.name] != [node.name]:
                continue
            chan_axis = -3 if prod.op == "conv" else -1
            chan = prod.shape[chan_axis]
            cs = np.asarray(consts[0]).shape
            padded = (1,) * (len(prod.shape) - len(cs)) + cs
            if len(padded) != len(prod.shape) or padded[chan_axis] != chan \
                    or any(d != 1 for i, d in enumerate(padded)
                           if i != len(padded) + chan_axis):
                continue
            prod.weights["b"] = np.asarray(consts[0]).reshape(chan)
            self.absorb(prod, node.name)
            self.alias[node.name] = prod.name
            self.dead.add(node.name)
        self.flush()

    def match_dm(self) -> None:
        cons = self.consumers()
        for node in list(self.tg.nodes.values()):
            if node.name in self.dead:
                continue
            if node.op == "reshape":
                src = self.node(node.inputs[0])
                if src is None or len(src.shape) != 3:
                    continue
                c, h, w = src.shape
                if node.params["shape"] != (c, h * w):
                    continue
                users = [self.tg.nodes[u] for u in cons[node.name]
                         if u != "<output>"]
                if len(users) == 1 and users[0].op == "transpose" \
                        and users[0].params["perm"] == (1, 0):
                    t = users[0]
                    t.op, t.inputs = "dm", [node.inputs[0]]
                    t.params = {"mode": "patch_to_node", "patch": 1}
                    self.absorb(t, node.name)
                    self.dead.add(node.name)
                else:
                    node.op = "dm"
                    node.params = {"mode": "channel_to_node", "patch": 1}
            elif node.op == "transpose" and node.params["perm"] == (1, 0):
                src = self.node(node.inputs[0])
                if src is None or len(src.shape) != 2:
                    continue
                n_nodes, f = src.shape
                users = [u for u in cons[node.name] if u != "<output>"]
                if len(users) != 1:
                    continue
                user = self.tg.nodes[users[0]]
                if user.op == "reshape" and len(user.params["shape"]) == 3 \
                        and user.params["shape"][0] == f \
                        and int(np.prod(user.params["shape"][1:])) \
                        == n_nodes:
                    user.op, user.inputs = "dm", [node.inputs[0]]
                    user.params = {"mode": "node_to_channel", "patch": 1,
                                   "hw": tuple(user.params["shape"][1:])}
                    self.absorb(user, node.name)
                    self.dead.add(node.name)
        self.flush()

    def _peel_all_views(self, ref):
        """Follow bcast/reshape nodes upward regardless of fan-out;
        -> (root ref, peeled names)."""
        names = []
        node = self.node(ref)
        while node is not None and node.op in _VIEW_OPS:
            names.append(node.name)
            ref = node.inputs[0]
            node = self.node(ref)
        return ref, names

    def _knn_terms(self, ref, seen: list) -> list:
        """Flatten a +/- expression tree into ``(coefficient, ref)``
        leaves, folding scalar multiplies and negations into the
        coefficient.  ``seen`` collects the traversed node names."""
        out: list = []

        def walk(r, coeff):
            n = self.node(r)
            if n is not None and n.op == "ew" \
                    and n.params["fn"] in ("add", "sub") \
                    and all(isinstance(i, str) for i in n.inputs):
                seen.append(n.name)
                walk(n.inputs[0], coeff)
                walk(n.inputs[1],
                     coeff if n.params["fn"] == "add" else -coeff)
                return
            if n is not None and n.op == "ew1" and n.params["fn"] == "neg":
                seen.append(n.name)
                walk(n.inputs[0], -coeff)
                return
            if n is not None and n.op == "ew" and n.params["fn"] == "mul":
                consts = [a for a in n.inputs if _is_const(a)]
                refs = n.refs()
                c = _scalar(consts[0]) if len(consts) == 1 else None
                if c is not None and len(refs) == 1:
                    seen.append(n.name)
                    out.append((coeff * c, refs[0]))
                    return
            out.append((coeff, r))

        walk(ref, 1.0)
        return out

    def _match_distance(self, ref):
        """-> ``(x, traversed names)`` when ``ref`` computes pairwise
        squared-L2 distances ``|xi|^2 - 2 xi.xj + |xj|^2`` over one traced
        point set ``x``, else None."""
        seen: list[str] = []
        terms = self._knn_terms(ref, seen)
        if len(terms) != 3:
            return None
        xs: set[str] = set()
        rowsq, dot_x = 0, None
        for coeff, r in terms:
            root, names = self._peel_all_views(r)
            n = self.node(root)
            if n is None:
                return None
            if n.op == "vip" and n.params.get("mode") == "dense":
                if coeff != -2.0:
                    return None
                dot_x = n.inputs[0]
                seen.extend([*names, n.name])
            elif n.op == "reduce" and n.params["op"] == "sum" \
                    and tuple(n.params["axes"]) == (1,):
                if coeff != 1.0:
                    return None
                sq = self.node(n.inputs[0])
                if sq is None or sq.op != "ew" \
                        or sq.params["fn"] != "mul" \
                        or not all(isinstance(i, str) for i in sq.inputs) \
                        or len(set(sq.inputs)) != 1:
                    return None
                xs.add(sq.inputs[0])
                rowsq += 1
                seen.extend([*names, n.name, sq.name])
            else:
                return None
        if rowsq != 2 or dot_x is None or xs != {dot_x}:
            return None
        return dot_x, seen

    def match_knn_graph(self) -> None:
        """The raw-torch dynamic-graph idiom: pairwise squared-L2 distances
        ``|xi|^2 - 2 xi.xj + |xj|^2`` consumed by ``torch.topk(-d, k)``
        (k nearest, self included — the diagonal's zero distance wins) or
        a stable ``argsort(d, dim=1)[:, 1:k+1]`` (self excluded) becomes
        one ``knn_graph`` layer — the selection semantics pinned in
        ``kernels/knn.py``.  The distance expression itself dies by DCE
        once its selection consumer is rewritten (runs after
        ``match_dots``, which turns ``x @ x.T`` into the ``vip`` node the
        distance matcher anchors on)."""
        for node in list(self.tg.nodes.values()):
            if node.op == "top_k" and node.params["out"] == "indices":
                neg = self.node(node.inputs[0])
                if neg is None or neg.op != "ew1" \
                        or neg.params["fn"] != "neg":
                    continue
                dist, partners = neg.inputs[0], [neg.name]
                k, self_loops = node.params["k"], True
            elif node.op == "slice":
                src = self.node(node.inputs[0])
                if src is None or src.op != "sort" \
                        or src.params["out"] != "perm" \
                        or src.params["dimension"] != 1:
                    continue
                start, limit = node.params["start"], node.params["limit"]
                if node.params["strides"] not in (None, (1, 1)) \
                        or len(start) != 2 \
                        or (start[0], limit[0]) != (0, src.shape[0]) \
                        or start[1] not in (0, 1):
                    continue
                dist, partners = src.inputs[0], [src.name]
                k, self_loops = limit[1] - start[1], start[1] == 0
            else:
                continue
            m = self._match_distance(dist)
            if m is None:
                continue
            x, seen = m
            node.op, node.inputs = "knn_graph", [x]
            node.params = {"k": int(k), "self_loops": self_loops,
                           "masked": False}
            self.absorb(node, *partners, *seen)
        self.flush()
        self.prune_dead()

    def prune_dead(self) -> None:
        """Drop non-input nodes no consumer or output references —
        pattern remnants whose heads were rewritten away (e.g. the
        distance expression once a ``knn_graph`` layer replaces its
        selection consumer)."""
        changed = True
        while changed:
            changed = False
            cons = self.consumers()
            for name, node in list(self.tg.nodes.items()):
                if node.op != "input" and not cons[name]:
                    self.tg.nodes.pop(name)
                    changed = True

    def match_globalpool(self) -> None:
        spatial = {4: (2, 3), 3: (1, 2), 2: (0,)}
        for node in list(self.tg.nodes.values()):
            if node.op != "reduce" or node.params["op"] not in ("max",
                                                                "avg"):
                continue
            rank = len(node.params["in_shape"])
            if tuple(node.params["axes"]) == spatial.get(rank):
                node.op = "globalpool"
                node.params = {"pool": node.params["op"], "in_rank": rank}
        self.flush()

    def drop_identity_bcasts(self) -> None:
        for node in list(self.tg.nodes.values()):
            if node.op != "bcast":
                continue
            src = self.node(node.inputs[0])
            if src is None:
                continue
            if src.shape == node.params["shape"]:
                self.absorb(src, node.name)
                self.alias[node.name] = node.inputs[0]
                self.dead.add(node.name)
            elif int(np.prod(node.params["shape"])) == \
                    int(np.prod(src.shape)):
                # size-preserving broadcast (axis insertion, e.g. a
                # ``mask[:, None]``) is just a reshape
                node.op = "reshape"
                node.params = {"shape": node.params["shape"]}
        self.flush()


# ---------------------------------------------------------------------------
# emission

def _label(node: TraceNode) -> str:
    """The aten op a proto-node came from (its first provenance entry)."""
    return node.src[0].split(":")[0] if node.src else node.op


_EMIT_UNSUPPORTED = {
    "ew": lambda n: f"elementwise '{_label(n)}'",
    "ew1": lambda n: f"elementwise '{_label(n)}'",
    "reduce": lambda n: f"'{_label(n)}' ({n.params['op']} over axes "
                        f"{n.params['axes']})",
    "bcast": lambda n: f"'{_label(n)}' (a broadcast)",
    "transpose": lambda n: f"'{_label(n)}'",
    "pad": lambda n: f"'{_label(n)}' (padding not folded into a conv or "
                     f"pool)",
    "cmp": lambda n: f"comparison '{_label(n)}' (only the leaky_relu "
                     f"and masked-softmax where patterns are recognized)",
    "select": lambda n: f"'{_label(n)}' (a where that is neither the "
                        f"leaky_relu nor the masked-softmax pattern)",
    "top_k": lambda n: f"'{_label(n)}' (not consuming the pairwise-distance "
                       f"KNN-graph idiom)",
    "sort": lambda n: f"'{_label(n)}' (only the argsort KNN-graph idiom is "
                      f"recognized)",
    "slice": lambda n: f"'{_label(n)}' (only the argsort-slice KNN "
                       f"selection is recognized)",
}


def _emit(tg: TraceGraph) -> Graph:
    g = Graph(tg.name)
    # 'aten_nodes': layer name -> the aten nodes it was recovered from
    # (pattern partners folded in by the rewriter) — frontend.lint's input.
    g.meta = {"frontend": "tracer",
              "aten_nodes": {n.name: tuple(n.src)
                             for n in tg.nodes.values()}}

    def add(node: TraceNode, kind: str, params: dict,
            inputs=None, out_shape=None) -> None:
        params.setdefault("portion", _PORTION_DEFAULT.get(kind, "other"))
        g.layers[node.name] = Layer(
            node.name, kind, tuple(inputs if inputs is not None
                                   else node.refs()),
            params, dict(node.weights), out_shape)

    for node in tg.nodes.values():
        for ref in node.refs():
            if ref not in g.layers:
                raise UnsupportedOpError(
                    f"node {node.name!r} consumes unplaced value {ref!r}")
        if node.op == "input":
            add(node, "input", {"shape": node.shape,
                                "dtype": np.dtype(node.dtype).name},
                out_shape=node.shape)
        elif node.op == "conv":
            cp = {"stride": node.params["stride"],
                  "padding": node.params["padding"]}
            for key in ("groups", "dilation"):   # only present when != 1
                if key in node.params:
                    cp[key] = node.params[key]
            add(node, "conv", cp)
        elif node.op == "linear":
            add(node, "linear", {})
        elif node.op == "mp":
            mode = node.params["mode"]
            if mode == "coo":
                p = {"n": node.params["n"],
                     "reduce": node.params["reduce"]}
                if node.params.get("runtime_edge"):
                    p["runtime_edge"] = True
                add(node, "mp", p)
            elif mode == "dense_runtime":
                add(node, "mp", {"runtime_adj": True, "reduce": "sum"})
            elif mode == "knn":
                add(node, "mp", {"runtime_knn": True,
                                 "reduce": node.params["reduce"]})
            else:
                add(node, "mp", {"reduce": node.params["reduce"]})
        elif node.op == "knn_graph":
            p = {"k": node.params["k"]}
            if node.params.get("self_loops"):
                p["self_loops"] = True
            if node.params.get("masked"):
                p["masked"] = True
            add(node, "knn_graph", p)
        elif node.op == "vip":
            add(node, "vip", {})
        elif node.op == "norm":
            add(node, "norm", {"norm": "batch",
                               "eps": node.params["eps"]})
        elif node.op == "act":
            p = {"fn": node.params["fn"]}
            if "alpha" in node.params:
                p["alpha"] = node.params["alpha"]
            add(node, "act", p)
        elif node.op == "softmax":
            if "segments" in node.weights:
                add(node, "softmax",
                    {"num_segments": node.params["num_segments"]})
            else:
                add(node, "softmax", {"axis": node.params["axis"]})
        elif node.op == "pool":
            add(node, "pool", {"window": node.params["window"],
                               "stride": node.params["stride"],
                               "pool": node.params["pool"]})
        elif node.op == "globalpool":
            add(node, "globalpool", {"pool": node.params["pool"]})
        elif node.op == "dm":
            p = {"mode": node.params["mode"], "patch": node.params["patch"]}
            if "hw" in node.params:
                p["hw"] = node.params["hw"]
            add(node, "dm", p)
        elif node.op == "reshape":
            add(node, "reshape", {"shape": node.params["shape"]})
        elif node.op == "concat":
            add(node, "concat", {"axis": node.params["axis"]})
        elif node.op == "ew" and node.params["fn"] == "add" \
                and len(node.refs()) == 2:
            add(node, "add", {})
        elif node.op == "ew" and node.params["fn"] == "mul" \
                and len(node.refs()) == 2:
            add(node, "mul", {})
        elif node.op == "matmul":
            add(node, "matmul", {})
        else:
            detail = _EMIT_UNSUPPORTED.get(
                node.op, lambda n: f"'{_label(n)}'")(node)
            raise UnsupportedOpError(
                f"traced pattern {detail} (node {node.name!r}, shape "
                f"{node.shape}) has no layer-IR equivalent after "
                f"canonicalization")
    g.mark_output(*tg.output_names)
    return g


def canonicalize(tg: TraceGraph) -> Graph:
    """Rewrite a ``TraceGraph`` into a compilable layer ``Graph``."""
    with obs.span("frontend.canonicalize", cat="compile", model=tg.name,
                  nodes_in=len(tg.nodes)) as sp:
        g = _canonicalize(tg)
        sp.set(layers_out=len(g.layers))
        return g


def _canonicalize(tg: TraceGraph) -> Graph:
    rw = _Rewriter(tg)
    rw.drop_reduce_guards()
    rw.fold_conv_batch1()
    rw.match_softmax()
    rw.match_masked_softmax()     # needs the matched softmax node
    rw.match_means()
    rw.match_leaky_relu()
    rw.match_acts()
    rw.match_adj_right_mp()       # must win over match_dots' linear case
    rw.fold_vector_dot()
    rw.match_dots()
    rw.match_knn_graph()          # needs match_dots' vip anchor
    rw.fold_biases()
    rw.match_dm()
    rw.match_globalpool()
    rw.drop_identity_bcasts()
    return _emit(tg)
