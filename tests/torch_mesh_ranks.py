"""Rank bodies of the port's multi-process CPU tests.

Each function runs on every rank of a 4-rank gloo group spawned by
``tools/ranks.run_ranks`` (``fn(rank, world, *args)``) and returns plain
numpy data.  Nothing here imports JAX: the tests compare what the ranks
return with the reference in their own process, or in a subprocess that
forces host devices.
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from repro_torch import configs
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_process_mesh, mesh_axes
from repro_torch.models.transformer import (init_caches, init_lm,
                                            lm_decode_step, lm_loss)
from repro_torch.models.weights import from_reference, param_shapes
from repro_torch.train import CheckpointManager, adamw, build_train_step

AXES = ("data", "model")


def whole(tree):
    """A tree of tensors (``DTensor``s gathered whole, every rank taking
    part) as numpy, keyed by "/"-joined path."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}" if path else k)
            return
        if col.is_dtensor(t):
            from torch.distributed.tensor import Replicate
            t = t.redistribute(
                placements=[Replicate()] * t.device_mesh.ndim).to_local()
        out[path] = t.detach().cpu().numpy().copy()

    walk(tree, "")
    return out


def cast(tree, dtype):
    """A parameter tree with its floating leaves cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def placed(params, mesh):
    """``params`` placed by the rule table on ``mesh``."""
    dp, model, _ = mesh_axes(mesh)
    specs = shd.param_specs(params, mesh, fsdp=dp, model=model)
    return shd.device_put(params, shd.shardings(specs, mesh)), specs


def moe_cfg(capacity_factor):
    """deepseek-v3's smoke config (8 experts, top-2) at a capacity
    factor."""
    cfg = configs.get_smoke("deepseek-v3-671b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=8, top_k=2, capacity_factor=capacity_factor))


def case_cfg(name, get=configs.get_smoke):
    """A test case's config: an arch's smoke config, deepseek-v3's at
    capacity factor 4.0 (no token dropped), ``"heads10"``: llama's
    with 10 heads of 8 over 2 kv heads, which a 4-way model axis splits
    3, 3, 2, 2 (groups cut unevenly, projections sharded mid-head), or
    ``"heads2"``: llama's with 2 heads of 32 over one kv head, fewer heads
    than a 4-way model axis."""
    if name == "heads10":
        return dataclasses.replace(get("llama3.2-1b"), n_heads=10,
                                   n_kv_heads=2, head_dim=8)
    if name == "heads2":
        return dataclasses.replace(get("llama3.2-1b"), n_heads=2,
                                   n_kv_heads=1, head_dim=32)
    cfg = get(name)
    if name == "deepseek-v3-671b":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=4.0))
    return cfg


# -------------------------------------------------------- test_distributed --
def placements(rank, world, archs, shapes):
    """Each arch's smoke parameters placed on each mesh shape: the local
    block's shape and bytes per leaf path; and what int8 moments on a mesh
    raise."""
    out = {}
    for shape in shapes:
        mesh = make_process_mesh(shape, AXES)
        for arch in archs:
            cfg = configs.get_smoke(arch)
            pp, specs = placed(init_lm(0, cfg, device="cpu"), mesh)
            rows = {}

            def walk(t, s, path):
                if isinstance(t, dict):
                    for k in t:
                        walk(t[k], s[k], f"{path}/{k}" if path else k)
                    return
                loc = col.local(t)
                rows[path] = (tuple(loc.shape),
                              loc.numel() * loc.element_size(), s)

            walk(pp, specs, "")
            out[(arch, shape)] = rows
            if arch == archs[0]:
                out[("int8", shape)] = int8_placements(pp)
    return out if rank == 0 else None


def int8_placements(params):
    """Each leaf's placements beside its int8 moment's codes' and
    scales', and whether its shards cut ``QBLOCK`` blocks."""
    from repro_torch.train.optim import _straddles, tree_leaves
    state = adamw(quantized=True).init(params)
    out = []
    for p, q in zip(tree_leaves(params), tree_leaves(state["m"])):
        out.append((str(p.placements), str(q.codes.placements),
                    str(q.scale.placements), _straddles(p),
                    tuple(col.local(q.codes).shape),
                    tuple(col.local(p).shape)))
    return out


def distributed_all(rank, world, ref_trees, batch, uneven, tokens, cases):
    """Every rank body of ``test_torch_distributed.py`` in one group."""
    return {"placements": placements(rank, world, *cases["placements"]),
            "steps": steps(rank, world, ref_trees, batch, cases["steps"]),
            "losses": losses(rank, world, ref_trees["llama3.2-1b"], uneven,
                             cases["losses"]),
            "decodes": decodes(rank, world, ref_trees, tokens,
                               cases["decodes"]),
            "train": train_launcher(rank, world, (2, 2), 3, None)}


def steps(rank, world, ref_tree, batch, cases):
    """One AdamW step per case ``(arch, shape, microbatches, remat)``
    from ``ref_tree`` (the reference's weights as numpy) on ``batch``:
    the loss, its parts, the grad norm and the parameters after it."""
    out = {}
    for arch, shape, micro, remat in cases:
        cfg = case_cfg(arch)
        mesh = make_process_mesh(shape, AXES)
        dp, model, _ = mesh_axes(mesh)
        params = from_reference(cfg, ref_tree[arch], device="cpu")
        pp, _ = placed(params, mesh)
        opt = adamw(1e-3)
        state = opt.init(pp)
        step = build_train_step(cfg, opt, mesh=mesh, dp_axes=dp,
                                model_axis=model, microbatches=micro,
                                remat=remat)
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        pp, state, m = step(pp, state, tb)
        params_after = whole(pp)
        moments = whole(state["m"])
        out[(arch, shape, micro, remat)] = (
            {k: float(v) for k, v in m.items()}, params_after, moments)
    return out if rank == 0 else None


def losses(rank, world, ref_tree, batch, shapes):
    """``lm_loss(mesh=)`` of llama3.2-1b's smoke weights per mesh shape
    on ``batch`` (labels ignored unevenly over the rows)."""
    cfg = configs.get_smoke("llama3.2-1b")
    out = {}
    for shape in shapes:
        mesh = make_process_mesh(shape, AXES)
        dp, model, _ = mesh_axes(mesh)
        pp, _ = placed(from_reference(cfg, ref_tree, device="cpu"), mesh)
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        loss, parts = lm_loss(pp, cfg, tb, mesh=mesh, dp_axes=dp,
                              model_axis=model)
        out[shape] = (float(loss), float(parts["ce"]))
    return out if rank == 0 else None


def decodes(rank, world, ref_tree, tokens, cases):
    """Greedy-free decode steps from empty caches per case ``(arch,
    shape, moe_1d)``: the global logits of each step (caches of
    ``len(tokens) + 1`` positions, lengths ``0, 1, ...``).  A case
    ``(arch, shape, moe_1d, start, max_len, max_len2)`` decodes the first
    ``len(start)`` columns of ``tokens`` from per-row lengths ``start``
    (then ``start + 1``, ...) into caches of ``max_len`` positions, and
    adds this rank's caches, ``local_index`` and one step's collective
    bytes per kind (``Tally``) from lengths ``start`` at ``max_len`` and
    at ``max_len2``.  Every rank returns its own."""
    out = {}
    for case in cases:
        arch, shape, moe_1d = case[:3]
        cfg = case_cfg(arch)
        mesh = make_process_mesh(shape, AXES)
        dp, model, _ = mesh_axes(mesh)
        kw = dict(mesh=mesh, dp_axes=dp, model_axis=model)
        pp, _ = placed(from_reference(cfg, ref_tree[arch], device="cpu"),
                       mesh)
        if len(case) == 3:
            toks_all, lengths = torch.as_tensor(tokens), None
            max_len = tokens.shape[0] + 1
        else:
            start, max_len, max_len2 = case[3:]
            toks_all = torch.as_tensor(tokens[:, :len(start)])
            lengths = torch.as_tensor(start)
        b = toks_all.shape[1]
        caches = init_caches(cfg, b, max_len, device="cpu", **kw)
        if moe_1d:
            os.environ["REPRO_MOE_1D"] = "1"
        logits = []
        try:
            with torch.no_grad():
                for i, toks in enumerate(toks_all):
                    length = i if lengths is None else lengths + i
                    lg, caches = lm_decode_step(pp, cfg, toks, caches,
                                                length, max_len=max_len,
                                                **kw)
                    logits.append(_global_rows(lg, mesh, dp, b).numpy())
                tallies = []
                for n in ([] if lengths is None else [max_len, max_len2]):
                    fresh = init_caches(cfg, b, n, device="cpu", **kw)
                    with col.tallied() as tally:
                        lm_decode_step(pp, cfg, toks_all[0], fresh, lengths,
                                       max_len=n, **kw)
                    tallies.append(tally.per_device())
        finally:
            os.environ.pop("REPRO_MOE_1D", None)
        if lengths is None:
            out[case] = np.stack(logits)
        else:
            out[case] = (np.stack(logits), _local_caches(caches),
                         local_index(cfg, mesh, b, max_len), tallies)
    return out if rank == 0 or any(len(c) > 3 for c in cases) else None


def _global_rows(t, mesh, dp, b):
    """A decode's rows of this rank as the global batch's: gathered over
    the dp axes, or as they are where the batch does not divide over
    them (every dp rank holds it whole)."""
    n = math.prod(mesh.shape[a] for a in dp)
    return col.gather(t, mesh, 0, dp) if b % n == 0 else t


def train_launcher(rank, world, shape, steps, ckpt_dir):
    """``launch.train.train(mesh=)`` on llama3.2-1b's smoke config: the
    loss history (two runs into ``ckpt_dir`` when given: the second
    resumes)."""
    from repro_torch.launch.train import train
    mesh = make_process_mesh(shape, AXES)
    kw = dict(steps=steps, batch=4, seq_len=16, log_every=1000, mesh=mesh,
              device="cpu", ckpt_dir=ckpt_dir, ckpt_every=2)
    first = train("llama3.2-1b", **kw)["history"]
    return first if rank == 0 else None


# ------------------------------------------------------------ test_moe_ep --
def moe_paths(rank, world, ref_moe, x, cases):
    """Each case ``(path, capacity_factor, moe_1d)`` on a (2, 2) mesh
    (``path`` a2a, gathered, gathered2d, or ``apply<S>``: ``moe_apply`` on
    the first S positions): the global output, the aux loss and the
    global mask of dropped ``(token, k)`` entries."""
    from repro_torch.models import moe
    mesh = make_process_mesh((2, 2), AXES)
    xt = torch.from_numpy(x)
    out = {}
    for path, cf, moe_1d in cases:
        cfg = moe_cfg(cf)
        params = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                      {kk: torch.from_numpy(vv) for kk, vv in v.items()})
                  for k, v in ref_moe.items()}
        specs = shd.param_specs({"layer": {"moe": params}}, mesh)
        pp = shd.device_put({"layer": {"moe": params}},
                            shd.shardings(specs, mesh))["layer"]["moe"]
        stats = {}
        if path == "a2a":
            blk = col.take_block(col.take_block(xt, mesh, 0, "data"),
                                 mesh, 1, "model")
            y, aux = moe.moe_a2a(pp, blk, cfg, mesh=mesh, stats=stats)
            y = col.gather(col.gather(y, mesh, 1, "model"), mesh, 0, "data")
            B, S = x.shape[:2]
            dropped = _gather_entries(stats["dropped"], mesh, B, S, cfg,
                                      ("data", "model"))
        elif path == "gathered":
            blk = col.take_block(xt, mesh, 0, "data")
            y, aux = moe.moe_gathered(pp, blk, cfg, mesh=mesh, stats=stats)
            y = col.gather(y, mesh, 0, "data")
            dropped = _owned_drops(stats["dropped"], mesh, ("data",))
        elif path == "gathered2d":
            y, aux = moe.moe_gathered2d(pp, xt, cfg, mesh=mesh, stats=stats)
            dropped = _owned_drops(stats["dropped"], mesh, ())
        else:                          # "apply<S>": moe_apply's dispatch
            if moe_1d:
                os.environ["REPRO_MOE_1D"] = "1"
            try:
                blk = col.take_block(xt[:, :int(path[5:])], mesh, 0, "data")
                y, aux = moe.moe_apply(pp, blk, cfg, mesh=mesh)
                y = col.gather(y, mesh, 0, "data")
            finally:
                os.environ.pop("REPRO_MOE_1D", None)
            dropped = None
        out[(path, cf, moe_1d)] = (y.detach().numpy(), float(aux),
                                   dropped)
    return out if rank == 0 else None


def _gather_entries(mask, mesh, B, S, cfg, axes):
    """The a2a path's per-rank entry masks (``(B_loc·S_loc·k,)``) as one
    ``(B, S, k)`` mask of the global batch."""
    k = cfg.moe.top_k
    m = mask.reshape(B // mesh.shape["data"], S // mesh.shape["model"], k)
    m = col.gather(col.gather(m.to(torch.int32), mesh, 1, "model"),
                   mesh, 0, "data")
    return m.bool().numpy()


def _owned_drops(mask, mesh, row_axes):
    """The decode paths' masks of dropped entries each model rank owns,
    OR-ed over the model axis (an entry has one owner), rows gathered
    over ``row_axes``."""
    m = col.psum(mask.to(torch.int32), mesh, "model")
    if row_axes:
        m = col.gather(m, mesh, 0, row_axes)
    return m.bool().numpy()


# ---------------------------------------------------------- test_pipeline --
def pipelines(rank, world, cases):
    """``pipeline_apply`` of ``tanh(x @ w)`` over 4 stages per case ``(W,
    xs)``: ys and the grads of ``ys.sum()``, with the stage weights placed
    over ``"stage"`` (``"placed"``: the stages' grads gathered) or passed
    whole to every rank (``"plain"``: the grads summed over the ranks)."""
    from repro_torch.distributed.pipeline import pipeline_apply
    mesh = make_process_mesh((4,), ("stage",))
    out = {"placed": [], "plain": []}
    for layout in out:
        for W, xs in cases:
            full = torch.from_numpy(W)
            if layout == "plain":
                w = leaf = full.clone().requires_grad_(True)
            else:
                w = shd.device_put(full, shd.NamedSharding(
                    mesh, ("stage", None, None)))
                leaf = col.local(w).requires_grad_(True)
            ys = pipeline_apply(lambda p, x: torch.tanh(x @ p), w,
                                torch.from_numpy(xs), mesh=mesh,
                                axis="stage")
            ys.sum().backward()
            g = (col.psum(leaf.grad, mesh, "stage") if layout == "plain"
                 else col.gather(leaf.grad, mesh, 0, "stage"))
            out[layout].append((ys.detach().numpy(), g.numpy()))
    return out if rank == 0 else None


# ------------------------------------------------- test_checkpoint_mesh --
def checkpoints(rank, world, ref_tree, batch, directory, ref_dir, ref_step):
    """llama3.2-1b's smoke weights stepped once on (2, 2), saved from the
    mesh, restored onto (4, 1) and (1, 4), and the reference's checkpoint
    in ``ref_dir`` restored onto (2, 2) and (1, 4): every restored leaf
    gathered whole."""
    cfg = configs.get_smoke("llama3.2-1b")
    out = {}
    mesh = make_process_mesh((2, 2), AXES)
    dp, model, _ = mesh_axes(mesh)
    pp, _ = placed(from_reference(cfg, ref_tree, device="cpu"), mesh)
    opt = adamw(1e-3)
    state = opt.init(pp)
    step = build_train_step(cfg, opt, mesh=mesh, dp_axes=dp,
                            model_axis=model)
    pp, state, _ = step(pp, state, {k: torch.as_tensor(v)
                                    for k, v in batch.items()})
    mgr = CheckpointManager(directory)
    mgr.save(1, {"params": pp, "opt": state}, extra={"data_cursor": 1})
    out["saved"] = whole({"params": pp, "opt": state})
    for shape in ((4, 1), (1, 4)):
        m2 = make_process_mesh(shape, AXES)
        like, shard = _like(cfg, m2, opt)
        got = mgr.restore(1, like, shardings=shard)
        out[("port", shape)] = whole(got)
        out[("placements", shape)] = {
            k: tuple(col.local(v).shape) for k, v in
            _flat(got["params"]).items()}
    ref_mgr = CheckpointManager(ref_dir)
    for shape in ((2, 2), (1, 4)):
        m2 = make_process_mesh(shape, AXES)
        like, shard = _like(cfg, m2, opt)
        out[("reference", shape)] = whole(ref_mgr.restore(ref_step, like,
                                                          shardings=shard))
    return out if rank == 0 else None


def _like(cfg, mesh, opt):
    """A placed (params, opt) tree to restore into, and its shardings."""
    dp, model, _ = mesh_axes(mesh)
    shapes = param_shapes(cfg)
    specs = shd.param_specs(shapes, mesh, fsdp=dp, model=model)
    pshard = shd.shardings(specs, mesh)
    params = shd.device_put(init_lm(1, cfg, device="cpu"), pshard)
    return ({"params": params, "opt": opt.init(params)},
            {"params": pshard, "opt": {"m": pshard, "v": pshard}})


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{path}/{k}" if path else k))
        return out
    return {path: tree}


# --------------------------------------------------------- test_mesh_serve --
def local_index(cfg, mesh, b, max_len):
    """Where a rank's caches of a global batch ``b`` and ``max_len``
    positions sit in the one-device caches: its rows ``(lo, hi)`` and,
    per stage kind, the dim and index of its positions (the attention
    leaves: ``sharding.seq_block``), heads or channels (None: whole)."""
    from repro_torch.models import layers, ssm
    from repro_torch.models.layers import shard_axes
    from repro_torch.models.transformer import _batch_axes
    dp, model, _ = mesh_axes(mesh)
    block = shd.seq_block(mesh, b, max_len, dp=dp, model=model)
    with shard_axes(_batch_axes(b, dp, mesh), model, mesh) as ax:
        n = b // ax.dp_size
        rows = (ax.dp_index * n, (ax.dp_index + 1) * n)
        seq = (2, list(range(block.lo, block.hi)))
        out = {"rows": rows, "attn": dict.fromkeys(("k", "v", "ckv", "kr"),
                                                   seq)}
        if cfg.ssm is not None:
            (lo, hi), _, _, chans = ssm._mamba2_part(cfg, "cpu")
            out["mamba2"] = {"ssm": (2, list(range(lo, hi))),
                             "conv": (3, None if chans is None
                                      else chans.tolist())}
        if cfg.xlstm is not None:
            lo, hi = layers.head_part(cfg.n_heads)
            heads = list(range(lo, hi))
            out["mlstm"] = {"C": (2, heads), "n": (2, heads),
                            "m": (2, heads)}
    return out


def cache_part(leaf, rows, where):
    """The part of a one-device cache leaf (numpy) that a rank holds:
    ``rows`` on dim 1, then ``where = (dim, index)``, its positions, heads
    or channels (None: whole; ``local_index``)."""
    out = leaf[:, rows[0]:rows[1]]
    if where is not None and where[1] is not None:
        out = np.take(out, where[1], axis=where[0])
    return out


def _local_caches(caches):
    return {key: {name: t.detach().numpy().copy() for name, t in st.items()}
            for key, st in caches.items()}


def mesh_serve_all(rank, world, ref_trees, prompts, serve_cases, tokens,
                   prefill_cases):
    """Every rank body of ``test_torch_mesh_serve.py`` in one group:
    ``ServeEngine(mesh=)``'s greedy outputs per case ``(arch, shape,
    slots)`` or ``(arch, shape, slots, max_len)`` (32 by default; every
    rank's, to check they agree), and ``lm_prefill(mesh=)``
    of ``tokens`` per case ``(arch, shape)``: the logits gathered over the
    dp axes, each rank's caches and ``local_index``."""
    from repro_torch.models.transformer import lm_prefill
    from repro_torch.serve.engine import ServeEngine
    out = {"serve": {}, "prefill": {}}
    for case in serve_cases:
        arch, shape, slots = case[:3]
        cfg = case_cfg(arch)
        mesh = make_process_mesh(shape, AXES)
        dp, model, _ = mesh_axes(mesh)
        pp, _ = placed(from_reference(cfg, ref_trees[arch], device="cpu"),
                       mesh)
        eng = ServeEngine(cfg, pp, slots=slots, max_len=(case + (32,))[3],
                          mesh=mesh, dp_axes=dp, model_axis=model)
        reqs = [eng.submit(p, max_new=5) for p in prompts]
        with torch.no_grad():
            eng.run()
        out["serve"][case] = [r.out for r in reqs]
    toks = torch.as_tensor(tokens)
    for arch, shape in prefill_cases:
        cfg = case_cfg(arch)
        mesh = make_process_mesh(shape, AXES)
        dp, model, _ = mesh_axes(mesh)
        pp, _ = placed(from_reference(cfg, ref_trees[arch], device="cpu"),
                       mesh)
        with torch.no_grad():
            logits, caches, _ = lm_prefill(pp, cfg, toks, max_len=16,
                                           mesh=mesh, dp_axes=dp,
                                           model_axis=model)
            logits = col.gather(logits, mesh, 0, dp).numpy()
        out["prefill"][(arch, shape)] = (
            logits, _local_caches(caches), local_index(cfg, mesh,
                                                       toks.shape[0], 16))
    return out


# ---------------------------------------------------- test_recurrent_mesh --
def recurrent_mesh_all(rank, world, ref_trees, batch, tokens, cases):
    """Every rank body of ``test_torch_recurrent_mesh.py`` in one group:
    per ``cases["steps"]`` entry ``(arch, shape, rows, remat)`` one AdamW
    step (lr 1e-3) on the first ``rows`` rows of ``batch`` (metrics,
    parameters after it and first moments, gathered: the moment is 0.1 of
    the clipped grad); per ``cases["fp64"]`` entry ``(arch, shape)`` the
    same step on the whole batch with the parameters in float64 (metrics
    and first moments); per ``cases["losses"]`` entry ``(arch, shape,
    rows)`` ``lm_loss(mesh=)``; per ``cases["decodes"]`` entry ``(arch,
    shape)`` the gathered logits of decode steps over ``tokens`` and the
    local caches' shapes."""
    out = {"steps": {}, "fp64": {}, "losses": {}, "decodes": {}}
    step_cases = [(c, c[2], c[3], None) for c in cases["steps"]] + [
        ((arch, shape), len(batch["tokens"]), False, torch.float64)
        for arch, shape in cases["fp64"]]
    for key, rows, remat, dtype in step_cases:
        arch, shape = key[:2]
        cfg = case_cfg(arch)
        mesh = make_process_mesh(shape, AXES)
        dp, model, _ = mesh_axes(mesh)
        params = from_reference(cfg, ref_trees[arch], device="cpu")
        if dtype is not None:
            params = cast(params, dtype)
        pp, _ = placed(params, mesh)
        opt = adamw(1e-3)
        step = build_train_step(cfg, opt, mesh=mesh, dp_axes=dp,
                                model_axis=model, remat=remat)
        tb = {k: torch.as_tensor(v[:rows]) for k, v in batch.items()}
        pp, state, m = step(pp, opt.init(pp), tb)
        metrics = {k: float(v) for k, v in m.items()}
        if dtype is None:
            out["steps"][key] = (metrics, whole(pp), whole(state["m"]))
        else:
            out["fp64"][key] = (metrics, whole(state["m"]))
    for arch, shape, rows in cases["losses"]:
        cfg = case_cfg(arch)
        mesh = make_process_mesh(shape, AXES)
        dp, model, _ = mesh_axes(mesh)
        pp, _ = placed(from_reference(cfg, ref_trees[arch], device="cpu"),
                       mesh)
        tb = {k: torch.as_tensor(v[:rows]) for k, v in batch.items()}
        with torch.no_grad():
            loss, _ = lm_loss(pp, cfg, tb, mesh=mesh, dp_axes=dp,
                              model_axis=model)
        out["losses"][(arch, shape, rows)] = float(loss)
    for arch, shape in cases["decodes"]:
        cfg = case_cfg(arch)
        mesh = make_process_mesh(shape, AXES)
        dp, model, _ = mesh_axes(mesh)
        pp, _ = placed(from_reference(cfg, ref_trees[arch], device="cpu"),
                       mesh)
        b, max_len = tokens.shape[1], tokens.shape[0] + 1
        caches = init_caches(cfg, b, max_len, device="cpu", mesh=mesh,
                             dp_axes=dp, model_axis=model)
        logits = []
        with torch.no_grad():
            for i, toks in enumerate(torch.as_tensor(tokens)):
                lg, caches = lm_decode_step(pp, cfg, toks, caches, i,
                                            mesh=mesh, dp_axes=dp,
                                            model_axis=model,
                                            max_len=max_len)
                logits.append(col.gather(lg, mesh, 0, dp).numpy())
        out["decodes"][(arch, shape)] = (
            np.stack(logits),
            {key: {name: tuple(t.shape) for name, t in st.items()}
             for key, st in caches.items()})
    return out if rank == 0 else None


# --------------------------------------------------------- test_int8_mesh --
def _spec_fit(specs, shapes, mesh):
    return {k: tuple(a if a is None or shapes[k][i] % mesh.shape[a] == 0
                     else None for i, a in enumerate(sp))
            for k, sp in specs.items()}


def _q_whole(q):
    """An int8 moment gathered whole in the reference's layout, as
    numpy."""
    from repro_torch.train.optim import QTensor
    return QTensor(*(t.detach().cpu().numpy().copy() for t in q.whole()))


def int8_mesh_all(rank, world, tree, specs, grads, ref_tree, batches,
                  directory, ref_dir):
    """Every rank body of ``test_torch_int8_mesh.py`` in one group.

    ``"tree"``: per mesh shape, three int8 AdamW updates (lr 1e-2, no
    clip) of ``tree`` placed by ``specs`` from ``grads`` (each update's
    global grads, each rank taking its block): the parameters and moments
    gathered, then the state saved, restored onto the transposed mesh
    (``moment_shardings``), gathered again, and one more update from
    ``grads[-1]``.  ``"lm"``: llama3.2-1b's smoke weights ``ref_tree``,
    three int8 steps (the reference's schedule) on ``batches`` over (2,
    2): the parameters after each, and the state saved into ``ref_dir``
    for the reference's ``CheckpointManager``."""
    from repro_torch.train.optim import (cosine_schedule, moment_shardings,
                                         tree_map)
    out = {"tree": {}}
    shapes = {k: tuple(v.shape) for k, v in tree.items()}
    for shape in ((2, 2), (1, 4)):
        mesh = make_process_mesh(shape, AXES)
        sh = shd.shardings(_spec_fit(specs, shapes, mesh), mesh)
        pp = shd.device_put({k: torch.from_numpy(v.copy())
                             for k, v in tree.items()}, sh)
        opt = adamw(1e-2, quantized=True, grad_clip=0.0)
        state = opt.init(pp)
        for g in grads[:-1]:
            opt.update({k: sh[k].block(torch.from_numpy(v)).clone()
                        for k, v in g.items()}, state, pp)
        got = {"params": whole(pp),
               "m": {k: _q_whole(q) for k, q in state["m"].items()},
               "v": {k: _q_whole(q) for k, q in state["v"].items()}}
        sub = os.path.join(directory, f"{shape[0]}x{shape[1]}")
        mgr = CheckpointManager(sub)
        mgr.save(3, {"params": pp, "opt": state})
        m2 = make_process_mesh((shape[1], shape[0]), AXES)
        sh2 = shd.shardings(_spec_fit(specs, shapes, m2), m2)
        like = shd.device_put({k: torch.zeros(s) for k, s in shapes.items()},
                              sh2)
        ms = moment_shardings(like, sh2, quantized=True)
        back = mgr.restore(3, {"params": like, "opt": opt.init(like)},
                           shardings={"params": sh2,
                                      "opt": {"m": ms, "v": ms}})
        got["restored"] = {
            "params": whole(back["params"]),
            "m": {k: _q_whole(q) for k, q in back["opt"]["m"].items()},
            "v": {k: _q_whole(q) for k, q in back["opt"]["v"].items()}}
        opt.update({k: sh2[k].block(torch.from_numpy(v)).clone()
                    for k, v in grads[-1].items()}, back["opt"],
                   back["params"])
        got["resumed"] = whole(back["params"])
        out["tree"][shape] = got
    cfg = configs.get_smoke("llama3.2-1b")
    mesh = make_process_mesh((2, 2), AXES)
    dp, model, _ = mesh_axes(mesh)
    pp, _ = placed(from_reference(cfg, ref_tree, device="cpu"), mesh)
    opt = adamw(cosine_schedule(3e-4, warmup=2, total=10), quantized=True)
    state = opt.init(pp)
    step = build_train_step(cfg, opt, mesh=mesh, dp_axes=dp,
                            model_axis=model)
    lm = []
    for b in batches:
        pp, state, m = step(pp, state, {k: torch.as_tensor(v)
                                        for k, v in b.items()})
        lm.append((float(m["loss"]), whole(pp)))
    out["lm"] = lm
    out["lm_state"] = {"m": tree_map(_q_whole, state["m"]),
                       "step": int(state["step"])}
    CheckpointManager(ref_dir).save(len(batches), {"params": pp,
                                                   "opt": state})
    return out if rank == 0 else None
