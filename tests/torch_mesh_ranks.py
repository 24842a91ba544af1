"""Rank bodies of the port's multi-process CPU tests.

Each function runs on every rank of a 4-rank gloo group spawned by
``tools/ranks.run_ranks`` (``fn(rank, world, *args)``) and returns plain
numpy data.  Nothing here imports JAX: the tests compare what the ranks
return with the reference in their own process, or in a subprocess that
forces host devices.
"""
from __future__ import annotations

import dataclasses
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
    capacity factor 4.0 (no token dropped), or ``"heads10"``: llama's
    with 10 heads of 8 over 2 kv heads, which a 4-way model axis splits
    3, 3, 2, 2 (groups cut unevenly, projections sharded mid-head)."""
    if name == "heads10":
        return dataclasses.replace(get("llama3.2-1b"), n_heads=10,
                                   n_kv_heads=2, head_dim=8)
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
                try:
                    adamw(quantized=True).init(pp)
                except NotImplementedError as e:
                    out["int8"] = str(e)
    return out if rank == 0 else None


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
    shape, moe_1d)``: the global logits of each step."""
    out = {}
    for arch, shape, moe_1d in cases:
        cfg = case_cfg(arch)
        mesh = make_process_mesh(shape, AXES)
        dp, model, _ = mesh_axes(mesh)
        pp, _ = placed(from_reference(cfg, ref_tree[arch], device="cpu"),
                       mesh)
        b = tokens.shape[1]
        caches = init_caches(cfg, b, tokens.shape[0] + 1, device="cpu",
                             mesh=mesh, dp_axes=dp, model_axis=model)
        if moe_1d:
            os.environ["REPRO_MOE_1D"] = "1"
        logits = []
        try:
            with torch.no_grad():
                for i, toks in enumerate(torch.as_tensor(tokens)):
                    lg, caches = lm_decode_step(pp, cfg, toks, caches, i,
                                                mesh=mesh, dp_axes=dp,
                                                model_axis=model)
                    logits.append(col.gather(lg, mesh, 0, dp).numpy())
        finally:
            os.environ.pop("REPRO_MOE_1D", None)
        out[(arch, shape, moe_1d)] = np.stack(logits)
    return out if rank == 0 else None


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
