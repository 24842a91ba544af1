"""Multi-pod dry run: one step of every (arch x shape x mesh) cell, counted
on the host, with no card and no array's data.

Port of ``src/repro/launch/dryrun.py``.  The reference lowers and
compiles each cell for 256 (512 with ``--multi-pod``) forced host devices,
its parameters, optimizer state, caches and batches ``ShapeDtypeStruct``s,
which proves the sharding holds together and yields XLA's memory and cost
analyses and the HLO its roofline terms come from.  Here this process
joins a ``torch.distributed`` group on the ``fake`` backend as rank 0 of
256 (or 512) ranks (``launch.mesh.init_fake_group``; its collectives move
nothing), binds ``make_production_mesh``'s shape to it
(``make_process_mesh``), places the parameters, AdamW state, caches and
batch by ``distributed/sharding.py``'s rules as the four-card path places
them, each rank's block a ``meta`` tensor (its shape, no storage), and
takes one step through the entry points the card runs:
``build_train_step(remat=True)`` (the reference's dry run remats),
``lm_prefill(mesh=, impl="chunked")`` or ``lm_decode_step(mesh=)``,
under ``step_analysis.StepCounter``, which gives the record's FLOPs, HBM
bytes, collective bytes and memory per device.  Then it leaves the
group.  ``launch/roofline.py`` reads the records.

Why ``meta`` and not ``FakeTensorMode``'s fake CUDA tensors: autograd over
a fake CUDA tensor asks CUDA's device guard for its stream, and a PyTorch
built without CUDA has none.  A meta tensor takes the card's branches
through the port (``layers._mm32``'s bf16 products, the flash wrappers'
custom ops, whose fake implementations give the kernels' outputs'
shapes and layouts), so the counts are the card's; anything that asks a
tensor for its value fails, as it would stall the card's host.

The records keep the reference's JSON keys and file names
(``<arch>__<shape>__pod1.json``).  ``lower_s`` is the seconds taken to
place the cell's tensors, ``compile_s`` the seconds of its step;
``xla_cost_analysis`` (there is no XLA here) repeats the counter's
totals.  The port adds ``memory.peak_bytes``, ``argument_breakdown``,
``flash_calls`` and ``cache_layout``: a decode or prefill cell's caches
take the reference's ``cache_specs`` layout (``init_caches(mesh=)``:
each rank's batch rows, every kv head and its block of the sequence, over
``model`` or over dp + model where the batch does not divide over dp;
the recurrent states by heads, whose small leaves part from the spec as
``init_caches`` states).  Int8 moments
take the port's layout (``train/optim.py``: where a shard's edge cuts a
256-element block, its codes are unpadded and its scales replicated over
the axes that cut the last dim), where the reference's ``_opt_specs``
pads every last dim to 256 and replicates every scale.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import (destroy_process_group, init_fake_group,
                                     make_process_mesh, mesh_axes,
                                     production_shape)
from repro_torch.launch.step_analysis import StepCounter, held_bytes
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import (init_caches, lm_decode_step,
                                            lm_prefill)
from repro_torch.models.weights import param_dtypes, param_shapes
from repro_torch.train.optim import (QTensor, adamw, moment_shardings,
                                     tree_map)
from repro_torch.train.step import build_train_step

QUANTIZE_ABOVE = 30e9          # int8 Adam moments for >30B-param archs
META = torch.device("meta")
CACHE_LAYOUT = ("init_caches(mesh=): cache_specs' layout: batch rows over "
                "dp, the sequence over model (dp + model where the batch "
                "does not divide over dp), every kv head; recurrent states "
                "by heads")


# ----------------------------------------------------------------- specs ---
def input_specs(arch: str, shape: str, cfg=None, dims=None) -> dict:
    """Meta stand-ins for every model input of a cell, the global batch
    (every rank passes it; each reads its own rows); ``dims`` replaces
    entries of the shape's ``SHAPES`` row."""
    cfg = cfg or configs.get(arch)
    sh = {**configs.SHAPES[shape], **(dims or {})}
    B, S = sh["global_batch"], sh["seq_len"]
    kind = sh["kind"]
    tok = torch.empty((B, S), dtype=torch.int32, device=META)
    if kind == "decode":          # one new token against a seq_len cache
        return {"tokens": torch.empty((B,), dtype=torch.int32, device=META),
                "length": torch.empty((), dtype=torch.int32, device=META)}
    ins = ({"tokens": tok} if cfg.embed_inputs else
           {"embeds": torch.empty((B, S, cfg.d_model),
                                  dtype=dtype_of(cfg.dtype), device=META)})
    if kind == "train":
        ins["labels"] = tok
    return ins


def _opt_specs(params, pshard, quantized: bool) -> dict:
    """Optimizer-state specs: fp32 moments follow the param spec; an int8
    ``QTensor`` moment's codes follow it too, its scales drop the axes
    that cut the last dim where a shard's edge cuts a block
    (``optim.moment_shardings``)."""
    def spec(sh):
        if isinstance(sh, QTensor):
            return QTensor(sh.codes.spec, sh.scale.spec)
        return sh.spec

    specs = tree_map(spec, moment_shardings(params, pshard,
                                            quantized=quantized))
    return {"step": (), "m": specs, "v": specs}


def place_params(cfg, mesh, *, fsdp, model) -> tuple[dict, dict]:
    """The parameters as this rank holds them, each a ``DTensor`` over its
    meta block, placed by the rule table: (params, shardings)."""
    shapes = param_shapes(cfg)
    pshard = shd.shardings(shd.param_specs(shapes, mesh, fsdp=fsdp,
                                           model=model), mesh)

    def one(shape, dtype, sh):
        if isinstance(shape, dict):
            return {k: one(shape[k], dtype[k], sh[k]) for k in shape}
        return shd.place(torch.empty(shape, dtype=dtype, device=META), sh)

    return one(shapes, param_dtypes(cfg), pshard), pshard


def batch_blocks(ins: dict, kind: str, mesh, *, dp, model) -> dict:
    """This rank's block of each batch input by ``batch_specs`` (a batch
    that does not divide over the dp axes whole, as the reference's spec
    then replicates it): the argument bytes a rank needs of it."""
    specs = shd.batch_specs(kind, mesh, dp=dp, model=model)
    out = {}
    for k, t in ins.items():
        spec = specs.get(k, ())
        if t.ndim and t.shape[0] % shd._axsize(mesh, spec[0] if spec
                                                 else None):
            spec = ()
        out[k] = shd.NamedSharding(mesh, spec).block(t)
    return out


# ------------------------------------------------------------------ cell ---
def lower_cell(arch: str, shape: str, *, multi_pod: bool = False,
               remat: bool = True, microbatches: int = 1,
               extra_tag: str = "", impl: str = "chunked", cfg=None,
               mesh_shape=None, dims=None, counter=None) -> dict:
    """One step of one (arch, shape, mesh) cell on rank 0 of a fake group;
    return its record.  ``cfg``, ``mesh_shape`` (shape, axis names) and
    ``dims`` (``seq_len``, ``global_batch``) replace ``configs.get(arch)``,
    the production mesh and the shape's sizes (smaller cells: the tests,
    the card's check); ``counter``, the ``StepCounter`` the step is
    counted with (``launch/perf_probe.py`` reads its rows)."""
    cfg = cfg or configs.get(arch)
    sh = {**configs.SHAPES[shape], **(dims or {})}
    if shape == "long_500k" and not cfg.subquadratic:
        return {"arch": arch, "shape": shape, "status": "n/a",
                "reason": "full-attention arch; 500k decode has no "
                          "sub-quadratic structure (DESIGN.md §5)"}
    grid, axes = mesh_shape or production_shape(multi_pod=multi_pod)
    kind = sh["kind"]
    B, S = sh["global_batch"], sh["seq_len"]
    t0 = time.time()
    init_fake_group(math.prod(grid))
    try:
        mesh = make_process_mesh(grid, axes)
        dp, model_axis, fsdp = mesh_axes(mesh)
        kw = dict(mesh=mesh, dp_axes=dp, model_axis=model_axis)
        params, pshard = place_params(cfg, mesh, fsdp=fsdp, model=model_axis)
        ins = input_specs(arch, shape, cfg, dims)
        held = {"params": params,
                "batch": batch_blocks(ins, kind, mesh, dp=dp,
                                      model=model_axis)}
        if kind == "train":
            opt = adamw(quantized=cfg.params_count() > QUANTIZE_ABOVE)
            state = opt.init(params)
            held["opt_state"] = state
            step = build_train_step(cfg, opt, remat=remat,
                                    microbatches=microbatches, impl=impl,
                                    **kw)

            def run():
                return step(params, state, ins)
        elif kind == "prefill":
            def run():
                with torch.no_grad():
                    return lm_prefill(params, cfg, tokens=ins.get("tokens"),
                                      embeds=ins.get("embeds"), max_len=S,
                                      impl=impl, **kw)
        else:
            caches = init_caches(cfg, B, S, device=META, **kw)
            held["caches"] = caches

            def run():
                with torch.no_grad():
                    return lm_decode_step(params, cfg, ins["tokens"],
                                          caches, ins["length"], max_len=S,
                                          **kw)
        t_place = time.time() - t0
        with counter or StepCounter() as sc:
            out = run()
        t_step = time.time() - t0 - t_place
        memory = sc.memory(held, out)
        coll = sc.collective_bytes()
        calls = {k: sc.calls.get(f"repro_torch::{k}", 0)
                 for k in ("flash_fwd", "flash_bwd")}
    finally:
        destroy_process_group()
    result = {
        "arch": arch, "shape": shape, "kind": kind, "status": "ok",
        "mesh": "x".join(map(str, grid)), "multi_pod": multi_pod,
        "devices": math.prod(grid), "remat": remat,
        "microbatches": microbatches, "tag": extra_tag,
        "lower_s": round(t_place, 1), "compile_s": round(t_step, 1),
        "flops_per_device": sc.flops, "bytes_per_device": sc.bytes,
        "xla_cost_analysis": {"flops": sc.flops,
                              "bytes_accessed": sc.bytes},
        "collective_bytes_per_device": coll,
        "memory": memory,
        "argument_breakdown": {k: held_bytes(v) for k, v in held.items()},
        "flash_calls": calls,
        "params": cfg.params_count(),
        "active_params": cfg.active_params_count(),
    }
    if kind != "train":
        result["cache_layout"] = CACHE_LAYOUT
    return result


# ------------------------------------------------------------------ main ---
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--baseline", action="store_true",
                    help="the reference's baseline where the port has it: "
                         "the plain scan attention core (chunked_scan) and "
                         "the 1-D gathered MoE; the port has no switch for "
                         "the reference's activation sharding constraints")
    args = ap.parse_args(argv)
    impl = "chunked"
    if args.baseline:
        impl = "chunked_scan"
        os.environ["REPRO_MOE_1D"] = "1"

    os.makedirs(args.out, exist_ok=True)
    cells = configs.cells(include_na=True) if args.all else \
        [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_ok = n_na = n_fail = 0
    t_all = time.time()
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
            tag += f"__{args.tag}" if args.tag else ""
            out_path = os.path.join(args.out, tag + ".json")
            if os.path.exists(out_path):
                print(f"[skip] {tag} (exists)", flush=True)
                continue
            print(f"[cell] {tag} ...", flush=True)
            try:
                res = lower_cell(arch, shape, multi_pod=mp,
                                 remat=not args.no_remat,
                                 microbatches=args.microbatches,
                                 extra_tag=args.tag, impl=impl)
            except Exception as e:               # noqa: BLE001
                res = {"arch": arch, "shape": shape, "status": "fail",
                       "multi_pod": mp, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
            with open(out_path, "w") as f:
                json.dump(res, f, indent=1)
            st = res["status"]
            n_ok += st == "ok"
            n_na += st == "n/a"
            n_fail += st == "fail"
            msg = res.get("error", "")[:200]
            print(f"  -> {st} step={res.get('compile_s', '-')}s "
                  f"flops/dev={res.get('flops_per_device', 0):.3e} {msg}",
                  flush=True)
    print(f"done: ok={n_ok} n/a={n_na} fail={n_fail} in "
          f"{time.time() - t_all:.1f} s", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
