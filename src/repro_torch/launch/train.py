"""Training launcher: config -> data -> train loop with checkpoint/restart.

Port of ``src/repro/launch/train.py``.  Fault-tolerance posture, as the
reference's:
  * resume: the latest checkpoint is restored (params, opt state, step);
    data is step-addressed, so the stream continues where it stopped;
  * preemption: SIGTERM -> checkpoint and exit (``CheckpointManager``'s
    hook);
  * stragglers: a per-step wall-clock watchdog logs and counts steps slower
    than ``straggler_factor`` x the running median.
The step clock reads the loss with ``.item()``, which waits for the step,
as the reference's ``float(metrics["loss"])`` does; the result adds each
step's host milliseconds (``step_ms``) to the reference's keys.  Weights
are random, drawn from ``seed`` on the device; the step is eager (the
reference jits it).  Runs on ``cuda`` unless ``device="cpu"``
(``--device cpu``).

``mesh=`` (every rank of a ``launch.mesh.make_process_mesh`` mesh calls
``train`` alike): the reference's FSDP+TP step over ``dp = ("data",)``
and ``"model"`` (``dp = ()`` without a mesh, as there), the weights drawn
whole on each rank's device and placed by the rule table
(``distributed.sharding``), the moments placed alike, checkpoints saved
from the mesh and restored onto it (``restore(shardings=)``), whatever
mesh wrote them; rank 0 alone prints.

Usage:
  python -m repro_torch.launch.train --device cpu --steps 5
  python -m repro_torch.launch.train --arch llama3.2-1b --full
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

from repro_torch import configs
from repro_torch.data import TokenPipeline
from repro_torch.distributed import sharding
from repro_torch.models.transformer import check_mesh, init_lm
from repro_torch.train import CheckpointManager, adamw, build_train_step
from repro_torch.train.optim import cosine_schedule


def train(arch: str, *, steps: int = 100, smoke: bool = True,
          batch: int = 8, seq_len: int = 128, ckpt_dir: str | None = None,
          ckpt_every: int = 50, lr: float = 3e-4, microbatches: int = 1,
          seed: int = 0, log_every: int = 10, straggler_factor: float = 3.0,
          mesh=None, total_steps: int | None = None, device: str = "cuda"):
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    check_mesh(cfg, mesh)
    dp, model_axis = ("data",), "model"
    if mesh is None:
        dp = ()
    else:
        device = mesh.device
    loud = mesh is None or mesh.rank == 0
    total = total_steps or steps       # schedule horizon survives restarts
    pipe = TokenPipeline(cfg.vocab, seq_len, batch, seed=seed, device=device)
    opt = adamw(cosine_schedule(lr, warmup=min(20, total // 10 + 1),
                                total=total))
    step_fn = build_train_step(cfg, opt, mesh=mesh, dp_axes=dp,
                               model_axis=model_axis,
                               microbatches=microbatches)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    params = init_lm(seed, cfg, device=device)
    shard = None
    if mesh is not None:
        pshard = sharding.shardings(sharding.param_specs(
            params, mesh, fsdp=dp, model=model_axis), mesh)
        params = sharding.device_put(params, pshard)
        shard = {"params": pshard, "opt": {"m": pshard, "v": pshard}}
    opt_state = opt.init(params)
    if mgr:
        mgr.install_preemption_hook()
        latest = mgr.latest_step()
        if latest is not None:
            state = mgr.restore(latest, {"params": params, "opt": opt_state},
                                shardings=shard)
            params, opt_state = state["params"], state["opt"]
            start = latest
            if loud:
                print(f"[resume] step {latest}", flush=True)

    history = []
    durations = []
    stragglers = 0
    for step in range(start, steps):
        t0 = time.time()
        b = pipe.batch(step)
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = metrics["loss"].item()
        dt = time.time() - t0
        durations.append(dt)
        med = statistics.median(durations[-50:])
        if len(durations) > 5 and dt > straggler_factor * med:
            stragglers += 1
            if loud:
                print(f"[straggler] step {step} took {dt:.2f}s "
                      f"(median {med:.2f}s)", flush=True)
        history.append(loss)
        if loud and step % log_every == 0:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics.get('grad_norm', 0)):7.3f} "
                  f"{dt*1e3:7.1f} ms", flush=True)
        if mgr and ((step + 1) % ckpt_every == 0 or mgr.preempted):
            mgr.save(step + 1, {"params": params, "opt": opt_state},
                     extra={"loss": loss, "data_cursor": step + 1})
            if mgr.preempted:
                if loud:
                    print("[preempted] checkpointed, exiting", flush=True)
                return {"history": history, "preempted": True,
                        "stragglers": stragglers}
    return {"history": history, "final_loss": history[-1] if history else
            None, "stragglers": stragglers, "preempted": False,
            "step_ms": [d * 1e3 for d in durations]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="full config (default: smoke)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = train(args.arch, steps=args.steps, smoke=not args.full,
                batch=args.batch, seq_len=args.seq_len,
                ckpt_dir=args.ckpt_dir, lr=args.lr,
                microbatches=args.microbatches, device=args.device)
    print(f"final loss: {res['final_loss']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)


if __name__ == "__main__":
    main()
