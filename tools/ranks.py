"""Run a function on N ranks of one ``torch.distributed`` group.

    from ranks import run_ranks
    results = run_ranks(fn, 4, arg, device_type="cpu", timeout_s=300)

Each rank is a process started with ``torch.multiprocessing``'s ``spawn``
method (a parent that has touched CUDA cannot ``fork``), joins the group
through ``repro_torch.launch.mesh.init_process_group`` over
``tcp://localhost:<a free port>`` (gloo on cpu, NCCL on cuda: one rank a
card), calls ``fn(rank, world, *args)`` and leaves the group.  ``fn`` must
be importable by name (a module-level function).  The results come back in
rank order.  A rank that raises, exits or outlives ``timeout_s`` fails the
call: every rank is then stopped and the first error is raised, so a hung
group fails instead of waiting.  Nothing falls back to one process.
"""
from __future__ import annotations

import pathlib
import queue
import socket
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[1]


def free_port() -> int:
    """A TCP port on localhost that the OS reports free."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, device_type, threads, fn, args, out):
    try:
        src = str(ROOT / "src")
        if src not in sys.path:
            sys.path.insert(0, src)
        import torch
        if threads:
            torch.set_num_threads(threads)
        from repro_torch.launch import mesh
        mesh.init_process_group(rank, world, f"tcp://localhost:{port}",
                                device_type=device_type)
        try:
            res = fn(rank, world, *args)
        finally:
            mesh.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:                       # reported, then re-raised
        out.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world: int, *args, device_type: str = "cpu",
              timeout_s: float = 300.0, threads: int | None = None) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks; their
    results in rank order (see the module docstring).  ``threads`` sets
    each rank's torch thread count (a CPU rank's default takes every
    core)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, device_type, threads, fn,
                               args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                errors.append(f"ranks timed out after {timeout_s:.0f} s "
                              f"({sorted(results)} finished)")
                break
            try:
                rank, ok, res = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and out.empty():
                    # a rank died without reporting (killed, or its
                    # interpreter failed before the queue)
                    time.sleep(1.0)
                    if out.empty():
                        errors.append(f"a rank exited with code {dead[0]} "
                                      f"without a result")
                        break
                continue
            if ok:
                results[rank] = res
            else:
                errors.append(f"rank {rank}:\n{res}")
                break
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(world)]
