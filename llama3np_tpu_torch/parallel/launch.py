"""Spawn N ranks of one function under `torch.distributed`, and fail
instead of hanging.

`launch(fn, world_size, ...)` starts `world_size` processes with the
"spawn" start method, each of which joins the default process group
through a `file://` rendezvous in a fresh temporary directory (with a
collective timeout), calls `fn(rank, device, *args)` and sends back its
result.  The parent waits for every rank until a deadline; past it, or as
soon as one rank fails, it terminates the others and raises with every
rank's traceback, so a hung collective ends the call instead of the caller.

Each rank's device is "cuda:<rank>" by default (one GPU a rank, NCCL's
deployment) or whatever the caller maps it to: "cpu" for CPU ranks under
gloo, or one card for every rank (gloo: NCCL refuses two ranks on one
device).  `fn` and `args` are pickled: `fn` must be a module-level
function of a module the child can import without side effects (spawn
re-imports the caller's `__main__` as `__mp_main__`, so a script keeps its
own work under `if __name__ == "__main__"`).  CUDA tensors in `args` reach
the children through CUDA IPC; the parent keeps them alive until `launch`
returns.

Under `torchrun` (one process a GPU, several nodes) no launcher is needed:
each process calls `dist.init_process_group("nccl")` and builds its mesh
(`sharding.make_mesh(..., backend="nccl", device=f"cuda:{local_rank}")`).
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(fn, rank: int, world_size: int, backend: str, init_file: str,
               device: str, timeout_s: float, args, results) -> None:
    try:
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s))
        if device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        out = fn(rank, device, *args)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, world_size: int, args: Sequence = (), *,
           backend: str, devices: Optional[Sequence[str]] = None,
           timeout_s: float = 300.0) -> List:
    """Run `fn(rank, device, *args)` in `world_size` spawned ranks that share
    a default process group of `backend`; returns the ranks' results in
    rank order.  `devices[r]` is rank r's device (default "cuda:<r>").
    Raises RuntimeError with the tracebacks when a rank fails, or when the
    ranks are not done `timeout_s` seconds after the start (a collective
    times out after as long); the ranks are terminated then."""
    devices = list(devices or [f"cuda:{r}" for r in range(world_size)])
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="l3t_rdzv_")
    init_file = os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend, init_file, devices[r],
                               timeout_s, tuple(args), results))
             for r in range(world_size)]
    deadline = time.monotonic() + timeout_s
    out, failed = {}, {}
    try:
        for p in procs:
            p.start()
        while len(out) + len(failed) < world_size and not failed:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead and results.empty():
                    time.sleep(0.5)  # a rank's last put may still be in flight
                    if results.empty():
                        failed.update({r: f"exited with code {procs[r].exitcode}"
                                       for r in dead})
                continue
            (out if ok else failed)[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.1) if not failed else 1.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failed or len(out) < world_size:
        hung = [r for r in range(world_size) if r not in out and r not in failed]
        lines = [f"rank {r} failed:\n{failed[r]}" for r in sorted(failed)]
        if hung and failed:
            lines.append(f"ranks {hung} were terminated after that")
        elif hung:
            lines.append(f"ranks {hung} did not finish within {timeout_s} s "
                         f"(terminated)")
        raise RuntimeError("parallel launch failed:\n" + "\n".join(lines))
    return [out[r] for r in range(world_size)]
