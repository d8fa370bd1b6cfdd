"""Run a function on a world of ranks spawned on this host.

`run_ranks(fn, world_size, workdir)` starts one spawned process a rank.
Each sets the environment `torchrun` would (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE), joins a process group through a `file://` rendezvous
in `workdir` (no TCP port that two runs could both take), calls
`fn(rank, *args)` and saves what it returns to `workdir`. The caller
waits at most `timeout` seconds: a rank that fails or a world that does
not finish in time ends every rank and raises, so no run hangs. Used by
the tests (gloo ranks on the CPU) and `chip_smoke.py` (ranks sharing one
card); `fn` must be importable by name from a spawned process.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional, Sequence

import torch

__all__ = ["run_ranks"]


def _rank_main(rank, world, fn, args, workdir, backend, threads):
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method="file://" + os.path.join(workdir, "rendezvous"),
                            rank=rank, world_size=world)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(
    fn: Callable, world_size: int, workdir: str, args: Sequence = (), backend: str = "gloo",
    timeout: float = 120.0, threads: Optional[int] = None,
) -> List:
    """fn(rank, *args) on `world_size` spawned ranks; returns what each rank
    returned, in rank order.

    :param workdir an empty directory of the caller's for the rendezvous
        file and the results
    :param threads torch's intra-op threads a rank (None: torch's default)
    """
    import torch.multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    if os.path.exists(os.path.join(workdir, "rendezvous")):
        raise ValueError(f"{workdir} holds a rendezvous file of an earlier run")
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=_rank_main, args=(r, world_size, fn, tuple(args), workdir, backend, threads))
        for r in range(world_size)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.exitcode for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank {failed[0][0]} of {world_size} exited with {failed[0][1]}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks did not finish in {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world_size)]
