"""Start a world of ranks on one host: one process per rank.

Nothing on a host tells a program of a cluster, so the caller names the
world: ``run_world`` starts ``world`` copies of a command with ``RANK`` and
``WORLD_SIZE`` in their environment and waits for all of them; each copy
calls ``init_rank`` with a rendezvous file that all of them share (a file
under a temporary directory: no port is taken, so worlds started side by
side do not meet). Every wait has a time limit: a rank that fails or hangs
ends the world, and ``run_world`` raises with each rank's output.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import torch.distributed as dist


def init_rank(init_file: str, backend: str = "gloo",
              timeout_s: float = 120.0) -> int:
    """Join the world named by ``RANK`` and ``WORLD_SIZE`` through the
    rendezvous file ``init_file``; every collective then fails after
    ``timeout_s`` instead of hanging. Returns this rank."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        backend, init_method="file://" + os.path.abspath(init_file),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return rank


def run_world(argv: Sequence[str], world: int, log_dir: str, *,
              timeout_s: float = 300.0,
              env: Optional[Dict[str, str]] = None) -> List[str]:
    """Run ``python *argv`` as ranks 0 .. world-1 and wait for all; returns
    each rank's output (stdout and stderr, kept in ``log_dir``). Raises if
    a rank exits non-zero, or all are still running after ``timeout_s``;
    the other ranks are killed first."""
    os.makedirs(log_dir, exist_ok=True)
    logs = [os.path.join(log_dir, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, *argv], stdout=out, stderr=subprocess.STDOUT,
                env={**os.environ, **(env or {}), "RANK": str(r),
                     "WORLD_SIZE": str(world)}))
    deadline = time.monotonic() + timeout_s
    failed = None
    while failed is None and any(p.poll() is None for p in procs):
        bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if bad:
            failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
        elif time.monotonic() > deadline:
            failed = f"the world was still running after {timeout_s:.0f} s"
        else:
            time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    if failed is None and any(p.returncode for p in procs):
        r = next(r for r, p in enumerate(procs) if p.returncode)
        failed = f"rank {r} exited {procs[r].returncode}"
    outputs = []
    for path in logs:
        with open(path) as f:
            outputs.append(f.read())
    if failed is not None:
        tails = "\n".join(f"--- rank {r} ---\n{o[-4000:]}"
                          for r, o in enumerate(outputs))
        raise RuntimeError(f"{' '.join(argv)}: {failed}\n{tails}")
    return outputs
