"""Spawn the ranks of one process group and collect what each returns.

``start(target, nproc, payload, workdir=...)`` starts ``nproc`` fresh
Python processes (``python -m ppt_torch.parallel.launch``), each of which
joins one group through a ``file://`` rendezvous under ``workdir`` (no TCP
port, so concurrent launches never race for one), selects its device,
runs ``target`` (``"module:function"``, called as ``fn(rank, world,
device, payload)``) and saves its result to ``workdir``; ``wait()``
returns the results in rank order, or raises with the failing ranks'
output. A child imports ``ppt_torch`` and what ``target`` imports, never
its parent's modules: the tests, the dry run and ``chip_smoke.py`` share
this helper.

Build the CUDA kernels before starting ranks on the card
(``kernels._build.build_all``): each rank then only loads the libraries.
"""

from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

REPO = Path(__file__).resolve().parent.parent.parent


class Launch:
    """The running ranks of one ``start``."""

    def __init__(self, procs: List[subprocess.Popen], outs: List[Path], logs: List[Path],
                 timeout: float):
        self.procs, self.outs, self.logs = procs, outs, logs
        self.deadline = time.monotonic() + timeout
        self.seconds = None
        self._t0 = time.perf_counter()

    def wait(self) -> List[Any]:
        """Each rank's result, in rank order; every rank is stopped first."""
        failed = []
        try:
            for r, p in enumerate(self.procs):
                left = max(self.deadline - time.monotonic(), 1.0)
                try:
                    rc = p.wait(timeout=left)
                except subprocess.TimeoutExpired:
                    failed.append((r, "timed out"))
                    break
                if rc != 0:
                    failed.append((r, f"exit {rc}"))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        self.seconds = time.perf_counter() - self._t0
        if failed:
            tails = "\n".join(f"--- rank {r} ({why}) ---\n{_tail(self.logs[r])}"
                              for r, why in failed)
            raise RuntimeError(f"{len(failed)} rank(s) failed:\n{tails}")
        return [torch.load(o, weights_only=False) for o in self.outs]


def _tail(path: Path, n: int = 6000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return "(no output)"


def start(target: str, nproc: int, payload: Any, *, workdir: str, backend: str = "gloo",
          device: str = "cpu", timeout: float = 600.0, init: bool = True,
          env: Optional[Dict[str, str]] = None) -> Launch:
    """Start ``nproc`` ranks of ``target`` on ``device`` ("cpu", or "cuda":
    rank r on ``cuda:{r % device_count}``) over ``backend``, each on one
    intra-op thread (ranks share the host's cores). With ``init=False`` the
    child does not join a group itself: ``env`` then carries what the
    target's ``init_multihost`` reads."""
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    stamp = f"{os.getpid()}_{time.monotonic_ns()}"
    payload_path = work / f"payload_{stamp}.pt"
    torch.save(payload, payload_path)
    rendezvous = work / f"rendezvous_{stamp}"
    procs, outs, logs = [], [], []
    for r in range(nproc):
        out, log = work / f"rank{r}_{stamp}.pt", work / f"rank{r}_{stamp}.log"
        child_env = dict(os.environ, LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(nproc),
                         OMP_NUM_THREADS="1", **(env or {}))
        cmd = [sys.executable, "-m", "ppt_torch.parallel.launch", "--target", target,
               "--rank", str(r), "--world", str(nproc), "--backend", backend,
               "--device", device, "--payload", str(payload_path),
               "--out", str(out)]
        if init:
            cmd += ["--init", f"file://{rendezvous}"]
        with open(log, "w") as f:
            procs.append(subprocess.Popen(cmd, cwd=str(REPO), env=child_env, stdout=f,
                                          stderr=subprocess.STDOUT))
        outs.append(out)
        logs.append(log)
    return Launch(procs, outs, logs, timeout)


def spawn(target: str, nproc: int, payload: Any, **kw) -> List[Any]:
    """``start(...).wait()``."""
    return start(target, nproc, payload, **kw).wait()


def _child(argv=None) -> None:
    import torch.distributed as dist

    p = argparse.ArgumentParser()
    for flag in ("--target", "--backend", "--device", "--payload", "--out"):
        p.add_argument(flag, required=True)
    p.add_argument("--init", default="")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    a = p.parse_args(argv)
    torch.set_num_threads(1)
    device = "cpu"
    if a.device == "cuda":
        torch.cuda.set_device(a.rank % torch.cuda.device_count())
        device = f"cuda:{torch.cuda.current_device()}"
    if a.init:
        dist.init_process_group(a.backend, init_method=a.init, world_size=a.world, rank=a.rank)
    module, name = a.target.split(":")
    fn = getattr(importlib.import_module(module), name)
    payload = torch.load(a.payload, weights_only=False)
    result = fn(a.rank, a.world, device, payload)
    tmp = a.out + ".tmp"
    torch.save(result, tmp)
    os.replace(tmp, a.out)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    _child()
