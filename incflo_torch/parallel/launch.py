"""Run one job on R ranks of an x-slab mesh on this host.

    from incflo_torch.parallel import launch
    results = launch.run("incflo_torch.parallel.workers:steps", 2,
                         dict(deck=text, nsteps=3))        # on the card
    results = launch.run(..., device="cpu")                # on the CPU

Each rank is a fresh `python -m incflo_torch.parallel.launch` process.
It joins a torch.distributed process group through a FileStore in a
temporary directory (no network address is needed), builds a SlabMesh,
calls the job as job(mesh, **kwargs) and saves what it returns with
torch.save; run() returns the ranks' results in rank order.  A rank that
fails, or a run that is not over within `timeout` seconds, fails the
whole run: every rank is killed and run() raises with the ranks' error
output; so does setting `cancel` (a threading.Event) from another
thread while run() waits.  The job is named by its module and function, so a rank imports
that module and incflo_torch alone (never the caller's module).

Backends: device "cpu" runs gloo.  device None or "cuda" (the default:
the card, and run() raises where there is none) runs NCCL with one GPU
a rank where the host has at least R GPUs; with fewer, the ranks share
the cards (rank r on cuda:{r % count}) and run gloo, whose exchanges go
through host buffers, and run() prints which one it chose.  Before
spawning, a CUDA run builds the kernel libraries of incflo_torch/csrc,
so the ranks only load them and never compile into one directory at
once.
"""

from __future__ import annotations

import datetime
import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

ROOT = Path(__file__).resolve().parent.parent.parent


def choose_backend(nranks: int, device: str) -> str:
    if device == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("launch: the ranks run on the card (device "
                           "'cuda'), but torch.cuda is not available; pass "
                           "device='cpu' to run them on the CPU")
    return "nccl" if torch.cuda.device_count() >= nranks else "gloo"


def run(job: str, nranks: int, kwargs: Optional[Dict[str, Any]] = None,
        device: Optional[str] = None, timeout: float = 120.0,
        cancel=None) -> List[Any]:
    """job "module:function" on nranks ranks; returns their results.
    device None means "cuda".  A CPU rank runs torch on one thread.
    cancel: an Event whose setting kills the ranks (run() raises)."""
    device = "cuda" if device is None else device
    if device not in ("cpu", "cuda"):
        raise ValueError(f"launch: device must be 'cpu' or 'cuda', not "
                         f"{device!r}")
    backend = choose_backend(nranks, device)
    if device == "cuda":
        from incflo_torch.ops import cuda_build
        cuda_build.build_all(sorted(cuda_build.CSRC_DIR.glob("*.cu")))
        print(f"[launch] {nranks} ranks, backend {backend}: "
              + ("one GPU a rank" if backend == "nccl" else
                 f"the ranks share {torch.cuda.device_count()} card(s); "
                 "halos and reductions go through host buffers"),
              flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="incflo_ranks_"))
    try:
        spec = tmp / "spec.pt"
        torch.save({"job": job, "kwargs": kwargs or {}, "nranks": nranks,
                    "backend": backend, "device": device,
                    "store": str(tmp / "store"), "timeout": timeout,
                    "out": str(tmp)}, spec)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                           else []))
        procs, logs = [], []
        for r in range(nranks):
            log = open(tmp / f"rank{r}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "incflo_torch.parallel.launch",
                 str(spec), str(r)], stdout=log, stderr=subprocess.STDOUT,
                env=env, cwd=str(ROOT)))
        try:
            _join(procs, timeout, tmp, cancel)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(nranks)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _join(procs, timeout, tmp, cancel=None):
    deadline = time.monotonic() + timeout
    while True:
        if cancel is not None and cancel.is_set():
            raise RuntimeError("launch: cancelled")
        codes = [p.poll() for p in procs]
        bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            raise RuntimeError(f"launch: rank {bad[0]} exited with "
                               f"{codes[bad[0]]}:\n{_tail(tmp, bad[0])}")
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            late = [r for r, c in enumerate(codes) if c is None]
            raise TimeoutError(f"launch: ranks {late} still running after "
                               f"{timeout} s:\n{_tail(tmp, late[0])}")
        time.sleep(0.05)


def _tail(tmp, rank, nbytes=6000):
    try:
        return (tmp / f"rank{rank}.log").read_text()[-nbytes:]
    except OSError:
        return "(no output)"


def _worker(spec_path: str, rank: int) -> None:
    import torch.distributed as dist
    from incflo_torch.parallel.mesh import SlabMesh
    spec = torch.load(spec_path, weights_only=False)
    n = spec["nranks"]
    if spec["device"] == "cuda":
        device = torch.device(f"cuda:{rank % torch.cuda.device_count()}")
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    store = dist.FileStore(spec["store"], n)
    dist.init_process_group(
        spec["backend"], store=store, rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=spec["timeout"]))
    try:
        mesh = SlabMesh(device=device)
        module, name = spec["job"].split(":")
        fn = getattr(importlib.import_module(module), name)
        result = fn(mesh, **spec["kwargs"])
        out = Path(spec["out"]) / f"rank{rank}.pt"
        torch.save(result, out.with_suffix(".tmp"))
        os.replace(out.with_suffix(".tmp"), out)
        mesh.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]))
