"""Run one function on several ranks, each a child process.

    results = launch.run("sigman_release_torch.training.cases:vae_case",
                         world=2, kwargs={...}, device="cpu", timeout=300)

Each child runs ``python -m sigman_release_torch.parallel.launch``: it joins
a process group of ``world`` ranks through a ``file://`` rendezvous in a
directory of its own (no port to collide with another run), calls the
target with ``kwargs`` (and ``device=`` its device, where the target takes
one) and saves what it returns. ``device`` is ``"cpu"``, ``"cuda"`` (rank r
on ``cuda:r``) or one card that every rank shares (``"cuda:0"``, over
gloo: NCCL refuses two ranks on one device). A target is
``"package.module:function"`` or ``"path/to/file.py:function"``.

The parent gives the children one deadline: a child that exits non-zero
fails the run at once, one still running at the deadline fails it too, and
every child left is killed. No rank carries on alone.
"""

from __future__ import annotations

import importlib
import importlib.util
import inspect
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class RankFailure(RuntimeError):
    """A child rank exited non-zero or outlived the run's deadline."""


def _tail(path: str, n: int = 4000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def run(target: str, world: int, kwargs: Optional[dict] = None, *,
        device: str = "cpu", backend: str = "gloo", timeout: float = 600.0,
        threads: int = 2, workdir: Optional[str] = None) -> list:
    """``target(**kwargs)`` on ranks 0..world-1; returns their results by
    rank. ``threads`` caps each child's intra-op threads. Raises
    ``RankFailure`` with the failing child's output."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        torch.save(kwargs or {}, os.path.join(tmp, "kwargs.pt"))
        env = {**os.environ, "OMP_NUM_THREADS": str(threads),
               "PYTHONPATH": os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
        procs, logs = [], []
        try:
            for r in range(world):
                log = os.path.join(tmp, f"rank{r}.log")
                logs.append(log)
                with open(log, "w") as out:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", __name__, target, tmp, str(r),
                         str(world), device, backend, str(threads)],
                        stdout=out, stderr=subprocess.STDOUT, env=env,
                        cwd=ROOT))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.poll() not in (None, 0)]
                if failed:
                    r = failed[0]
                    raise RankFailure(
                        f"{target}: rank {r} of {world} exited with "
                        f"{procs[r].returncode}:\n{_tail(logs[r])}")
                if time.monotonic() > deadline:
                    raise RankFailure(
                        f"{target}: {world} rank(s) still running after "
                        f"{timeout} s:\n{_tail(logs[0])}")
                time.sleep(0.1)
            for r, p in enumerate(procs):
                if p.returncode:
                    raise RankFailure(
                        f"{target}: rank {r} of {world} exited with "
                        f"{p.returncode}:\n{_tail(logs[r])}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return [torch.load(os.path.join(tmp, f"result{r}.pt"),
                           weights_only=False) for r in range(world)]


def _load(target: str):
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            os.path.splitext(os.path.basename(where))[0], where)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _child(target, tmp, rank, world, device, backend, threads):
    import torch.distributed as dist

    from sigman_release_torch.parallel.mesh import initialize_multihost

    rank, world = int(rank), int(world)
    torch.set_num_threads(int(threads))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank)
    dev = initialize_multihost(dev, backend=backend,
                               init_method=f"file://{tmp}/rendezvous",
                               rank=rank, world_size=world)
    fn = _load(target)
    kwargs = torch.load(os.path.join(tmp, "kwargs.pt"), weights_only=False)
    if "device" in inspect.signature(fn).parameters:
        kwargs["device"] = dev
    result = fn(**kwargs)
    part = os.path.join(tmp, f"result{rank}.part")
    torch.save(result, part)
    os.replace(part, os.path.join(tmp, f"result{rank}.pt"))
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    _child(*sys.argv[1:])
