"""Start the processes of a mesh on this host and collect what each returns.

``spawn("module:function", world, ...)`` starts ``world`` fresh Python
processes (never forked: a process that touches CUDA must not inherit a
parent's CUDA state). Each joins the process group through a file
rendezvous in ``workdir`` (no TCP port, so concurrent launches never
collide), builds its ``Mesh`` (``make_mesh(MeshSpec(data=world), device,
backend)``), calls ``function(mesh, **kwargs)`` and pickles the result.
The parent waits for all of them up to ``timeout`` seconds; a process that
fails, exits nonzero or is still running at the limit fails the launch,
and every process still running is killed. There is no retry and no
fallback to fewer processes.

``device``: ``"cpu"``, ``"cuda"`` (rank r on ``cuda:r``) or one card for
every rank (``"cuda:0"``, which needs ``backend="gloo"`` named).
The function runs inside ``runtime.on_device`` of the rank's device, so
the entry points it calls default to it. ``threads`` sets
``torch.set_num_threads`` in each process. Run a rank by
hand with ``python -m mmlspark_tpu_torch.parallel.launch <spec> <rank>``.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence


class LaunchError(RuntimeError):
    """A rank failed, exited nonzero or passed the launch's time limit."""


def _rank_device(device: str, rank: int) -> str:
    return f"cuda:{rank}" if device == "cuda" else device


def spawn(target: str, world: int, workdir, kwargs: Optional[dict] = None,
          device: str = "cpu", backend: Optional[str] = None,
          timeout: float = 120.0, threads: Optional[int] = None,
          path: Sequence[str] = (), env: Optional[Dict[str, str]] = None
          ) -> List[Any]:
    """Run ``target`` (``"module:function"``) in ``world`` processes; returns
    each rank's result, in rank order. ``path``: directories put in front of
    the children's ``sys.path`` (where ``module`` lives); ``env``: extra
    environment. Raises ``LaunchError`` with the failing ranks' output."""
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}_{time.monotonic_ns()}"
    rdv = work / f"rdv_{tag}"
    spec = work / f"spec_{tag}.pkl"
    spec.write_bytes(pickle.dumps(dict(
        target=target, world=world, kwargs=kwargs or {}, device=device,
        backend=backend, threads=threads, timeout=timeout,
        rdv=f"file://{rdv}", out=str(work / f"out_{tag}"))))
    child_env = dict(os.environ)
    child_env.update(env or {})
    root = str(Path(__file__).resolve().parents[2])
    child_env["PYTHONPATH"] = os.pathsep.join(
        [*map(str, path), root, child_env.get("PYTHONPATH", "")]).rstrip(
        os.pathsep)
    procs, logs = [], []
    try:
        for r in range(world):
            log = open(work / f"rank{r}_{tag}.log", "w+b")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "mmlspark_tpu_torch.parallel.launch",
                 str(spec), str(r)], stdout=log, stderr=subprocess.STDOUT,
                env={**child_env, "LOCAL_RANK": str(r)}))
        deadline = time.monotonic() + timeout
        failed = []
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = [r for r, c in enumerate(codes) if c is None]
                raise LaunchError(_report(
                    f"ranks {failed} still running after {timeout} s", failed,
                    logs))
            time.sleep(0.05)
        if failed:
            raise LaunchError(_report(f"ranks {failed} failed", failed, logs))
        return [pickle.loads(Path(f"{work}/out_{tag}_{r}.pkl").read_bytes())
                for r in range(world)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()


def _report(what: str, ranks: List[int], logs) -> str:
    parts = [what]
    for r in ranks or range(len(logs)):
        logs[r].flush()
        logs[r].seek(0)
        tail = logs[r].read()[-4000:].decode(errors="replace")
        parts.append(f"--- rank {r} ---\n{tail}")
    return "\n".join(parts)


def _run_rank(spec_path: str, rank: int) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    from ..runtime import on_device
    from .mesh import MeshSpec, make_mesh

    spec = pickle.loads(Path(spec_path).read_bytes())
    if spec["threads"]:
        torch.set_num_threads(int(spec["threads"]))
    device = _rank_device(spec["device"], rank)
    backend = spec["backend"] or ("nccl" if device.startswith("cuda")
                                  else "gloo")
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(
        backend, init_method=spec["rdv"], world_size=spec["world"],
        rank=rank, timeout=datetime.timedelta(seconds=spec["timeout"]))
    try:
        mesh = make_mesh(MeshSpec(data=spec["world"]), device=device,
                         backend=backend)
        mod, fn = spec["target"].split(":")
        with on_device(mesh.device):
            result = getattr(importlib.import_module(mod), fn)(
                mesh, **spec["kwargs"])
        out = Path(f"{spec['out']}_{rank}.pkl")
        tmp = out.with_suffix(".tmp")
        tmp.write_bytes(pickle.dumps(result))
        tmp.replace(out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _run_rank(sys.argv[1], int(sys.argv[2]))
