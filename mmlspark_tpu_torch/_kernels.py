"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface, which is loaded with ``ctypes``
(pointers and the stream pass as ``c_void_p``). Libraries land in
``build/torch_kernels/`` beside the package (``MMLSPARK_TORCH_BUILD_DIR``
overrides), named by a hash of the source, the shared headers and the
flags, so an edited source rebuilds and an unchanged one loads at once.

Nothing here runs at import: a library is built on the first launch of a
kernel in it, or by ``build_all()``, which starts one ``nvcc`` per source
at the same time. Each C entry point returns ``cudaGetLastError()``;
``check()`` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ``nvcc`` output per source (``-Xptxas -v``: registers, shared memory)
build_logs: Dict[str, str] = {}


def build_dir() -> Path:
    return Path(os.environ.get("MMLSPARK_TORCH_BUILD_DIR",
                               str(_PKG.parent / "build" / "torch_kernels")))


def sources() -> List[str]:
    """Kernel names: one per ``csrc/<name>.cu``."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a host with "
                       "the CUDA toolkit (PATH or CUDA_HOME)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((SRC_DIR / f"{name}.cu").read_bytes())
    for hdr in sorted(SRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start_build(name: str, out: Path) -> subprocess.Popen:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(SRC_DIR), "-o", str(tmp),
           str(SRC_DIR / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish_build(name: str, out: Path, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    build_logs[name] = log
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)   # atomic: concurrent builders never see half a file


def build_all(names: Optional[List[str]] = None) -> float:
    """Build every missing library in parallel (one ``nvcc`` per source),
    load them all, and return the seconds spent."""
    t0 = time.perf_counter()
    names = list(names or sources())
    with _lock:
        todo = [(n, _lib_path(n)) for n in names if n not in _libs]
        procs = [(n, out, _start_build(n, out)) for n, out in todo
                 if not out.exists()]
        for n, out, proc in procs:
            _finish_build(n, out, proc)
        for n, out in todo:
            _libs[n] = ctypes.CDLL(str(out))
    return time.perf_counter() - t0


def ptxas_summary(log: str) -> List[dict]:
    """Per kernel instantiation in an ``nvcc -Xptxas -v`` log: its mangled
    name, registers a thread, spill stores and loads (bytes) and static
    shared memory, and ptxas's warnings and performance notes about it
    (such as a ``wgmma`` pipeline it had to serialise, C7510-C7520)."""
    out: Dict[str, dict] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = out.setdefault(m.group(1), {"function": m.group(1),
                                                  "warnings": []})
            continue
        if "arning" in line or re.search(r"\(C75\d\d\)", line):
            m = re.search(r"function '([^']+)'", line)
            name = m.group(1) if m else (current or {}).get("function")
            entry = out.setdefault(name, {"function": name, "warnings": []})
            entry["warnings"].append(line.strip())
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers(?:, (\d+) bytes smem)?", line)
        if m:
            current["registers"] = int(m.group(1))
            current["smem"] = int(m.group(2) or 0)
    return list(out.values())


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        build_all([name])
    return _libs[name]


def check(code: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, as the kernels take it."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
