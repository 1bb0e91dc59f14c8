"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/*.cu`` file exposes a plain C interface and compiles on its own
into a shared library under ``build/kernels/`` at the repository root (listed
in ``.gitignore``); the file name carries a hash of the source, the headers
(``*.cuh``) beside it and the flags, so an edited source or header
rebuilds. Libraries load with ``ctypes``. A failed build raises with the
compiler's output: nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each library built in
# this process, keyed by source path
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(src.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build(sources: list[Path]) -> list[Path]:
    """Compile every source not yet built, one ``nvcc`` each, all at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        out = _target(src)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
        jobs.append((src, out, tmp,
                     subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        build_logs[str(src)] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {src} (rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [_target(src) for src in sources]


def load(src: Path) -> ctypes.CDLL:
    """Build (if needed) and load one source's library, once per process."""
    key = str(src)
    with _lock:
        if key not in _loaded:
            (path,) = build([src])
            _loaded[key] = ctypes.CDLL(str(path))
        return _loaded[key]
