"""Build the port's native sources at first use and load them.

Each ``csrc/*.cu`` file (CUDA, ``nvcc`` for ``sm_90a``) or ``csrc/*.cpp``
file (host C++, ``g++``) exposes a plain C interface and compiles on its own
into a shared library under ``build/kernels/`` at the repository root (listed
in ``.gitignore``); the file name carries a hash of the source, the headers
(``*.cuh``, ``*.h``) beside it and the flags, so an edited source or header
rebuilds. A source's ``extra`` arguments (defines, include and library
paths, link libraries) follow it on the command line. Libraries load with
``ctypes``. A failed build raises with the compiler's output: nothing falls
back to a plain version.
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
from typing import Mapping, Optional, Sequence

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")

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


def gxx_path() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("g++ not found: a C++ compiler is needed to build "
                       "the port's host libraries")


def _command(src: Path, extra: Sequence[str], out: str) -> list[str]:
    if src.suffix == ".cu":
        return [nvcc_path(), *NVCC_FLAGS, "-o", out, str(src), *extra]
    return [gxx_path(), *HOST_FLAGS, "-o", out, str(src), *extra]


def _target(src: Path, extra: Sequence[str] = ()) -> Path:
    flags = NVCC_FLAGS if src.suffix == ".cu" else HOST_FLAGS
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join((*flags, *extra)).encode())
    for pattern in ("*.cuh", "*.h"):
        for header in sorted(src.parent.glob(pattern)):
            digest.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build(sources: list[Path],
          extra: Optional[Mapping[Path, Sequence[str]]] = None) -> list[Path]:
    """Compile every source not yet built, one compiler process each, all
    at once; ``extra[src]`` holds the arguments that follow ``src``."""
    extra = extra or {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        args = tuple(extra.get(src, ()))
        out = _target(src, args)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = _command(src, args, tmp)
        jobs.append((src, out, tmp, cmd[0],
                     subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, out, tmp, compiler, proc in jobs:
        log, _ = proc.communicate()
        build_logs[str(src)] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"{os.path.basename(compiler)} failed on {src} "
                          f"(rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [_target(src, tuple(extra.get(src, ()))) for src in sources]


def load(src: Path, extra: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load one source's library, once per process."""
    key = str(src)
    with _lock:
        if key not in _loaded:
            (path,) = build([src], {src: extra})
            _loaded[key] = ctypes.CDLL(str(path))
        return _loaded[key]
