"""ctypes bridge to the port's threaded JPEG / PNG decoder
(``data/csrc/loader.cpp``).

Decode + bilinear resize run in C++ threads, off the GIL: the input
pipeline's hot path, which the reference spreads over DataLoader worker
processes. The library is built with ``g++`` at first use
(``utils/cuda_build.py``, into the git-ignored ``build/kernels/``) and
linked against zlib and one JPEG library: libjpeg where the compiler finds
``jpeglib.h``, else nvJPEG from the CUDA toolkit. A failed build raises with
the compiler's log; there is no other decoder to fall back to.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from sigman_release_torch.utils import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "loader.cpp"
CUDA_HOME = os.environ.get("CUDA_HOME", "/usr/local/cuda")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _has_header(name: str, include: Sequence[str] = ()) -> bool:
    """Whether the C++ compiler finds ``<name>`` (with ``include`` dirs)."""
    res = subprocess.run(
        [cuda_build.gxx_path(), "-E", "-x", "c++", "-", "-o", os.devnull,
         *(f"-I{d}" for d in include)],
        input=f"#include <{name}>\n", capture_output=True, text=True)
    return res.returncode == 0


def build_args() -> tuple:
    """The arguments after the source: libjpeg where its header is found,
    else nvJPEG and the CUDA runtime of ``CUDA_HOME``; zlib either way."""
    if _has_header("jpeglib.h"):
        return ("-ljpeg", "-lz")
    inc, lib = os.path.join(CUDA_HOME, "include"), os.path.join(CUDA_HOME,
                                                                "lib64")
    if _has_header("nvjpeg.h", [inc]):
        return ("-DSLR_NVJPEG", f"-I{inc}", f"-L{lib}", f"-Wl,-rpath,{lib}",
                "-lnvjpeg", "-lcudart", "-lz")
    raise RuntimeError(
        "no JPEG library to build the decoder against: neither libjpeg's "
        f"jpeglib.h nor nvJPEG's nvjpeg.h (under {inc}) is found")


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = cuda_build.load(SOURCE, build_args())
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.slr_init.restype = ctypes.c_int
        lib.slr_jpeg_backend.restype = ctypes.c_char_p
        lib.slr_decode_file.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int]
        lib.slr_decode_file.restype = ctypes.c_int
        lib.slr_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, f32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.slr_decode_batch.restype = ctypes.c_int
        rc = lib.slr_init()
        if rc != 0:
            raise RuntimeError(
                f"the {lib.slr_jpeg_backend().decode()} decoder failed to "
                f"start (rc {rc}): nvJPEG needs a CUDA device")
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the decoder builds and starts here."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def jpeg_backend() -> str:
    """"libjpeg" or "nvjpeg": the JPEG library the decoder was built on."""
    return _load().slr_jpeg_backend().decode()


def decode_image(path: str, target_h: int, target_w: int,
                 channels: int = 3) -> np.ndarray:
    """Decode + resize one image -> [H,W,C] float32 in [0,1]; raises
    ``IOError`` if the file cannot be read or decoded."""
    out = np.empty((target_h, target_w, channels), np.float32)
    rc = _load().slr_decode_file(
        os.fsencode(path), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        target_h, target_w, channels)
    if rc != 0:
        raise IOError(f"decode failed ({rc}): {path}")
    return out


def decode_batch(paths: Sequence[str], target_h: int, target_w: int,
                 channels: int = 3, n_threads: int = 4) -> np.ndarray:
    """Decode + resize many images concurrently -> [N,H,W,C] float32.

    A file that cannot be read or decoded comes back as zeros (the reference
    dataloader's try/except fallback); the return is always dense.
    """
    n = len(paths)
    out = np.empty((n, target_h, target_w, channels), np.float32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    _load().slr_decode_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        target_h, target_w, channels, n_threads)
    return out
