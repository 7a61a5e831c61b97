"""The port's native host code: the LZF decoder of binary_compressed PCD
files (`native/lzf.cpp`, the port's copy of the JAX package's), compiled
with g++ at first use into `build/egonn_tpu_torch/` beside the package,
under a name that carries a hash of the source and flags, and loaded with
ctypes.  A failed build raises; `data/pcd.py::lzf_decompress_plain` is the
plain Python decoder the tests hold it against.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "egonn_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lzf = None


def build(source: str) -> Path:
    """Compile native/<source> into a shared library (unless built) and
    return its path; raises with the compiler's output on failure."""
    src = NATIVE_DIR / source
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    lib = BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's LZF decoder is built with it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {source} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib


def lzf_decompress(data: bytes, expected_size: int) -> bytes:
    """LZF-decode `data` into exactly `expected_size` bytes with the native
    decoder; ValueError on a corrupt stream or a size mismatch."""
    global _lzf
    if _lzf is None:
        lib = ctypes.CDLL(str(build("lzf.cpp")))
        lib.lzf_decompress.restype = ctypes.c_size_t
        lib.lzf_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                                       ctypes.c_size_t]
        _lzf = lib
    out = ctypes.create_string_buffer(expected_size)
    n = _lzf.lzf_decompress(data, len(data), out, expected_size)
    if n != expected_size:
        raise ValueError(f"lzf: corrupt stream or size mismatch: {n} bytes decoded, "
                         f"expected {expected_size}")
    return out.raw
