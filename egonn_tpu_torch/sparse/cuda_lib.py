"""Builds the port's CUDA kernels (`egonn_tpu_torch/csrc/*.cu`) with `nvcc`
at first use and loads them with `ctypes`.

Each `.cu` file becomes its own shared library with a plain C interface,
compiled for Hopper (`sm_90a`) into `build/egonn_tpu_torch/` beside the
package, under a name that carries a hash of the sources and flags, so a
changed source is rebuilt and an unchanged one is reused.  All sources are
compiled in parallel, one `nvcc` each, and nvcc's `-Xptxas -v` report (registers
and spills per kernel) is kept beside each library as `<name>.ptxas.txt`, so a
cached build still reports it.  The bf16 bodies' cut-out variants, which
only `probe_kernels.py` times, are built into libraries of their own
(`probe_function`), never into the ones the port runs.  The entry points
only queue launches and hold the GIL while they do.  Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "egonn_tpu_torch"
SOURCES = ("zrun.cu", "gather_conv.cu", "tdown.cu", "gather_dw.cu", "lookup.cu", "stem.cu",
           "tconv.cu", "tconv_dw.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream as void*, every size as int
SIGNATURES = {
    "zrun.cu": {
        "egonn_zrun_presence": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "egonn_zrun_rank": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "gather_conv.cu": {  # the bf16 entry point adds the body
        "egonn_gather_conv": [_P, _P, _P, _P, _P, _P, _P, _P] + [_I] * 9 + [_P],
        "egonn_gather_conv_bf16": [_P, _P, _P, _P, _P, _P, _P, _P] + [_I] * 10 + [_P],
    },
    "tdown.cu": {
        **{name: [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
           for name in ("egonn_tdown", "egonn_tdown_bf16")},
        "egonn_tdown_hulls": [_P, _P, _I, _I, _I, _I, _P],
    },
    "gather_dw.cu": {  # the bf16 entry point adds the body
        "egonn_gather_dw": [_P, _P, _P, _P, _P] + [_I] * 9 + [_P],
        "egonn_gather_dw_bf16": [_P, _P, _P, _P, _P] + [_I] * 10 + [_P],
    },
    "lookup.cu": {  # host arrays of per-level pointers and sizes, then scalars
        "egonn_lookup": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    },
    "stem.cu": {
        "egonn_stem_ones": [_P, _P, _P] + [_I] * 6 + [_P],
    },
    "tconv.cu": {
        "egonn_tconv": [_P] * 6 + [_I] * 6 + [_P],
        "egonn_slot_order": [_P] * 4 + [_I] * 3 + [_P],
    },
    "tconv_dw.cu": {
        "egonn_tconv_dw": [_P] * 7 + [_I] * 8 + [_P],
    },
}

# The bf16 bodies' cut-out variants (csrc/bf16.cuh), built only for
# probe_kernels.py into libraries of their own with EGONN_PROBE_CUTS defined:
# their extra entry points take the cut-out and, for the conv, the room for
# the SM80 body's compacted lists.
PROBE_FLAGS = ("-DEGONN_PROBE_CUTS",)
PROBE_SIGNATURES = {
    "gather_conv.cu": {"egonn_gather_conv_bf16_cut": [_P] * 8 + [_I] * 11 + [_P, _P]},
    "gather_dw.cu": {"egonn_gather_dw_bf16_cut": [_P] * 5 + [_I] * 11 + [_P]},
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_PROBE_LIBS: Dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None  # wall time of the last build_all()
ptxas_log: Dict[str, str] = {}      # nvcc's -Xptxas -v report per source (build_all)


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _library_path(source: str, extra_flags: tuple = ()) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + extra_flags).encode())
    h.update((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    stem = Path(source).stem + ("-probe" if extra_flags else "")
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def _log_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def _compile(sources, extra_flags: tuple = ()) -> None:
    """Compile (in parallel) those of `sources` whose library is not built
    yet.  Raises with nvcc's output on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        lib = _library_path(src, extra_flags)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *extra_flags, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), tmp, lib)
    failed = []
    for src, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{log}")
        else:
            _log_path(lib).write_text(log)  # before the library: a library implies its log
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def _load(path: Path, signatures: dict) -> ctypes.CDLL:
    # PyDLL keeps the GIL through a call: each entry point only queues
    # launches, and a CDLL call's release and re-acquire would hand the
    # GIL to the training loop's prefetch thread at every launch
    lib = ctypes.PyDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile (in parallel) whatever is not built yet, load every library,
    bind its C signatures and read each source's ptxas report into
    `ptxas_log`.  Raises with nvcc's output on a failed build."""
    global build_seconds
    if len(_LIBS) == len(SOURCES):
        return _LIBS
    t0 = time.perf_counter()
    _compile(SOURCES)
    for src in SOURCES:
        path = _library_path(src)
        _LIBS[src] = _load(path, SIGNATURES[src])
        ptxas_log[src] = _log_path(path).read_text() if _log_path(path).exists() else ""
    build_seconds = time.perf_counter() - t0
    return _LIBS


def probe_function(source: str, name: str):
    """The bound entry point `name` (one of SIGNATURES' or PROBE_SIGNATURES')
    of `source`'s cut-out build, building both cut-out libraries on first
    use."""
    if not _PROBE_LIBS:
        _compile(tuple(PROBE_SIGNATURES), PROBE_FLAGS)
        for src, extra in PROBE_SIGNATURES.items():
            _PROBE_LIBS[src] = _load(_library_path(src, PROBE_FLAGS),
                                     {**SIGNATURES[src], **extra})
    return getattr(_PROBE_LIBS[source], name)


def function(source: str, name: str):
    """The bound C entry point `name` of `source`, building on first use."""
    return getattr(build_all()[source], name)
