"""Build the CUDA sources under ``csrc/`` with nvcc and bind them through ctypes.

Each source becomes one shared library with a plain C interface, compiled for
``sm_90a`` at first use into ``repro_torch/_build/`` (listed in .gitignore).
A library's file name carries a hash of its sources and flags, so an edited
source is rebuilt and a built one is loaded as it is. All missing libraries
are compiled at once, one nvcc process per source. nvcc's output (ptxas
reports each kernel's registers, static shared memory and spills) is kept
beside its library as ``<library>.ptxas.log``, so a library found built still
has its figures (:func:`ptxas_log`; ``repro_torch.analysis.resources`` reads
them).

The entry points return a ``cudaError_t`` from ``cudaGetLastError()`` after
each launch; :func:`check` raises on any non-zero code. Nothing here is
imported or compiled until a kernel is launched on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..device import ARCH, BUILD_DIR

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fz_compress.cu", "fz_decompress.cu", "fz_staged.cu", "flash_decode.cu")
HEADERS = ("fz_common.cuh", "fz_windows.cuh")
# no --use_fast_math: the kernels need IEEE divides and multiplies
NVCC_FLAGS = ("-gencode", f"arch=compute_{ARCH[3:]},code={ARCH}", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "fz_compress.cu": {
        "fz_fused_compress": [_P, _I, _I, _L, _L, _L, _P, _I, _P, _P, _L, _P, _P, _P],
        "fz_fused_compress_strict": [_P, _I, _I, _L, _L, _L, _P, _I, _P, _P, _L, _P, _P, _P,
                                     _L, _P, _P, _P],
        "fz_fused_shuffle_encode": [_P, _L, _P, _P, _L, _P, _P, _P],
        "fz_fused_shuffle_encode_ctas": [],
        "fz_fused_compress_smem": [_I, _I, _L, _L, _L, _I],
        "fz_fused_compress_strict_smem": [_I, _I, _L, _L, _L, _I],
    },
    "fz_decompress.cu": {
        "fz_fused_decompress": [_P, _P, _L, _P, _I, _I, _L, _L, _L, _P, _P, _L, _P, _P,
                                _P],
        "fz_decompress_scratch_words": [_L, _I],
        "fz_scan_columns_smem": [_I],
    },
    "fz_staged.cu": {
        "fz_lorenzo_quant": [_P, _I, _I, _L, _L, _L, _P, _I, _P, _P],
        "fz_bitshuffle_flag": [_P, _L, _P, _P, _P],
        "fz_bitunshuffle_tiles": [_P, _L, _P, _P],
        "fz_lorenzo_quant_smem": [_I, _I, _L, _L, _L, _I],
        "fz_lorenzo_quant_walks": [_I, _I, _L, _L, _L, _I],
    },
    "flash_decode.cu": {
        "fz_flash_decode": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _L, _L, _L,
                            _L, _P, _P, _P, _P, _P],
        "fz_flash_decode_scratch_floats": [_I, _I, _I, _I, _I],
        "fz_flash_decode_smem": [_I, _I],
        "fz_flash_decode_combine_smem": [_I],
    },
}
# the queries of a launch's dynamic shared bytes ("*_smem") and of sizes
_RESTYPES = {"fz_decompress_scratch_words": _L, "fz_flash_decode_scratch_floats": _L,
             "fz_fused_shuffle_encode_ctas": _L, "fz_fused_compress_smem": _L,
             "fz_fused_compress_strict_smem": _L,
             "fz_scan_columns_smem": _L, "fz_lorenzo_quant_smem": _L,
             "fz_lorenzo_quant_walks": _L,
             "fz_flash_decode_smem": _L, "fz_flash_decode_combine_smem": _L}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source, *HEADERS):
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def log_path(source: str) -> Path:
    """Where nvcc's output for a source's library is kept."""
    return library_path(source).with_suffix(".ptxas.log")


def ptxas_log(source: str) -> str | None:
    """nvcc's output of the source's built library, or None where it is not built."""
    try:
        return log_path(source).read_text()
    except FileNotFoundError:
        return None


def build() -> dict[str, str]:
    """Compile every source whose library is missing; returns nvcc's log per
    compiled source (ptxas reports registers, shared memory and spills), which
    is also kept beside the library (:func:`ptxas_log`)."""
    todo = [s for s in SOURCES if not library_path(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for src in todo:
        out = library_path(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for src, out, tmp, proc in procs:
        logs[src] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"nvcc failed for {src} (exit {proc.returncode}):\n{logs[src]}")
            tmp.unlink(missing_ok=True)
        else:
            # the log first: a library found built has its log
            log = log_path(src)
            tmp_log = log.with_suffix(f".{os.getpid()}.tmp")
            tmp_log.write_text(logs[src])
            os.replace(tmp_log, log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source; the first call builds every missing one."""
    if source not in _loaded:
        build()
        lib = ctypes.CDLL(str(library_path(source)))
        for fn, argtypes in SIGNATURES[source].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = _RESTYPES.get(fn, ctypes.c_int)
        lib.fz_error_string.argtypes = [ctypes.c_int]
        lib.fz_error_string.restype = ctypes.c_char_p
        _loaded[source] = lib
    return _loaded[source]


@functools.cache
def query(source: str, fn: str, args: tuple) -> int | None:
    """What one of a source's ``extern "C"`` queries returns for ``args`` (the
    dynamic shared bytes a launch sets, the launch K1 picks), or None where no
    card is present to build and load the library."""
    import torch
    if not torch.cuda.is_available():
        return None
    return int(getattr(library(source), fn)(*args))


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({lib.fz_error_string(rc).decode()})")
