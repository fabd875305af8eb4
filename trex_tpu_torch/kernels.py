"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, into
``build/trex_tpu_torch/`` beside the package (a directory git ignores).
The library's name carries a hash of its source, so an edited source
is rebuilt. Libraries are loaded with ``ctypes``.

Nothing is built or imported at module import: the CPU tests import
every module, and the CPU has no ``nvcc``. A missing ``nvcc`` or a
failed build raises; there is no fallback.

``launches`` counts, per kernel name, the launches its wrapper made
since the last :func:`reset_launches`; a run reads it to show that
its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "trex_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# kernel name -> (source file, [(C symbol, argtypes, restype)])
_VP = ctypes.c_void_p
_I = ctypes.c_int
SOURCES = {
    "ccl": ("ccl.cu", [
        ("trex_ccl_label", [_VP, _VP, _VP, _I, _I, _I, _VP], _I),
        ("trex_ccl_scratch_ints", [_I, _I, _I], ctypes.c_longlong)]),
    "neighbor_min": ("neighbor_min.cu",
                     [("trex_neighbor_min", [_VP, _VP, _I, _I, _I, _VP], _I)]),
}

launches: dict = {name: 0 for name in SOURCES}
_libs: dict = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if nvcc is None and (home / "bin" / "nvcc").exists():
        nvcc = str(home / "bin" / "nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "trex_tpu_torch cannot be built")
    return nvcc


def _lib_path(name: str) -> Path:
    src = CSRC / SOURCES[name][0]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names=None, verbose: bool = False) -> dict:
    """Compile the named kernels (all by default) that are not built
    yet: one ``nvcc`` process per source, all started together.
    Returns {name: seconds spent in its nvcc (0.0 when cached)}."""
    import time

    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    took = {n: 0.0 for n in names}
    if not todo:
        return took
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else []) \
            + ["-o", str(tmp), str(CSRC / SOURCES[n][0])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out, time.perf_counter())
    errors = []
    for n, (p, tmp, out, t0) in procs.items():
        log, _ = p.communicate()
        took[n] = time.perf_counter() - t0
        if verbose and log:
            print(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n][0]} "
                          f"(exit {p.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for sym, argtypes, restype in SOURCES[name][1]:
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = restype
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with error {err}")
