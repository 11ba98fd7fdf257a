"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C entry point (no PyTorch headers),
so ``nvcc`` compiles it in seconds into a shared library that ``ctypes``
loads.  Pointers and the CUDA stream go in as ``c_void_p``; every entry
point returns ``cudaGetLastError()`` after its launch and the Python
wrapper raises when that is not 0 (each library also exports
``rt_cuda_error_string`` to name the error).

Libraries go to ``build/ray_tpu_torch/`` at the root of the checkout,
named by a hash of the source and the flags, and are built at first use
— never at import, so the CPU tests (no ``nvcc``) import every module.
``build()`` starts one ``nvcc`` per missing source, all at once, and
waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"
# -Xptxas -v reports registers, shared memory and spills per kernel into
# the build log next to each library.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = {"waterfill": "waterfill.cu",
           "flash_attention": "flash_attention.cu"}

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entry points (restype int = cudaError_t)
_SIGNATURES = {
    "waterfill": ("rt_waterfill_scan",
                  [_P, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _P, _P]),
    "flash_attention": ("rt_flash_attention",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         ctypes.c_float, _P]),
}

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin)")
    return path


def lib_path(name: str) -> Path:
    src = (_CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Compile every named kernel whose library is missing, all nvcc
    processes in parallel.  Returns {name: seconds} for those built;
    raises ``RuntimeError`` with nvcc's output when one fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []                               # (name, process, log, tmp)
    secs, failed = {}, []
    try:
        for n in todo:
            out = lib_path(n)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = open(out.with_suffix(".log"), "w")
            jobs.append((n, None, log, tmp))
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(_CSRC / SOURCES[n])]
            jobs[-1] = (n, subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT),
                        log, tmp)
        for n, proc, log, tmp in jobs:
            rc = proc.wait()
            secs[n] = time.perf_counter() - t0
            if rc != 0:
                log.flush()
                failed.append(f"{n}: nvcc exit {rc}\n"
                              + Path(log.name).read_text()[-4000:])
            else:   # atomic: a reader never sees half a library
                os.replace(tmp, lib_path(n))
    finally:
        for _n, proc, log, _tmp in jobs:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def build_log(name: str) -> str:
    path = lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def _lib(name: str) -> ctypes.CDLL:
    """Kernel ``name``'s library, built on first use and configured once."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        fn_name, argtypes = _SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.rt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rt_cuda_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def load(name: str):
    """The C entry point of kernel ``name`` (built on first use)."""
    return getattr(_lib(name), _SIGNATURES[name][0])


def check(err: int, name: str) -> None:
    """Raise if kernel ``name``'s C entry point reported a CUDA error."""
    if err != 0:
        text = _lib(name).rt_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel: CUDA error {err} ({text})")
