"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C entry point (no PyTorch headers),
so ``nvcc`` compiles it in seconds into a shared library that ``ctypes``
loads.  Pointers and the CUDA stream go in as ``c_void_p``; every entry
point returns ``cudaGetLastError()`` after its launch and the Python
wrapper raises when that is not 0 (each library also exports
``rt_cuda_error_string`` to name the error).

Libraries go to ``build/ray_tpu_torch/`` at the root of the checkout,
named by a hash of the source, the ``csrc/*.cuh`` headers it includes
and the flags, and are built at first use
— never at import, so the CPU tests (no ``nvcc``) import every module.
``build()`` starts one ``nvcc`` per missing source, all at once, and
waits for all of them.  ``build_variants()`` builds other sources or
flags the same way for the timing scripts (``build/variants/``), and
``entry()`` types an entry point of any such library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
           "flash_attention": "flash_attention.cu",
           "binpack": "binpack.cu",
           "topk": "topk.cu",
           "bundle": "bundle.cu",
           "pull": "pull.cu",
           "broadcast": "broadcast.cu",
           "shard_scan": "shard_scan.cu",
           "beat": "beat.cu"}

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entry points (restype int = cudaError_t)
_SIGNATURES = {
    "waterfill": ("rt_waterfill_scan",
                  [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _P, _P]),
    "flash_attention": ("rt_flash_attention",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         ctypes.c_float, _P, _P]),
    "binpack": ("rt_binpack_launch_loop",
                [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                 ctypes.c_longlong, _P]),
    "topk": ("rt_topk_schedule",
             [_P, _P, _P, _P, _P, _P, _P, _P,
              _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]),
    "bundle": ("rt_bundle_schedule",
               [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                _P, _P, _P, _P, _P, _P]),
    "pull": ("rt_pull_choose",
             [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P]),
    "broadcast": ("rt_plan_fanout",
                  [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P]),
    "shard_scan": ("rt_shard_scan", [_P, _I, _I, _I, _I, _I, _I, _P, _P]),
    "beat": ("rt_beat_rows", [_P, _P, _P, _P]),
}
# further C entry points of a library: {name: {function: argtypes}}
_EXTRA = {"binpack": {"rt_binpack_plan": [_I, _I, _I, _P]},
          "topk": {"rt_topk_plan": [_I, _I, _I, _P]},
          "bundle": {"rt_bundle_plan": [_I, _I, _I, _I, _P]},
          "pull": {"rt_pull_plan": [_I, _I, _P]},
          "broadcast": {"rt_fanout_plan": [_I, _P]},
          "shard_scan": {"rt_shard_scan_plan": [_I, _I, _I, _I, _P]},
          "beat": {"rt_beat_tail": [_P, _P, _P, _P]},
          "flash_attention": {"rt_flash_route": [_I, _I],
                              "rt_flash_key_tile": [_I, _I],
                              "rt_flash_scratch_bytes": [_I] * 5,
                              "rt_flash_last_launches": []}}
# entry points that return a long long (every other one returns an int)
_LONG = {"rt_flash_scratch_bytes", "rt_flash_last_launches"}

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


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _source_files(path: Path, seen: list[Path]) -> list[Path]:
    """``path`` and every header it includes with quotes, recursively,
    each once, in the order met."""
    if path in seen or not path.exists():
        return seen
    seen.append(path)
    for inc in _INCLUDE.findall(path.read_bytes()):
        _source_files(path.parent / inc.decode(), seen)
    return seen


def _digest(source: Path, flags) -> str:
    """A hash of ``source``, the headers it includes (an edited header
    must not load a stale build) and the nvcc flags."""
    digest = hashlib.sha256()
    for path in _source_files(source, []):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(flags).encode())
    return digest.hexdigest()[:16]


def lib_path(name: str) -> Path:
    """The library of kernel ``name``, named by ``_digest``."""
    return BUILD_DIR / \
        f"{name}-{_digest(_CSRC / SOURCES[name], NVCC_FLAGS)}.so"


def _compile(jobs) -> dict[str, float]:
    """nvcc for every (label, source, library, flags) of ``jobs``, all
    processes at once, each into a temporary file renamed into place (a
    reader never sees half a library).  Returns {label: seconds}; raises
    ``RuntimeError`` with nvcc's output when one fails."""
    if not jobs:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    running = []                        # (label, process, log, tmp, library)
    secs, failed = {}, []
    try:
        for label, source, out, flags in jobs:
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = open(out.with_suffix(".log"), "w")
            running.append((label, None, log, tmp, out))
            cmd = [nvcc, *flags, "-o", str(tmp), str(source)]
            running[-1] = (label, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT), log, tmp, out)
        for label, proc, log, tmp, out in running:
            rc = proc.wait()
            secs[label] = time.perf_counter() - t0
            if rc != 0:
                log.flush()
                failed.append(f"{label}: nvcc exit {rc}\n"
                              + Path(log.name).read_text()[-4000:])
            else:
                os.replace(tmp, out)
    finally:
        for _label, proc, log, _tmp, _out in running:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def build(names=None) -> dict[str, float]:
    """Compile every named kernel whose library is missing, all nvcc
    processes in parallel.  Returns {name: seconds} for those built;
    raises ``RuntimeError`` with nvcc's output when one fails."""
    names = list(SOURCES if names is None else names)
    return _compile([(n, _CSRC / SOURCES[n], lib_path(n), NVCC_FLAGS)
                     for n in names if not lib_path(n).exists()])


def build_variants(specs) -> list[Path]:
    """The libraries of other builds, for timing scripts: each (source,
    extra nvcc flags) of ``specs`` (another commit's source, a copy with
    clock probes, a ``-D`` override of a kernel's constant) built with
    the port's flags into ``build/variants/``, named by ``_digest``, the
    missing ones all at once."""
    outs, jobs = [], []
    for source, flags in specs:
        source, flags = Path(source), [*NVCC_FLAGS, *flags]
        out = BUILD_DIR.parent / "variants" / \
            f"{source.stem}-{_digest(source, flags)}.so"
        if not out.exists() and out not in outs:
            jobs.append((f"{source} {' '.join(flags[len(NVCC_FLAGS):])}",
                         source, out, flags))
        outs.append(out)
    _compile(jobs)
    return outs


def build_log(name: str) -> str:
    path = lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def entry(library, name: str, fn: str | None = None):
    """Kernel ``name``'s C entry point (or its further entry point ``fn``)
    in the library at path ``library``, typed as this module types it."""
    fn_name, argtypes = _SIGNATURES[name]
    if fn is not None:
        fn_name, argtypes = fn, _EXTRA[name][fn]
    out = getattr(ctypes.CDLL(str(library)), fn_name)
    out.argtypes = argtypes
    out.restype = ctypes.c_longlong if fn_name in _LONG else ctypes.c_int
    return out


def _lib(name: str) -> ctypes.CDLL:
    """Kernel ``name``'s library, built on first use and configured once."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn in [None, *_EXTRA.get(name, {})]:
            fn_name, argtypes = (_SIGNATURES[name] if fn is None
                                 else (fn, _EXTRA[name][fn]))
            getattr(lib, fn_name).argtypes = argtypes
            getattr(lib, fn_name).restype = (
                ctypes.c_longlong if fn_name in _LONG else ctypes.c_int)
        lib.rt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rt_cuda_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def load(name: str, entry: str | None = None):
    """The C entry point of kernel ``name`` (built on first use), or its
    further entry point ``entry``."""
    return getattr(_lib(name), entry or _SIGNATURES[name][0])


def check(err: int, name: str) -> None:
    """Raise if kernel ``name``'s C entry point reported a CUDA error."""
    if err != 0:
        text = _lib(name).rt_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel: CUDA error {err} ({text})")
