"""Native components: build-on-first-use C++ with ctypes bindings.

Reference parity: the reference's hot runtime pieces are C++ (plasma store
allocator, raylet event loop — SURVEY.md §2.1); here the shared-memory
arena allocator is native (``arena.cc``, a copy of the JAX package's)
and Python binds it with ctypes.  The library is compiled at first use
with g++ into ``build/ray_tpu_torch/`` at the root of the checkout, as
the port's CUDA kernels are (``ops/_build.py``), once per source change.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "arena.cc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                          "ray_tpu_torch")
_build_lock = threading.Lock()
_lib_handle = None


def _lib_path() -> str:
    """Cache key is a CONTENT hash of the source, embedded in the library
    filename: mtimes are not preserved by git checkouts, so an mtime test
    could silently load a stale binary with a mismatched shared-memory
    layout.  Build artifacts are never committed (.gitignore build/)."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"_libarena_{digest}.so")


def _ensure_built() -> str:
    """Compile arena.cc -> _libarena_<srchash>.so if not already cached."""
    lib = _lib_path()
    if os.path.exists(lib):
        return lib
    with _build_lock:
        if os.path.exists(lib):
            return lib
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = lib + f".tmp.{os.getpid()}"
        cmd = ["g++", "-O2", "-fPIC", "-shared", "-pthread",
               "-o", tmp, _SRC]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build failed: {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, lib)
        # older-revision caches are left in place: a concurrent process
        # may be between building and dlopening one (they are a few KB
        # and gitignored, so accumulation is harmless)
    return lib


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(_ensure_built())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.arena_init.argtypes = [u8p, ctypes.c_uint64]
        lib.arena_init.restype = ctypes.c_int
        lib.arena_check.argtypes = [u8p]
        lib.arena_check.restype = ctypes.c_int
        lib.arena_alloc.argtypes = [u8p, ctypes.c_uint64]
        lib.arena_alloc.restype = ctypes.c_uint64
        lib.arena_free.argtypes = [u8p, ctypes.c_uint64]
        lib.arena_free.restype = ctypes.c_int
        for fn in ("arena_bytes_in_use", "arena_capacity",
                   "arena_largest_free"):
            getattr(lib, fn).argtypes = [u8p]
            getattr(lib, fn).restype = ctypes.c_uint64
        lib.arena_touch.argtypes = [u8p, ctypes.c_uint64,
                                    ctypes.c_uint64]
        lib.arena_touch.restype = ctypes.c_uint64
        _lib_handle = lib
    return _lib_handle


class ArenaFullError(MemoryError):
    """No free block large enough (caller should spill/evict and retry)."""


class Arena:
    """One mmap'd shared-memory arena.

    The OWNER (raylet/driver process) creates it read-write and is the only
    process that allocates, writes, and frees.  READERS (workers) attach
    read-only and get zero-copy memoryviews of sealed payloads.
    """

    def __init__(self, path: str, capacity: int | None = None, *,
                 create: bool = False):
        self.path = path
        self._owner = create
        if create:
            assert capacity is not None
            fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
            try:
                os.ftruncate(fd, capacity)
                self._mm = mmap.mmap(fd, capacity)
            finally:
                os.close(fd)
            self._base = (ctypes.c_uint8 * capacity).from_buffer(self._mm)
            rc = _lib().arena_init(self._base, capacity)
            if rc != 0:
                raise RuntimeError("arena_init failed")
        else:
            fd = os.open(path, os.O_RDONLY)
            try:
                size = os.fstat(fd).st_size
                self._mm = mmap.mmap(fd, size, prot=mmap.PROT_READ)
            finally:
                os.close(fd)
            self._base = None           # readers never call the allocator
        self._view = memoryview(self._mm)

    # -- owner-side ---------------------------------------------------------
    def alloc(self, size: int) -> int:
        off = _lib().arena_alloc(self._base, size)
        if off == 0:
            raise ArenaFullError(f"arena cannot fit {size} bytes")
        return int(off)

    def free(self, offset: int) -> None:
        rc = _lib().arena_free(self._base, offset)
        if rc != 0:
            raise ValueError(f"bad arena free at offset {offset}")

    def put(self, data) -> tuple[int, int]:
        """Allocate + copy + seal in one step; returns (offset, size)."""
        data = memoryview(data)
        n = data.nbytes
        off = self.alloc(n)
        self._view[off:off + n] = data
        return off, n

    def write(self, offset: int, data) -> None:
        data = memoryview(data)
        self._view[offset:offset + data.nbytes] = data

    def touch(self, offset: int, size: int) -> None:
        """Pre-fault [offset, offset+size): one read per page, native
        and GIL-free (ctypes releases the GIL for the call), so a
        transfer can warm its landing block on a spare core while the
        bytes are still on the wire."""
        _lib().arena_touch(self._base, offset, size)

    def bytes_in_use(self) -> int:
        return int(_lib().arena_bytes_in_use(self._base))

    def capacity(self) -> int:
        return int(_lib().arena_capacity(self._base))

    def largest_free(self) -> int:
        return int(_lib().arena_largest_free(self._base))

    # -- both sides ---------------------------------------------------------
    def view(self, offset: int, size: int) -> memoryview:
        """Zero-copy view of a sealed payload."""
        return self._view[offset:offset + size]

    def close(self) -> None:
        try:
            self._view.release()
        except Exception:
            pass
        # the ctypes array holds a buffer export on the mmap; drop it first
        self._base = None
        try:
            self._mm.close()
        except (BufferError, Exception):
            pass
        if self._owner:
            try:
                os.unlink(self.path)
            except OSError:
                pass
