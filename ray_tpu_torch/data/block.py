"""Columnar blocks: the binary block format + local block-file IO.

Reference parity: upstream Data's value is Arrow-backed blocks with
per-block metadata (size bytes, row count) feeding the streaming
executor's memory accounting, plus columnar file IO (``read_parquet``)
— ``python/ray/data/_internal/`` (SURVEY.md §1 layer 14; mount empty).

Columnar shape: a block is a dict of dense NUMPY columns — the layout
torch wraps zero-copy (``torch.from_numpy(col)``), so a pipeline feeding
the GPU never row-pivots.  The on-disk format (``.rtb``) is the
``read_parquet``-equivalent local binary reader: a fixed magic, a JSON
header describing columns (name/dtype/shape), then each column's raw
little-endian buffer, contiguously.  No pickle anywhere in the file
path — blocks are readable by any language that can parse JSON and
memcpy.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Iterable, Iterator

import numpy as np

_MAGIC = b"RTB1"


class ColumnBlock:
    """An immutable batch of rows stored as named dense columns.

    ``nbytes`` is the per-block size stat the streaming executor's
    adaptive window consumes (upstream: BlockMetadata.size_bytes)."""

    __slots__ = ("_cols", "_n")

    def __init__(self, columns: dict[str, np.ndarray]):
        cols = {}
        n = None
        for name, arr in columns.items():
            arr = np.asarray(arr)
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise ValueError(
                    f"column {name!r} has {arr.shape[0]} rows, "
                    f"expected {n}")
            cols[str(name)] = arr
        self._cols = cols
        self._n = n or 0

    # -- stats ---------------------------------------------------------------
    @property
    def num_rows(self) -> int:
        return self._n

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self._cols.values())

    @property
    def column_names(self) -> list[str]:
        return list(self._cols)

    def column(self, name: str) -> np.ndarray:
        return self._cols[name]

    def columns(self) -> dict[str, np.ndarray]:
        return dict(self._cols)

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        # row iteration: DataStream.iter_rows()/take_all() and plain
        # ``for row in block`` work on columnar blocks too
        return iter(self.to_rows())

    def __eq__(self, other) -> bool:
        return (isinstance(other, ColumnBlock)
                and self.column_names == other.column_names
                and all(np.array_equal(self._cols[k], other._cols[k])
                        for k in self._cols))

    def __repr__(self) -> str:
        cols = {k: f"{a.dtype}{list(a.shape[1:])}"
                for k, a in self._cols.items()}
        return f"ColumnBlock({self._n} rows, {cols})"

    # -- row <-> column pivots ----------------------------------------------
    @classmethod
    def from_rows(cls, rows: list[dict]) -> "ColumnBlock":
        if not rows:
            return cls({})
        names = list(rows[0])
        return cls({k: np.asarray([r[k] for r in rows])
                    for k in names})

    def to_rows(self) -> list[dict]:
        names = list(self._cols)
        cols = [self._cols[k] for k in names]
        return [{k: c[i].item() if c[i].shape == () else c[i]
                 for k, c in zip(names, cols)}
                for i in range(self._n)]

    # -- transforms ----------------------------------------------------------
    def select(self, names: list[str]) -> "ColumnBlock":
        return ColumnBlock({k: self._cols[k] for k in names})

    def take(self, mask_or_idx) -> "ColumnBlock":
        return ColumnBlock({k: a[mask_or_idx]
                            for k, a in self._cols.items()})

    def slice(self, lo: int, hi: int) -> "ColumnBlock":
        return ColumnBlock({k: a[lo:hi]
                            for k, a in self._cols.items()})

    # -- binary wire/file format --------------------------------------------
    def to_bytes(self) -> bytes:
        """MAGIC | u32 header_len | header JSON | column buffers.
        Column buffers are C-contiguous little-endian, in header
        order."""
        header = []
        buffers = []
        for name, arr in self._cols.items():
            a = np.ascontiguousarray(arr)
            if a.dtype.byteorder == ">":
                a = a.astype(a.dtype.newbyteorder("<"))
            if a.dtype.hasobject:
                raise TypeError(
                    f"column {name!r} has object dtype — the binary "
                    "block format holds dense numeric/bytes columns "
                    "only (strings: encode to fixed-width or bytes)")
            header.append({"name": name, "dtype": a.dtype.str,
                           "shape": list(a.shape)})
            buffers.append(a.tobytes())
        hdr = json.dumps({"columns": header,
                          "num_rows": self._n}).encode()
        out = bytearray()
        out += _MAGIC
        out += struct.pack("<I", len(hdr))
        out += hdr
        for b in buffers:
            out += b
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "ColumnBlock":
        if data[:4] != _MAGIC:
            raise ValueError("not an RTB1 block")
        (hlen,) = struct.unpack_from("<I", data, 4)
        hdr = json.loads(data[8:8 + hlen].decode())
        off = 8 + hlen
        cols = {}
        for c in hdr["columns"]:
            dt = np.dtype(c["dtype"])
            shape = tuple(c["shape"])
            n = int(np.prod(shape)) if shape else 1
            arr = np.frombuffer(data, dtype=dt, count=n,
                                offset=off).reshape(shape)
            off += n * dt.itemsize
            cols[c["name"]] = arr
        block = cls.__new__(cls)
        block._cols = cols
        block._n = int(hdr["num_rows"])
        return block

    def __reduce__(self):
        # blocks cross process boundaries in the binary format, not as
        # pickled ndarray graphs (stable wire layout, no pickle in the
        # data plane)
        return (ColumnBlock.from_bytes, (self.to_bytes(),))


# -- block files (the read_parquet-equivalent local reader) ------------------

def write_block_file(block: ColumnBlock, path: str) -> str:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(block.to_bytes())
    os.replace(tmp, path)
    return path


def read_block_file(path: str) -> ColumnBlock:
    with open(path, "rb") as f:
        return ColumnBlock.from_bytes(f.read())


def write_blocks(blocks: Iterable[ColumnBlock], directory: str,
                 prefix: str = "part") -> list[str]:
    """One ``.rtb`` file per block (the write_parquet analogue)."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, b in enumerate(blocks):
        paths.append(write_block_file(
            b, os.path.join(directory, f"{prefix}-{i:05d}.rtb")))
    return paths


def block_file_paths(paths_or_dir) -> list[str]:
    if isinstance(paths_or_dir, str):
        if os.path.isdir(paths_or_dir):
            return sorted(
                os.path.join(paths_or_dir, n)
                for n in os.listdir(paths_or_dir)
                if n.endswith(".rtb"))
        return [paths_or_dir]
    return list(paths_or_dir)


def iter_block_files(paths_or_dir) -> Iterator[ColumnBlock]:
    for p in block_file_paths(paths_or_dir):
        yield read_block_file(p)
