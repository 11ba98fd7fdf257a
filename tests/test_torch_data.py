"""The port's datasets against the JAX package's, on the same inputs.

Scenario sources: ``tests/test_data.py`` (all of its classes) and
``tests/test_streaming.py::TestStreamingDataPipeline``.  Each scenario
runs once through each package's runtime (the port with
``scheduler_device="cpu"``), one after the other, on the same seeded
numpy input; the port must return exactly what the reference returns:
rows, counts, ``take``, the order of ``random_shuffle(seed=...)``,
``sort``, ``split`` and ``groupby`` results, the files ``read_csv``/
``read_text`` read and ``write_json`` writes, and the bytes of ``.rtb``
block files, which either package reads back bit for bit from the
other's.  Then what the port adds: ``iter_torch_batches`` puts batches
on the GPU unless the caller asks for the CPU, so without CUDA a call
with no device raises.
"""

from __future__ import annotations

import importlib
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from ray_tpu.common.config import Config as RefConfig
from ray_tpu_torch.common.config import Config as PortConfig

PKGS = ("ray_tpu", "ray_tpu_torch")


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def _cols(block):
    """A ColumnBlock as plain data: each column's dtype, shape and
    bytes (the two packages' ColumnBlock classes never compare equal)."""
    return {k: (str(v.dtype), v.shape, v.tobytes())
            for k, v in block.columns().items()}


def _arrays(batches):
    return [(str(b.dtype), b.shape, np.ascontiguousarray(b).tobytes())
            for b in batches]


# -- construct and consume ------------------------------------------------------

def range_count_take(m, d):
    ds = m.data.range(100, parallelism=5)
    return ds.num_blocks(), ds.count(), ds.take(7), ds.take_all()


def from_items_and_sum(m, d):
    ds = m.data.from_items([3, 1, 4, 1, 5], parallelism=2)
    return ds.count(), ds.sum()


def from_numpy_roundtrip(m, d):
    arr = np.random.default_rng(0).normal(size=(37, 3)).astype(np.float32)
    out = m.data.from_numpy(arr, parallelism=4).to_numpy()
    assert np.array_equal(out, arr)
    return _arrays([out])


def iter_batches(m, d):
    batches = list(m.data.range(25, parallelism=4).iter_batches(
        batch_size=10))
    return _arrays(batches)


# -- transforms -----------------------------------------------------------------

def map_rows(m, d):
    return m.data.range(10, parallelism=3).map(lambda x: x * x).take_all()


def map_batches_sees_blocks(m, d):
    return m.data.range(20, parallelism=4).map_batches(
        lambda block: [len(block)]).take_all()


def map_batches_numpy(m, d):
    arr = np.random.default_rng(1).integers(-50, 50, size=12) \
        .astype(np.float32)
    ds = m.data.from_numpy(arr, parallelism=3)
    return _arrays([ds.map_batches(lambda b: b * 2.0 + 1.0).to_numpy()])


def filter_flat_map(m, d):
    ds = m.data.range(10, parallelism=3)
    return (ds.filter(lambda x: x % 2 == 0).take_all(),
            ds.flat_map(lambda x: [x, x]).count())


def chaining(m, d):
    return (m.data.range(30, parallelism=4)
            .map(lambda x: x + 1)
            .filter(lambda x: x % 3 == 0)
            .map_batches(lambda b: [v * 10 for v in b])
            .take_all())


# -- reorganisation ---------------------------------------------------------------

def repartition(m, d):
    ds = m.data.range(40, parallelism=2).repartition(8)
    return ds.num_blocks(), ds.take_all()


def random_shuffle_order(m, d):
    ds = m.data.range(200, parallelism=5)
    rows = ds.random_shuffle(seed=7).take_all()
    again = ds.random_shuffle(seed=7).take_all()
    other = ds.random_shuffle(seed=8).take_all()
    return rows, rows == again, sorted(rows) == list(range(200)), other


def sort_rows(m, d):
    items = [int(x) for x in np.random.default_rng(2).permutation(40)]
    ds = m.data.from_items(items, parallelism=3)
    return ds.sort().take_all(), ds.sort(key=lambda x: -x).take_all()


def split_aligned_shards(m, d):
    return [s.take_all() for s in
            m.data.range(10, parallelism=3).split(2)]


# -- groupby and IO -----------------------------------------------------------------

def groupby_count_sum_mean(m, d):
    ds = m.data.range(100, parallelism=7)
    return (ds.groupby(lambda x: x % 3).count().take_all(),
            ds.groupby(lambda x: x % 2).sum().take_all(),
            ds.groupby(lambda x: x % 2).mean().take_all())


def groupby_general_aggregate(m, d):
    rows = [("a", 3), ("b", 1), ("a", 5), ("c", 9), ("b", 2)]
    out = m.data.from_items(rows, parallelism=3).groupby(
        lambda r: r[0]).aggregate(
            init=lambda k: [],
            accumulate=lambda acc, row: acc + [row[1]],
            merge=lambda a, b: a + b).take_all()
    return [(k, sorted(v)) for k, v in out]


def groupby_identity_key(m, d):
    return m.data.from_items(["x", "y", "x", "x"],
                             parallelism=2).groupby().count().take_all()


def union(m, d):
    u = m.data.range(5, parallelism=2).union(
        m.data.range(3, parallelism=1))
    return u.take_all(), u.count()


def read_text_and_csv(m, d):
    (d / "a.txt").write_text("alpha\nbeta\n")
    (d / "b.txt").write_text("gamma\r\n")
    ds = m.data.read_text([str(d / "a.txt"), str(d / "b.txt")])
    csv_dir = d / "csvs"
    csv_dir.mkdir()
    (csv_dir / "x.csv").write_text("name,score\nann,3\nbob,5\n")
    try:
        m.data.read_text(str(d / "missing.txt"))
        missing = None
    except FileNotFoundError:
        missing = "FileNotFoundError"
    return (ds.take_all(), ds.num_blocks(),
            m.data.read_csv(str(csv_dir)).take_all(), missing)


def write_json_files(m, d):
    paths = m.data.range(20, parallelism=4).map(
        lambda x: x * x).write_json(str(d / "out"))
    return [(os.path.basename(p), open(p, "rb").read()) for p in paths]


def groupby_composes_with_transforms(m, d):
    return (m.data.range(50, parallelism=4).map(lambda x: x % 5)
            .groupby().count().filter(lambda kv: kv[0] < 2).take_all())


def review_regressions(m, d):
    numeric = m.data.from_items([10, 2, 10, 2, 2],
                                parallelism=2).groupby().count().take_all()
    (d / "mixed" / "sub").mkdir(parents=True)
    (d / "mixed" / "a.txt").write_text("one\n")
    skip_dirs = m.data.read_text(str(d / "mixed")).take_all()
    out = str(d / "w")
    m.data.range(8, parallelism=8).write_json(out)
    m.data.range(4, parallelism=2).write_json(out)
    parts = sorted(p for p in os.listdir(out) if p.startswith("part-"))
    return numeric, skip_dirs, [(p, open(os.path.join(out, p)).read())
                                for p in parts]


# -- column blocks --------------------------------------------------------------------

def _column_block(data):
    rng = np.random.default_rng(3)
    return data.ColumnBlock({
        "f32": rng.normal(size=(50, 4)).astype(np.float32),
        "i64": rng.integers(-2**40, 2**40, size=50),
        "u8": rng.integers(0, 255, size=(50, 2)).astype(np.uint8),
        "bools": rng.random(50) > 0.5,
    })


def binary_roundtrip(m, d):
    b = _column_block(m.data)
    path = str(d / "b.rtb")
    m.data.write_block_file(b, path)
    back = m.data.read_block_file(path)
    assert back == b and back.nbytes == b.nbytes
    raw = open(path, "rb").read()
    return raw[:4], raw, _cols(back)


def pickle_crosses_as_binary(m, d):
    import pickle
    b = m.data.ColumnBlock({"x": np.arange(10)})
    back = pickle.loads(pickle.dumps(b))
    return back == b, _cols(back)


def row_pivots_and_transforms(m, d):
    rows = [{"a": i, "b": float(i) / 2} for i in range(8)]
    b = m.data.ColumnBlock.from_rows(rows)
    return (b.num_rows, b.to_rows() == rows, b.select(["a"]).column_names,
            _cols(b.take(np.arange(3))), _cols(b.slice(2, 5)))


def object_dtype_refused(m, d):
    b = m.data.ColumnBlock({"x": np.array(["a", {"d": 1}], dtype=object)})
    try:
        b.to_bytes()
    except TypeError as e:
        return "TypeError", str(e)
    return None


def stream_block_files_roundtrip(m, d):
    blocks = [m.data.ColumnBlock({"v": np.arange(20) + 20 * i})
              for i in range(6)]
    paths = m.data.write_blocks(blocks, str(d))
    got = list(m.data.stream_block_files(str(d)).iter_blocks())
    assert got == blocks
    sums = [int(b.column("v").sum()) for b in
            m.data.stream_block_files(str(d)).iter_blocks()]
    return [os.path.basename(p) for p in paths], \
        [_cols(b) for b in got], sums


# -- adaptive window and streaming pipelines --------------------------------------------

def adaptive_window(m, d):
    s = m.data.DataStream(lambda: iter(()))
    return s._window, s.target_bytes(1 << 20)._target_bytes


def peak_memory_scales_with_window_times_block(m, d):
    rt = m.rt.api._get_runtime()
    store = rt.cluster.store
    n_blocks, block_bytes = 180, 400_000
    data = m.data

    def make():
        for i in range(n_blocks):
            yield data.ColumnBlock(
                {"x": np.full(block_bytes // 8, i, np.int64)})

    src = data.stream_blocks(make).target_bytes(3 * block_bytes)
    peak = count = 0
    firsts = []
    for block in src.map_batches(lambda b: b).iter_blocks():
        count += 1
        firsts.append(int(block.column("x")[0]))
        time.sleep(0.02)
        peak = max(peak, store.stats()["arena_bytes_in_use"])
    rt.cluster.ref_counter.flush()
    return count, firsts, 0 < peak < 90 * block_bytes


def pipeline_bounded_occupancy(m, d):
    rt = m.rt.api._get_runtime()
    store = rt.cluster.store
    blocks, row_bytes = 200, 150_000

    src = m.data.stream_blocks(
        lambda: ([bytes([i % 251]) * row_bytes] for i in range(blocks)),
        window=4)
    peak = 0
    out = []
    for block in src.map(lambda b: b[:1] + b"!").iter_blocks():
        out.append(block)
        time.sleep(0.02)
        peak = max(peak, store.stats()["arena_bytes_in_use"])
    rt.cluster.ref_counter.flush()
    return out, 0 < peak < 60 * row_bytes


def stream_range_map_filter(m, d):
    return (m.data.stream_range(100, block_size=10)
            .map(lambda x: x * 2).filter(lambda x: x % 40 == 0)
            .take_all())


def stream_count(m, d):
    return m.data.stream_range(57, block_size=8).count()


# -- torch ingest on the CPU ----------------------------------------------------------------

def torch_batches(m, d):
    """The reference's ``iter_torch_batches`` keeps batches where torch
    made them (the CPU); the port is asked for the CPU explicitly."""
    import torch
    arr = np.random.default_rng(4).normal(size=(37, 5)).astype(np.float32)
    ds = m.data.from_numpy(arr, parallelism=3)
    kw = {"device": "cpu"} if m.pkg == "ray_tpu_torch" else {}
    out = []
    for dtype in (None, torch.float64):
        batches = list(ds.iter_torch_batches(batch_size=8, dtype=dtype,
                                             **kw))
        assert all(b.device.type == "cpu" for b in batches)
        out.append(_arrays([b.numpy() for b in batches]))
    return out


SCENARIOS = [
    range_count_take, from_items_and_sum, from_numpy_roundtrip,
    iter_batches, map_rows, map_batches_sees_blocks, map_batches_numpy,
    filter_flat_map, chaining, repartition, random_shuffle_order,
    sort_rows, split_aligned_shards, groupby_count_sum_mean,
    groupby_general_aggregate, groupby_identity_key, union,
    read_text_and_csv, write_json_files, groupby_composes_with_transforms,
    review_regressions, binary_roundtrip, pickle_crosses_as_binary,
    row_pivots_and_transforms, object_dtype_refused,
    stream_block_files_roundtrip, adaptive_window,
    peak_memory_scales_with_window_times_block, pipeline_bounded_occupancy,
    stream_range_map_filter, stream_count, torch_batches,
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name in PKGS:
        rt = importlib.import_module(name)
        m = SimpleNamespace(pkg=name, rt=rt,
                            data=importlib.import_module(f"{name}.data"))
        importlib.import_module(f"{name}.api")
        port = name == "ray_tpu_torch"
        rt.init(resources={"CPU": 8, "memory": 8}, num_workers=4,
                system_config={"scheduler_device": "cpu"} if port else None)
        res = out[name] = {}
        try:
            for sc in SCENARIOS:
                d = tmp_path_factory.mktemp(f"{name}-{sc.__name__}")
                try:
                    res[sc.__name__] = sc(m, d)
                except Exception as e:      # noqa: BLE001 — compared
                    res[sc.__name__] = e
        finally:
            rt.shutdown()
            (PortConfig if port else RefConfig).reset()
    return out


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.__name__)
def test_same_as_reference(runs, scenario):
    want = runs["ray_tpu"][scenario.__name__]
    got = runs["ray_tpu_torch"][scenario.__name__]
    if isinstance(want, Exception):
        raise want
    if isinstance(got, Exception):
        raise got
    assert got == want


def test_what_the_runs_show(runs):
    got = runs["ray_tpu_torch"]
    assert got["range_count_take"] == (5, 100, list(range(7)),
                                       list(range(100)))
    assert got["from_items_and_sum"] == (5, 14)
    rows, same_again, permutes, other = got["random_shuffle_order"]
    assert same_again and permutes and rows != list(range(200))
    assert other != rows
    assert got["split_aligned_shards"] == [[0, 1, 2, 3, 4],
                                           [5, 6, 7, 8, 9]]
    assert dict(got["groupby_count_sum_mean"][0]) == {0: 34, 1: 33, 2: 33}
    assert got["read_text_and_csv"] == (
        ["alpha", "beta", "gamma"], 2,
        [{"name": "ann", "score": "3"}, {"name": "bob", "score": "5"}],
        "FileNotFoundError")
    rows = []
    for _name, raw in got["write_json_files"]:
        rows.extend(json.loads(raw))
    assert sorted(rows) == [x * x for x in range(20)]
    assert got["binary_roundtrip"][0] == b"RTB1"
    assert got["object_dtype_refused"][0] == "TypeError"
    count, firsts, bounded = \
        got["peak_memory_scales_with_window_times_block"]
    assert count == 180 and firsts == list(range(180)) and bounded
    blocks, bounded = got["pipeline_bounded_occupancy"]
    assert len(blocks) == 200 and bounded
    assert got["stream_count"] == 57


@pytest.mark.parametrize("writer,reader", [
    ("ray_tpu_torch", "ray_tpu"), ("ray_tpu", "ray_tpu_torch")],
    ids=["port_to_reference", "reference_to_port"])
def test_rtb_files_cross_bit_for_bit(writer, reader, tmp_path):
    """An ``.rtb`` file written by one package reads back bit for bit in
    the other, and both write the same bytes for the same block."""
    w = importlib.import_module(f"{writer}.data")
    r = importlib.import_module(f"{reader}.data")
    block = _column_block(w)
    paths = w.write_blocks([block, block.slice(5, 20)], str(tmp_path))
    back = list(r.iter_block_files(str(tmp_path)))
    assert [_cols(b) for b in back] == \
        [_cols(block), _cols(block.slice(5, 20))]
    for p, b in zip(paths, back):
        assert open(p, "rb").read() == r.ColumnBlock.to_bytes(b)
        assert r.ColumnBlock.from_bytes(open(p, "rb").read()) == b


def test_iter_torch_batches_without_a_device_needs_cuda():
    """No device means the GPU: without CUDA the port raises instead of
    returning CPU tensors (the tensors are made where the batches are
    consumed, so the raise comes at the first batch)."""
    import torch

    from ray_tpu_torch.data.dataset import Dataset

    ds = Dataset.__new__(Dataset)
    ds.iter_batches = lambda batch_size: iter(
        [np.zeros((batch_size, 2), np.float32)])
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None lands on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(ds.iter_torch_batches(batch_size=4))
    cpu = next(ds.iter_torch_batches(batch_size=4, device="cpu"))
    assert cpu.device.type == "cpu" and cpu.shape == (4, 2)


def test_task_bodies_stay_free_of_torch():
    """Workers never import torch: the data task bodies and their
    modules import numpy only, at their top level."""
    import ast
    from pathlib import Path

    import ray_tpu_torch.data as data

    root = Path(data.__file__).parent
    for path in sorted(root.glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in tree.body:
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            assert not any(n.split(".")[0] == "torch" for n in names), \
                (path.name, names)
