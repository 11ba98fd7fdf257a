"""ray_tpu_torch.data — distributed datasets over object-store blocks.

Reference parity: ``ray.data`` (``python/ray/data/``) — a ``Dataset`` is
a list of object-store block references plus metadata; transforms
(``map/map_batches/filter/flat_map/repartition/random_shuffle/sort``)
run as tasks over blocks; ``groupby`` aggregations run as per-block
partials merged in a worker-side tree; ``read_text/read_csv`` map files
to blocks and ``write_json`` writes one part per block; consumers
(``take/count/iter_batches/split``) resolve refs (SURVEY.md §1 layer
14, §2.2; mount empty).

Blocks are numpy-friendly lists or arrays living in the shared-memory
arena (zero-copy into workers), ``map_batches`` is the primary compute
hook so user code sees whole blocks (feed the GPU big batches, not
Python-loop rows), ``iter_torch_batches`` puts batches on the GPU unless
the caller asks for the CPU, and ``split`` hands aligned shards to
per-worker ingest.  Workers never import torch: the task bodies are
numpy only.
"""

from .aggregate import GroupedDataset, read_csv, read_text
from .block import (ColumnBlock, iter_block_files, read_block_file,
                    write_block_file, write_blocks)
from .dataset import Dataset, from_items, from_numpy, range  # noqa: A004
from .streaming import (DataStream, stream_block_files, stream_blocks,
                        stream_from_items, stream_range)

__all__ = ["ColumnBlock", "DataStream", "Dataset", "GroupedDataset",
           "from_items", "from_numpy", "iter_block_files", "range",
           "read_block_file", "read_csv", "read_text",
           "stream_block_files", "stream_blocks", "stream_from_items",
           "stream_range", "write_block_file", "write_blocks"]
