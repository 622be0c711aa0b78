"""Sharded file reading.

Counterpart: ``alink_tpu/io/sharding.py`` (its file half). Input shards
at the source: each reader takes one slice of the input, chosen by the
path.

- **glob patterns** (``part-*.csv``): the sorted file list is dealt out
  round-robin across shards;
- **one file**: byte ranges aligned to newlines. Shard i owns every line
  whose first byte lies in ``[size*i//n, size*(i+1)//n)``, so the shards
  are disjoint and complete, and each reads about 1/n of the file.

The default topology is one process, ``(0, 1)``: the port runs on one
host until its multi-process layer comes (ROADMAP A9), which also brings
the JAX package's device-side partition rules (``match_partition_rules``,
``state_sharding``, ``device_put_state``). Its ``parallel_shard_map`` is
not kept: the port's shards run on its one ordered pool,
``operator/stream/prefetch.py::prefetch_map``.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import List, Optional, Tuple

_GLOB_CHARS = ("*", "?", "[")
# the processes of a session: one until the multi-process layer is ported
PROCESS_INDEX, PROCESS_COUNT = 0, 1


def resolve_shard(shard_index: Optional[int] = None,
                  num_shards: Optional[int] = None) -> Tuple[int, int]:
    """(shard_index, num_shards), by default the process topology."""
    if num_shards is None:
        if shard_index is not None:
            raise ValueError("shard_index given without num_shards")
        return PROCESS_INDEX, PROCESS_COUNT
    if shard_index is None:
        # num_shards alone means "one shard a process": a default index of
        # 0 would make every process read the same slice and drop the rest
        if num_shards != PROCESS_COUNT:
            raise ValueError(
                f"num_shards={num_shards} without shard_index only makes "
                f"sense when it equals the process count ({PROCESS_COUNT}); "
                f"pass shard_index explicitly")
        shard_index = PROCESS_INDEX
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
    return shard_index, num_shards


def expand_paths(pattern: str) -> Optional[List[str]]:
    """Sorted glob expansion, or None when the path has no glob magic."""
    if not any(c in pattern for c in _GLOB_CHARS):
        return None
    if os.path.exists(pattern):  # a literal file name holding glob chars
        return None
    paths = sorted(_glob.glob(pattern))
    if not paths:
        raise FileNotFoundError(f"no files match {pattern!r}")
    return paths


def shard_paths(pattern: str, shard_index: int, num_shards: int
                ) -> Optional[List[str]]:
    """This shard's round-robin slice of a glob expansion (None: no glob)."""
    paths = expand_paths(pattern)
    if paths is None:
        return None
    return paths[shard_index::num_shards]


def read_file_shard(path: str, shard_index: int, num_shards: int) -> bytes:
    """The newline-aligned byte range of one file that shard i owns:
    every line whose first byte falls in ``[size*i//n, size*(i+1)//n)``;
    a line across a boundary belongs to the shard where it starts. Reads
    only this range and the tail of its last line."""
    size = os.path.getsize(path)
    start = size * shard_index // num_shards
    end = size * (shard_index + 1) // num_shards
    with open(path, "rb") as f:
        if start > 0:
            # the line holding byte start-1 belongs to the previous shard
            f.seek(start - 1)
            if f.read(1) != b"\n":
                _scan_to_newline(f)
        data_start = f.tell()
        if data_start >= end:
            return b""
        buf = f.read(end - data_start)
        if not buf.endswith(b"\n") and f.tell() < size:
            buf += _scan_to_newline(f)  # finish the line across the end
    return buf


def _scan_to_newline(f, chunk: int = 1 << 16) -> bytes:
    """Read up to and including the next newline (or EOF)."""
    out = b""
    while True:
        c = f.read(chunk)
        if not c:
            return out
        j = c.find(b"\n")
        if j >= 0:
            out += c[:j + 1]
            f.seek(f.tell() - (len(c) - j - 1))
            return out
        out += c
