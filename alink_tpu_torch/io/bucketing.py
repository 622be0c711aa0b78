"""Bucketing row sink.

Counterpart: ``alink_tpu/io/bucketing.py``, the re-design of the
reference's ``TableBucketingSink`` (common/io/TableBucketingSink.java:
23-160): a row sink that routes rows into rolling numbered bucket tables
``<prefix>_<id>``, in ruler mode (``batch_size < 0`` and
``batch_rollover_interval < 0``: each row carries its bucket id and the
bucket's row count as its first two fields, ``writeByRuler``) or in
size-or-time mode (``writeBySizeOrTime``; one bound given leaves the
other unbounded, :44-51). Buckets land in a ``BaseDB`` (a table each) or
in a directory of CSV files ``<dir>/<prefix>_<id>.csv``. Host only.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

from ..common.mtable import MTable
from ..common.types import TableSchema
from .csv import format_csv_rows, write_csv
from .db import BaseDB


class TableBucketingSink:
    """Row sink that rolls output into numbered bucket tables
    ``<prefix>_<id>`` — in a BaseDB or as a partitioned directory of CSV
    files — by explicit bucket-id columns (ruler mode) or by
    size/time rollover (reference common/io/TableBucketingSink.java).

    Pre-existing bucket targets: in **ruler mode** a bucket that already
    exists is an error (the ruler's ``(id, n_tab)`` contract says this
    process owns the bucket's full row count — TableBucketingSink.java:
    94-95). In **size/time mode** the reference REUSES an existing table
    and appends to it (createFormat is only consulted for new tables), so
    this sink tolerates existing targets and appends.

    Unit note: the reference's ``batchRolloverInterval`` is milliseconds
    (a Flink config long); here ``batch_rollover_interval`` is **seconds**
    (a float, matching every other time knob in this codebase — stream
    ``time_interval``, event times). Divide reference configs by 1000.
    """

    def __init__(self, table_name_prefix: str, schema: TableSchema,
                 db: Optional[BaseDB] = None, base_dir: Optional[str] = None,
                 batch_size: int = -1, batch_rollover_interval: float = -1.0,
                 clock=time.monotonic):
        if (db is None) == (base_dir is None):
            raise ValueError("pass exactly one of db= or base_dir=")
        self.prefix = table_name_prefix
        self.schema = schema
        self.db = db
        self.base_dir = base_dir
        # mode is fixed at construction (before the one-sided widening
        # below makes both bounds positive)
        self._ruler = batch_size < 0 and batch_rollover_interval < 0
        # one-sided bounds widen the other side (TableBucketingSink.java:44-51)
        if batch_size > 0 and batch_rollover_interval < 0:
            batch_rollover_interval = float("inf")
        if batch_size < 0 and batch_rollover_interval > 0:
            batch_size = 2 ** 62
        self.batch_size = batch_size
        self.batch_rollover_interval = batch_rollover_interval
        self._clock = clock
        self._start_time = clock()
        self._current_id = 0
        # bucket id -> (rows written so far, buffered rows)
        self._open: Dict[int, Tuple[int, List[tuple]]] = {}

    # -- public sink surface -------------------------------------------------
    def invoke(self, row: tuple) -> None:
        """Write one row (reference ``invoke``, TableBucketingSink.java:55-61)."""
        if self.batch_size < 0 and self.batch_rollover_interval < 0:
            self._write_by_ruler(row)
        else:
            self._write_by_size_or_time(row)

    def write_table(self, mt: MTable) -> None:
        """Convenience: feed every row of a table (micro-batch drain)."""
        for row in mt.to_rows():
            self.invoke(row)

    def close(self) -> None:
        """Flush any buckets still open (end of stream)."""
        for bucket_id in list(self._open):
            self._close_bucket(bucket_id)

    def bucket_names(self) -> List[str]:
        """Names of all buckets written so far (closed or open)."""
        def bucket_id(name: str):
            tail = name.rsplit("_", 1)[1]
            return (0, int(tail)) if tail.isdigit() else (1, tail)

        if self.db is not None:
            return sorted((t for t in self.db.list_table_names()
                           if t.startswith(self.prefix + "_")), key=bucket_id)
        if not os.path.isdir(self.base_dir):
            return []
        return sorted((os.path.splitext(f)[0] for f in os.listdir(self.base_dir)
                       if f.startswith(self.prefix + "_")), key=bucket_id)

    # -- modes ---------------------------------------------------------------
    def _write_by_ruler(self, row: tuple) -> None:
        bucket_id, n_tab = int(row[0]), int(row[1])
        payload = tuple(row[2:])
        count, buf = self._open.get(bucket_id, (0, None))
        if buf is None:
            self._create_bucket(bucket_id)
            buf = []
        buf.append(payload)
        count += 1
        self._open[bucket_id] = (count, buf)
        if count == n_tab:
            self._close_bucket(bucket_id)

    def _write_by_size_or_time(self, row: tuple) -> None:
        bucket_id = self._current_id
        count, buf = self._open.get(bucket_id, (0, None))
        if buf is None:
            self._create_bucket(bucket_id)
            buf = []
        buf.append(tuple(row))
        count += 1
        self._open[bucket_id] = (count, buf)
        if (count >= self.batch_size or
                self._clock() - self._start_time > self.batch_rollover_interval):
            self._close_bucket(bucket_id)
            self._start_time = self._clock()
            self._current_id += 1

    # -- bucket lifecycle ----------------------------------------------------
    def _bucket_name(self, bucket_id: int) -> str:
        return f"{self.prefix}_{bucket_id}"

    def _create_bucket(self, bucket_id: int) -> None:
        name = self._bucket_name(bucket_id)
        if self.db is not None:
            if self.db.has_table(name):
                if self._ruler:
                    # same contract as TableBucketingSink.java:94-95 —
                    # ruler mode only; size/time mode reuses the table
                    raise RuntimeError(f"table : {name} has already exists, "
                                       f"please change your table name.")
                return
            self.db.create_table(name, self.schema)
        else:
            os.makedirs(self.base_dir, exist_ok=True)
            path = os.path.join(self.base_dir, name + ".csv")
            if os.path.exists(path) and self._ruler:
                raise RuntimeError(f"table : {name} has already exists, "
                                   f"please change your table name.")

    def _close_bucket(self, bucket_id: int) -> None:
        count, buf = self._open.pop(bucket_id)
        mt = MTable(buf, self.schema)
        name = self._bucket_name(bucket_id)
        if self.db is not None:
            self.db.write_table(name, mt, append=True)
        else:
            path = os.path.join(self.base_dir, name + ".csv")
            if not self._ruler and os.path.exists(path):
                # size/time mode reuses a pre-existing bucket file by
                # appending, mirroring the db branch's append=True
                with open(path, "a", newline="", encoding="utf-8") as f:
                    f.write(format_csv_rows(mt))
            else:
                write_csv(mt, path)
