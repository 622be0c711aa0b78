"""DirectReader / DataBridge: the batch-to-stream side channel.

Counterpart: ``alink_tpu/io/directreader.py``, the re-design of
common/io/directreader/ (DirectReader.java:43-77, DataBridge.java,
MemoryDataBridge.java, DbDataBridge.java,
DirectReaderPropertiesStore). A batch result is handed to a stream job
without flowing through the dataflow graph; the policy ("memory" by
default, or "db") picks how the rows travel, resolved as the reference
resolves it: properties set explicitly, then the environment
(``ALINK_DIRECT_READER_POLICY``), then memory. Host only.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

from ..common.mtable import MTable
from ..operator.base import BatchOperator
from .db import BaseDB


class DataBridge:
    """reference: directreader/DataBridge.java — read with optional filter."""

    def read(self, row_filter: Optional[Callable] = None):
        raise NotImplementedError

    def read_mtable(self) -> MTable:
        raise NotImplementedError


class MemoryDataBridge(DataBridge):
    """reference: directreader/MemoryDataBridge.java"""

    def __init__(self, mt: MTable):
        self._mt = mt

    def read(self, row_filter=None):
        rows = self._mt.to_rows()
        return [r for r in rows if row_filter(r)] if row_filter else rows

    def read_mtable(self) -> MTable:
        return self._mt


class DbDataBridge(DataBridge):
    """reference: directreader/DbDataBridge.java — rows travel through a
    shared database table instead of process memory."""

    def __init__(self, db: BaseDB, table: str):
        self.db = db
        self.table = table

    @staticmethod
    def write(db: BaseDB, table: str, mt: MTable) -> "DbDataBridge":
        db.write_table(table, mt, append=False)
        return DbDataBridge(db, table)

    def read(self, row_filter=None):
        rows = self.read_mtable().to_rows()
        return [r for r in rows if row_filter(r)] if row_filter else rows

    def read_mtable(self) -> MTable:
        return self.db.read_table(self.table)


class DirectReaderPropertiesStore:
    _props: Dict[str, str] = {}

    @classmethod
    def set_properties(cls, props: Dict[str, str]):
        cls._props = dict(props)

    @classmethod
    def get(cls, key: str, default: Optional[str] = None) -> Optional[str]:
        if key in cls._props:
            return cls._props[key]
        env_key = "ALINK_" + key.upper().replace(".", "_")
        return os.environ.get(env_key, default)


class DirectReader:
    """reference: directreader/DirectReader.java:43-77 ``collect``."""

    POLICY_KEY = "direct.reader.policy"

    @staticmethod
    def collect(op: BatchOperator) -> DataBridge:
        policy = DirectReaderPropertiesStore.get(DirectReader.POLICY_KEY,
                                                 "memory")
        mt = op.get_output_table()
        if policy == "memory":
            return MemoryDataBridge(mt)
        if policy == "db":
            db_name = DirectReaderPropertiesStore.get("direct.reader.db.name")
            table = DirectReaderPropertiesStore.get(
                "direct.reader.db.table", "alink_direct_reader")
            if not db_name:
                raise ValueError("db policy needs direct.reader.db.name")
            return DbDataBridge.write(BaseDB.of(db_name), table, mt)
        raise ValueError(f"unknown direct reader policy {policy!r}")
