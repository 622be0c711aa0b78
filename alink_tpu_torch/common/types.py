"""Column type system for host-side tables.

PyTorch port: a copy of ``alink_tpu/common/types.py``
(numpy only; the port keeps its own copy so that it never imports the
JAX package).

Re-design of the reference's Flink ``TableSchema`` + ``VectorTypes``
(common/VectorTypes.java:15-45 — a bimap of type name <-> TypeInformation).
On TPU, strings/objects never leave the host; only encoded numeric tensors
cross to the device, so the type system is purely a host-side contract.
"""

from __future__ import annotations

import numpy as np


class AlinkTypes:
    DOUBLE = "DOUBLE"
    FLOAT = "FLOAT"
    LONG = "LONG"
    INT = "INT"
    BOOLEAN = "BOOLEAN"
    STRING = "STRING"
    DENSE_VECTOR = "DENSE_VECTOR"
    SPARSE_VECTOR = "SPARSE_VECTOR"
    VECTOR = "VECTOR"
    M_TABLE = "MTABLE"
    TIMESTAMP = "TIMESTAMP"
    ANY = "ANY"

    _NUMERIC = {DOUBLE, FLOAT, LONG, INT, BOOLEAN}
    _NP = {
        DOUBLE: np.float64, FLOAT: np.float32, LONG: np.int64, INT: np.int32,
        BOOLEAN: np.bool_,
    }

    @classmethod
    def is_numeric(cls, t: str) -> bool:
        return t in cls._NUMERIC

    @classmethod
    def is_vector(cls, t: str) -> bool:
        return t in (cls.DENSE_VECTOR, cls.SPARSE_VECTOR, cls.VECTOR)

    @classmethod
    def to_numpy_dtype(cls, t: str):
        return cls._NP.get(t, object)

    @classmethod
    def from_value(cls, v) -> str:
        from .vector import DenseVector, SparseVector
        if isinstance(v, bool) or isinstance(v, np.bool_):
            return cls.BOOLEAN
        if isinstance(v, (int, np.integer)):
            return cls.LONG
        if isinstance(v, (float, np.floating)):
            return cls.DOUBLE
        if isinstance(v, str):
            return cls.STRING
        if isinstance(v, DenseVector):
            return cls.DENSE_VECTOR
        if isinstance(v, SparseVector):
            return cls.SPARSE_VECTOR
        if isinstance(v, np.ndarray) and v.ndim == 1:
            return cls.DENSE_VECTOR
        from .mtable import MTable
        if isinstance(v, MTable):
            return cls.M_TABLE
        return cls.ANY

    @classmethod
    def from_numpy_dtype(cls, dt) -> str:
        dt = np.dtype(dt)
        if dt == np.bool_:
            return cls.BOOLEAN
        if np.issubdtype(dt, np.integer):
            return cls.LONG if dt.itemsize > 4 else cls.INT
        if np.issubdtype(dt, np.floating):
            return cls.DOUBLE if dt.itemsize > 4 else cls.FLOAT
        return cls.STRING if dt.kind in "US" else cls.ANY


class TableSchema:
    """Ordered (name, type) pairs; mirrors Flink TableSchema usage in the reference."""

    def __init__(self, names, types):
        names, types = list(names), list(types)
        if len(names) != len(types):
            raise ValueError("names/types length mismatch")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names: {names}")
        self.names = names
        self.types = types

    @staticmethod
    def parse(spec: str) -> "TableSchema":
        """Parse "col1 TYPE, col2 TYPE" schema strings (reference CsvUtil.schemaStr)."""
        names, types = [], []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            toks = part.split()
            names.append(toks[0])
            types.append(toks[1].upper() if len(toks) > 1 else AlinkTypes.DOUBLE)
        return TableSchema(names, types)

    def to_spec(self) -> str:
        return ", ".join(f"{n} {t}" for n, t in zip(self.names, self.types))

    def index_of(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(f"column '{name}' not in schema {self.names}") from None

    def type_of(self, name: str) -> str:
        return self.types[self.index_of(name)]

    def __len__(self):
        return len(self.names)

    def __eq__(self, other):
        return (isinstance(other, TableSchema) and self.names == other.names
                and self.types == other.types)

    def __repr__(self):
        return f"TableSchema({self.to_spec()!r})"

    def copy(self) -> "TableSchema":
        return TableSchema(list(self.names), list(self.types))
