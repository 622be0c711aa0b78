"""Vectors and the padded sparse batch format.

PyTorch port: a copy of ``alink_tpu/common/vector.py``
(numpy only; the port keeps its own copy so that it never imports the
JAX package).

Host-side equivalents of the reference linalg value types
(common/linalg/DenseVector.java, SparseVector.java, VectorUtil parse/format
with the "$size$i:v i:v" sparse string format — see e.g. the test fixture
pipeline/classification/LogisticRegTest.java:23) plus the TPU-first batch
encoding: XLA needs static shapes, so batches of sparse vectors become a
padded COO block (``SparseBatch``) where padded slots carry value 0.0 and
therefore contribute nothing to dot products or scatter-adds — no masking
needed on the hot path.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from .columnar import ColumnarColumn


class DenseVector:
    """Dense double vector (reference common/linalg/DenseVector.java)."""

    __slots__ = ("data",)

    def __init__(self, data):
        if isinstance(data, int):
            self.data = np.zeros(data, dtype=np.float64)
        else:
            self.data = np.asarray(data, dtype=np.float64)

    def size(self) -> int:
        return int(self.data.shape[0])

    def get(self, i: int) -> float:
        return float(self.data[i])

    def set(self, i: int, v: float):
        self.data[i] = v

    def add(self, i: int, v: float):
        self.data[i] += v

    def scale(self, a: float) -> "DenseVector":
        return DenseVector(self.data * a)

    def plus(self, other: "DenseVector") -> "DenseVector":
        return DenseVector(self.data + other.to_dense().data)

    def minus(self, other) -> "DenseVector":
        return DenseVector(self.data - other.to_dense().data)

    def dot(self, other: "Vector") -> float:
        if isinstance(other, SparseVector):
            return other.dot(self)
        return float(np.dot(self.data, other.data))

    def norm_l2(self) -> float:
        return float(np.linalg.norm(self.data))

    def norm_l1(self) -> float:
        return float(np.abs(self.data).sum())

    def norm_l2_square(self) -> float:
        return float(np.dot(self.data, self.data))

    def normalize(self, p: float = 2.0) -> "DenseVector":
        n = np.linalg.norm(self.data, ord=p)
        return DenseVector(self.data / n if n > 0 else self.data)

    def to_dense(self) -> "DenseVector":
        return self

    def to_array(self) -> np.ndarray:
        return self.data

    def slice(self, idx) -> "DenseVector":
        return DenseVector(self.data[np.asarray(idx)])

    def prefix(self, v: float) -> "DenseVector":
        return DenseVector(np.concatenate([[v], self.data]))

    def append(self, v: float) -> "DenseVector":
        return DenseVector(np.concatenate([self.data, [v]]))

    def __len__(self):
        return self.size()

    def __iter__(self):
        return iter(self.data)

    def __eq__(self, other):
        return isinstance(other, DenseVector) and np.array_equal(self.data, other.data)

    def __repr__(self):
        return VectorUtil.to_string(self)


class SparseVector:
    """Sparse double vector with sorted int32 indices (reference SparseVector.java)."""

    __slots__ = ("n", "indices", "values")

    def __init__(self, size: int = -1, indices=None, values=None):
        self.n = int(size)
        if indices is None:
            self.indices = np.zeros(0, dtype=np.int32)
            self.values = np.zeros(0, dtype=np.float64)
        else:
            indices = np.asarray(indices, dtype=np.int32)
            values = np.asarray(values, dtype=np.float64)
            order = np.argsort(indices, kind="stable")
            self.indices = indices[order]
            self.values = values[order]
        if self.n >= 0 and self.indices.size and int(self.indices[-1]) >= self.n:
            raise ValueError(f"index {int(self.indices[-1])} out of bound {self.n}")

    @classmethod
    def trusted(cls, size: int, indices: np.ndarray,
                values: np.ndarray) -> "SparseVector":
        """Wrap pre-validated arrays without copy/sort/bounds checks.

        For bulk producers (FeatureHasher emits millions of rows whose
        indices are sorted by construction); caller guarantees sorted int32
        indices, float64 values, and in-bound entries.
        """
        v = cls.__new__(cls)
        v.n = int(size)
        v.indices = indices
        v.values = values
        return v

    def size(self) -> int:
        return self.n

    def number_of_values(self) -> int:
        return int(self.indices.shape[0])

    def get(self, i: int) -> float:
        pos = np.searchsorted(self.indices, i)
        if pos < self.indices.size and self.indices[pos] == i:
            return float(self.values[pos])
        return 0.0

    def set(self, i: int, v: float):
        pos = int(np.searchsorted(self.indices, i))
        if pos < self.indices.size and self.indices[pos] == i:
            self.values[pos] = v
        else:
            self.indices = np.insert(self.indices, pos, i)
            self.values = np.insert(self.values, pos, v)

    def dot(self, other: "Vector") -> float:
        if isinstance(other, DenseVector):
            return float(np.dot(self.values, other.data[self.indices]))
        # sparse x sparse
        i = j = 0
        s = 0.0
        while i < self.indices.size and j < other.indices.size:
            a, b = self.indices[i], other.indices[j]
            if a == b:
                s += self.values[i] * other.values[j]
                i += 1
                j += 1
            elif a < b:
                i += 1
            else:
                j += 1
        return float(s)

    def scale(self, a: float) -> "SparseVector":
        return SparseVector(self.n, self.indices.copy(), self.values * a)

    def norm_l2(self) -> float:
        return float(np.linalg.norm(self.values))

    def norm_l1(self) -> float:
        return float(np.abs(self.values).sum())

    def norm_l2_square(self) -> float:
        return float(np.dot(self.values, self.values))

    def normalize(self, p: float = 2.0) -> "SparseVector":
        nrm = np.linalg.norm(self.values, ord=p)
        return SparseVector(self.n, self.indices.copy(),
                            self.values / nrm if nrm > 0 else self.values)

    def to_dense(self) -> DenseVector:
        size = self.n if self.n >= 0 else (int(self.indices[-1]) + 1 if self.indices.size else 0)
        d = np.zeros(size, dtype=np.float64)
        d[self.indices] = self.values
        return DenseVector(d)

    def prefix(self, v: float) -> "SparseVector":
        return SparseVector(self.n + 1 if self.n >= 0 else -1,
                            np.concatenate([[0], self.indices + 1]),
                            np.concatenate([[v], self.values]))

    def __eq__(self, other):
        return (isinstance(other, SparseVector) and self.n == other.n
                and np.array_equal(self.indices, other.indices)
                and np.array_equal(self.values, other.values))

    def __repr__(self):
        return VectorUtil.to_string(self)


Vector = Union[DenseVector, SparseVector]


class VectorUtil:
    """Parse/format vectors (reference common/linalg/VectorUtil.java).

    Dense:  "1.0 2.0 3.0" (space separated)
    Sparse: "$4$0:1.0 2:3.0"  (leading $size$, then idx:val pairs), size optional.
    """

    @staticmethod
    def parse(s) -> Vector:
        if isinstance(s, (DenseVector, SparseVector)):
            return s
        if isinstance(s, np.ndarray):
            return DenseVector(s)
        if isinstance(s, (list, tuple)):
            return DenseVector(np.asarray(s, dtype=np.float64))
        s = str(s).strip()
        if not s:
            return DenseVector(np.zeros(0))
        if s.startswith("$") or ":" in s:
            return VectorUtil.parse_sparse(s)
        return VectorUtil.parse_dense(s)

    @staticmethod
    def parse_dense(s: str) -> DenseVector:
        s = s.strip()
        if s.startswith("[") and s.endswith("]"):
            s = s[1:-1]
        parts = s.replace(",", " ").split()
        return DenseVector(np.asarray([float(p) for p in parts], dtype=np.float64))

    @staticmethod
    def parse_sparse(s: str) -> SparseVector:
        s = s.strip()
        size = -1
        if s.startswith("$"):
            end = s.index("$", 1)
            size = int(s[1:end])
            s = s[end + 1:].strip()
        indices, values = [], []
        if s:
            for pair in s.replace(",", " ").split():
                k, v = pair.split(":")
                indices.append(int(k))
                values.append(float(v))
        return SparseVector(size, indices, values)

    @staticmethod
    def to_string(v: Vector) -> str:
        if isinstance(v, DenseVector):
            return " ".join(_fmt(x) for x in v.data)
        head = f"${v.n}$" if v.n >= 0 else ""
        return head + " ".join(f"{int(i)}:{_fmt(x)}" for i, x in zip(v.indices, v.values))

    @staticmethod
    def get_size(v: Vector) -> int:
        return v.size()


def _fmt(x: float) -> str:
    x = float(x)
    if not np.isfinite(x):
        return repr(x)
    return str(int(x)) + ".0" if x == int(x) and abs(x) < 1e15 else repr(x)


class SparseBatch:
    """Padded COO batch of n sparse rows — the TPU-side sparse format.

    ``indices``: (n, max_nnz) int32, ``values``: (n, max_nnz) float32/64.
    Padded slots have value 0.0 (index content irrelevant but kept in-bound
    at 0), so ``sum(values * w[indices], -1)`` and segment scatter-adds are
    correct without masks. This replaces the reference's per-row
    ``SparseVector`` objects on the training hot path — the design point
    called out in SURVEY §7 ("padded-CSR batch format").
    """

    __slots__ = ("indices", "values", "n_cols")

    def __init__(self, indices: np.ndarray, values: np.ndarray, n_cols: int):
        self.indices = indices
        self.values = values
        self.n_cols = int(n_cols)

    @property
    def n_rows(self) -> int:
        return int(self.indices.shape[0])

    @property
    def max_nnz(self) -> int:
        return int(self.indices.shape[1])

    @staticmethod
    def from_vectors(vectors: Sequence[Vector], n_cols: Optional[int] = None,
                     max_nnz: Optional[int] = None, dtype=np.float32) -> "SparseBatch":
        rows = [VectorUtil.parse(v) for v in vectors]
        if n_cols is None:
            n_cols = 0
            for r in rows:
                if isinstance(r, DenseVector):
                    n_cols = max(n_cols, r.size())
                else:
                    n_cols = max(n_cols, r.n if r.n >= 0 else
                                 (int(r.indices[-1]) + 1 if r.indices.size else 0))
        if max_nnz is None:
            max_nnz = 1
            for r in rows:
                nnz = r.size() if isinstance(r, DenseVector) else r.number_of_values()
                max_nnz = max(max_nnz, nnz)
        n = len(rows)
        idx = np.zeros((n, max_nnz), dtype=np.int32)
        val = np.zeros((n, max_nnz), dtype=dtype)
        for i, r in enumerate(rows):
            nnz = r.size() if isinstance(r, DenseVector) else r.number_of_values()
            if nnz > max_nnz:
                raise ValueError(
                    f"row {i} has {nnz} nonzeros > max_nnz={max_nnz}; "
                    "raise max_nnz (truncation would corrupt the batch)")
            if isinstance(r, DenseVector):
                idx[i, :nnz] = np.arange(nnz)
                val[i, :nnz] = r.data
            else:
                idx[i, :nnz] = r.indices
                val[i, :nnz] = r.values
        return SparseBatch(idx, val, n_cols)

    def to_dense(self, dtype=np.float32) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_cols), dtype=dtype)
        rows = np.repeat(np.arange(self.n_rows), self.max_nnz)
        np.add.at(out, (rows, self.indices.reshape(-1)), self.values.reshape(-1))
        return out

    def pad_rows(self, target_rows: int) -> "SparseBatch":
        extra = target_rows - self.n_rows
        if extra <= 0:
            return self
        idx = np.vstack([self.indices, np.zeros((extra, self.max_nnz), np.int32)])
        val = np.vstack([self.values, np.zeros((extra, self.max_nnz), self.values.dtype)])
        return SparseBatch(idx, val, self.n_cols)


class SparseVectorColumn(ColumnarColumn):
    """Columnar stand-in for an object column of same-width SparseVectors.

    The FeatureHasher -> trainer path used to materialize one SparseVector
    per row only for extract_design to tear them straight back into
    (idx, val) arrays — the dominant host cost of the streaming drain.
    This class keeps the batch columnar end-to-end (protocol:
    common/columnar.py); extract_design consumes ``idx``/``val``
    zero-copy.
    """

    __slots__ = ("idx", "val", "dim")

    def __init__(self, idx: np.ndarray, val: np.ndarray, dim: int):
        assert idx.ndim == 2 and idx.shape == val.shape
        self.idx = idx
        self.val = val
        self.dim = int(dim)

    def __len__(self):
        return self.idx.shape[0]

    def _render_row(self, i: int):
        # per-row copies: a retained vector must not pin the batch
        return SparseVector.trusted(self.dim, self.idx[i].copy(),
                                    self.val[i].copy())

    def _subset(self, sel):
        return SparseVectorColumn(self.idx[sel], self.val[sel], self.dim)

    def copy(self) -> "SparseVectorColumn":
        return SparseVectorColumn(self.idx.copy(), self.val.copy(), self.dim)

    def concat_same(self, other):
        if (isinstance(other, SparseVectorColumn) and other.dim == self.dim
                and other.idx.shape[1] == self.idx.shape[1]):
            return SparseVectorColumn(np.vstack([self.idx, other.idx]),
                                      np.vstack([self.val, other.val]),
                                      self.dim)
        return None


class DenseMatrix:
    """Column-major double matrix facade (reference common/linalg/DenseMatrix.java).

    Stored row-major in numpy; the reference's column-major layout is an
    artifact of F2J BLAS and is not carried over.
    """

    __slots__ = ("data",)

    def __init__(self, m=None, n=None, data=None):
        if data is not None:
            arr = np.asarray(data, dtype=np.float64)
            if arr.ndim == 1 and m is not None and n is not None:
                arr = arr.reshape(m, n)
            self.data = arr
        else:
            self.data = np.zeros((m, n), dtype=np.float64)

    def num_rows(self) -> int:
        return self.data.shape[0]

    def num_cols(self) -> int:
        return self.data.shape[1]

    def get(self, i, j) -> float:
        return float(self.data[i, j])

    def set(self, i, j, v):
        self.data[i, j] = v

    def add(self, i, j, v):
        self.data[i, j] += v

    def multiplies(self, other) -> "DenseMatrix":
        if isinstance(other, DenseMatrix):
            return DenseMatrix(data=self.data @ other.data)
        if isinstance(other, DenseVector):
            return DenseVector(self.data @ other.data)
        return DenseMatrix(data=self.data * other)

    def transpose(self) -> "DenseMatrix":
        return DenseMatrix(data=self.data.T)

    def solve(self, b) -> "DenseMatrix":
        rhs = b.data if isinstance(b, (DenseMatrix, DenseVector)) else np.asarray(b)
        sol, *_ = np.linalg.lstsq(self.data, rhs, rcond=None)
        if isinstance(b, DenseVector):
            return DenseVector(sol)
        return DenseMatrix(data=sol)

    def __repr__(self):
        return f"DenseMatrix({self.data!r})"
