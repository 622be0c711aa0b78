"""Host->device feature-encode boundary.

PyTorch port of ``alink_tpu/operator/common/dataproc/feature_extract.py``.
A column of sparse-vector literals (strings) parses in one call of the
port's native library (:func:`_native_sparse_fast_path`); other columns
parse row by row. Numpy only; the encoded arrays become tensors in
``LinearModelMapper.serving_kernel``'s encoder.

The reference trains on ``Tuple3(weight, label, vec)`` rows built by
``BaseLinearModelTrainBatchOp.transform`` (common/linear/BaseLinearModelTrainBatchOp.java:75-77)
where ``vec`` is a DenseVector or SparseVector per row. Here the whole
table crosses the host->device boundary ONCE as static-shape arrays:
dense ``(n, d)`` blocks, or padded-COO batches for sparse input
(SURVEY §7: "design the padded-CSR batch format early").
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ....common.mtable import MTable
from ....common.vector import DenseVector, SparseBatch, SparseVector, VectorUtil
from ....native import parse_vector_lines


def extract_design(table: MTable, feature_cols: Optional[Sequence[str]],
                   vector_col: Optional[str], dtype=np.float64,
                   vector_size: Optional[int] = None) -> Dict:
    """Returns {"kind": "dense", "X": (n,d)} or
    {"kind": "sparse", "idx": (n,nnz), "val": (n,nnz)}, plus "dim".
    """
    if vector_col:
        from ....common.vector import SparseVectorColumn
        col = table.col(vector_col)
        if isinstance(col, SparseVectorColumn):
            # columnar hasher output: zero-copy into the padded design
            return {"kind": "sparse",
                    "idx": col.idx.astype(np.int32, copy=False),
                    "val": col.val.astype(dtype, copy=False),
                    "dim": max(int(vector_size or 0), col.dim)}
        fast = _native_sparse_fast_path(col, vector_size, dtype)
        if fast is not None:
            return fast
        vecs = [VectorUtil.parse(v) for v in table.col(vector_col)]
        any_sparse = any(isinstance(v, SparseVector) for v in vecs)
        dim = vector_size or 0
        for v in vecs:
            if isinstance(v, DenseVector):
                dim = max(dim, v.size())
            else:
                dim = max(dim, v.n if v.n >= 0 else
                          (int(v.indices[-1]) + 1 if v.indices.size else 0))
        if not any_sparse:
            X = np.zeros((len(vecs), dim), dtype)
            for i, v in enumerate(vecs):
                X[i, :v.size()] = v.data
            return {"kind": "dense", "X": X, "dim": dim}
        batch = SparseBatch.from_vectors(vecs, n_cols=dim, dtype=dtype)
        return {"kind": "sparse", "idx": batch.indices, "val": batch.values, "dim": dim}
    if not feature_cols:
        raise ValueError("either feature_cols or vector_col must be set")
    X = table.numeric_block(list(feature_cols), dtype)
    return {"kind": "dense", "X": X, "dim": X.shape[1]}


def _native_sparse_fast_path(col, vector_size, dtype) -> Optional[Dict]:
    """The design of a column whose every value is a sparse-vector
    literal string (``"$n$i:v ..."`` or ``"i:v ..."``), parsed in one
    native call (``parse_vector_lines``): the Criteo-style hot path. None
    when a value is not such a string, or when a blank line collapsed a
    row or a ``$`` does not open its literal (the parser would drop the
    token that holds it; the per-row parse reads it or raises).

    The padded design repeats index 0 with value 0 past each row's
    entries, as ``SparseBatch.from_vectors`` pads. A literal's entries
    keep their written order, where the per-row parse sorts them by
    index: for literals written in index order the two give the same
    arrays."""
    vals = list(col)
    if not vals or not all(isinstance(v, str) and ":" in v
                           and (v[0] == "$" or "$" not in v) for v in vals):
        return None
    indptr, indices, values, mx = parse_vector_lines(
        ("\n".join(vals) + "\n").encode())
    n = len(vals)
    if indptr.shape[0] != n + 1:
        return None
    dim = max(int(vector_size or 0), mx)
    lens = np.diff(indptr)
    width = max(int(lens.max()), 1)
    idx = np.zeros((n, width), np.int32)
    val = np.zeros((n, width), dtype)
    pos = np.arange(width)[None, :] < lens[:, None]
    idx[pos] = indices
    val[pos] = values.astype(dtype)
    return {"kind": "sparse", "idx": idx, "val": val, "dim": dim}


def resolve_feature_cols(table: MTable, feature_cols, label_col=None,
                         exclude: Sequence[str] = ()) -> List[str]:
    """Default feature columns: all numeric columns except label/excluded."""
    if feature_cols:
        return list(feature_cols)
    from ....common.types import AlinkTypes
    skip = set(exclude) | ({label_col} if label_col else set())
    return [n for n, t in zip(table.schema.names, table.schema.types)
            if n not in skip and AlinkTypes.is_numeric(t)]


def add_intercept(design: Dict, dtype=np.float64) -> Dict:
    """Prefix the constant-1 feature at index 0 (reference Vector.prefix(1.0))."""
    if design["kind"] == "dense":
        X = design["X"]
        ones = np.ones((X.shape[0], 1), X.dtype)
        return {"kind": "dense", "X": np.concatenate([ones, X], 1),
                "dim": design["dim"] + 1}
    idx, val = design["idx"], design["val"]
    n = idx.shape[0]
    idx2 = np.concatenate([np.zeros((n, 1), idx.dtype), idx + 1], 1)
    val2 = np.concatenate([np.ones((n, 1), val.dtype), val], 1)
    return {"kind": "sparse", "idx": idx2, "val": val2, "dim": design["dim"] + 1}


def extract_dense_matrix(t, selected_cols, vector_col,
                         dtype=np.float64,
                         vector_size: Optional[int] = None) -> np.ndarray:
    """extract_design densified: dense design matrices regardless of the
    input encoding (sparse designs go through SparseBatch.to_dense)."""
    design = extract_design(t, selected_cols, vector_col, dtype, vector_size)
    if design["kind"] == "dense":
        return design["X"]
    from ....common.vector import SparseBatch
    return SparseBatch(design["idx"], design["val"],
                       design["dim"]).to_dense(dtype)
