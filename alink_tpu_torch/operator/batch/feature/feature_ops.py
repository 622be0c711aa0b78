"""Feature engineering operators.

Counterpart: ``alink_tpu/operator/batch/feature/feature_ops.py``, the
re-design of common/feature/ (SURVEY §2.5): OneHot, QuantileDiscretizer,
Bucketizer, Binarizer, FeatureHasher (murmur into a fixed dim, the
Criteo / avazu front end of the reference's FTRLExample.java:46-57),
ChiSqSelector, PCA and DCT, all of them ported.

Devices: ``QuantileDiscretizerTrainBatchOp`` and ``DCTBatchOp`` take
``device=`` (``cuda`` unless the caller asks for the CPU; raises without
it). The discretizer's cut points come from
``common/dataproc/quantile.py::distributed_quantiles`` on that device at
``DEVICE_BINNING_MIN_CELLS`` cells or more (its histogram
interpolation), and from exact host ``np.quantile`` below, as in the
JAX package: the two differ, so the cutover is the shared constant. DCT's
forward transform is ``torch.fft`` there, its inverse one product with
the orthonormal basis. PCA keeps the JAX package's host SVD (numpy's:
a card's SVD may flip a component's sign) and its population ``std``
(ddof 0) beside the n - 1 variance. The other ops run on the host and
take no device. ``OneHotModelMapper`` maps a column at a time: each
distinct value (by bit pattern for floats, so -0.0 and 0.0 stay apart)
is formatted with ``str`` once, giving the indices the JAX package's
per-cell ``str(v)`` gives.

:func:`murmur32_cells` hashes a batch in one call of the port's native
library (``alink_tpu_torch/native``, ``murmur_batch``), as the JAX
package does; there is no fallback. :func:`murmur32_cells_plain` is its
plain version: MurmurHash3 x86 32 vectorized in numpy over the ``(n, w)``
byte matrix of the tokens (the 4-byte blocks a column of words at a
time, then the 0-3-byte tail and the final mix, in uint32 arithmetic),
bitwise to :func:`murmur32`, which the tests hold the library against.

"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ....common.device import resolve_device
from ....common.mtable import MTable
from ....common.params import InValidator, ParamInfo, Params, RangeValidator
from ....common.types import AlinkTypes
from ....common.vector import (DenseVector, SparseVector, SparseVectorColumn,
                               VectorUtil)
from ....mapper.base import ModelMapper, OutputColsHelper
from ....model.converters import (SimpleModelDataConverter, decode_array,
                                  encode_array)
from ....native import murmur32_batch
from ....params.shared import (HasLabelCol, HasOutputCol, HasOutputCols,
                               HasReservedCols, HasSelectedCol,
                               HasSelectedCols, HasVectorCol)
from ...base import BatchOperator
from ...common.dataproc.feature_extract import extract_dense_matrix
from ..utils.model_map import ModelMapBatchOp

_C1, _C2 = 0xcc9e2d51, 0x1b873593


def murmur32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86 32-bit of one byte string (the reference relies
    on Flink's murmur)."""
    c1, c2 = _C1, _C2
    h = seed & 0xFFFFFFFF
    length = len(data)
    rounded = length - (length & 3)
    for i in range(0, rounded, 4):
        k = int.from_bytes(data[i:i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xe6546b64) & 0xFFFFFFFF
    k = 0
    tail = data[rounded:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= length
    h ^= h >> 16
    h = (h * 0x85ebca6b) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xc2b2ae35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def _format_tokens(col_name: str, a) -> np.ndarray:
    """Vectorized ``f"{col_name}={v}".encode()`` per cell -> fixed-width
    "S" array (np str() formatting matches the f-string for every numpy
    scalar and for None -> "None")."""
    arr = np.asarray(a)
    if arr.dtype.kind == "S":
        # bytes cells format as their repr under the f-string contract
        # ("c=b'y'"); astype("U") would DECODE them and change the hash
        return np.array([f"{col_name}={v}".encode() for v in arr])
    ua = np.char.add(f"{col_name}=", arr.astype("U"))
    try:
        return ua.astype("S")  # ASCII cast: ~3x faster than element encode
    except UnicodeEncodeError:
        return np.char.encode(ua, "utf-8")


def _byte_matrix(tokens) -> Tuple[np.ndarray, np.ndarray]:
    """``(b, lens)``: the tokens as a zero-padded ``(n, w)`` uint8 matrix,
    ``w`` a multiple of 4, and each token's length. A fixed-width "S"
    array gives its tokens without their trailing NULs (its own
    contract); a sequence of byte strings keeps every byte."""
    if isinstance(tokens, np.ndarray) and tokens.dtype.kind == "S":
        arr = tokens
        lens = np.char.str_len(arr).astype(np.int64)
    else:
        tokens = list(tokens)
        lens = np.fromiter((len(t) for t in tokens), np.int64, len(tokens))
        arr = np.array(tokens, dtype=f"S{max(int(lens.max(initial=0)), 1)}")
    n = arr.shape[0]
    w = max(arr.dtype.itemsize, 1)
    b = np.frombuffer(np.ascontiguousarray(arr).tobytes(), np.uint8)
    b = b.reshape(n, arr.dtype.itemsize) if n else np.zeros((0, w), np.uint8)
    w4 = -(-w // 4) * 4
    if b.shape[1] != w4:
        b = np.pad(b, ((0, 0), (0, w4 - b.shape[1])))
    return b, lens


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _mix_k(k: np.ndarray) -> np.ndarray:
    k = k * np.uint32(_C1)
    k = _rotl(k, 15)
    return k * np.uint32(_C2)


def murmur32_cells(tokens, seed: int = 0, mod: int = 0) -> np.ndarray:
    """murmur3_32 of every byte-string token (int64 array, the raw
    uint32 range, or ``% mod`` when ``mod > 0``), in one call of the
    native library. A fixed-width ``S`` array gives its tokens without
    their trailing NULs."""
    return murmur32_batch(tokens, seed=seed, mod=mod)


def murmur32_cells_plain(tokens, seed: int = 0, mod: int = 0) -> np.ndarray:
    """The plain version of :func:`murmur32_cells`, in numpy.

    One vectorized pass over the tokens' byte matrix: block ``j`` of
    every token at once, masked to the tokens that have it, then the
    tail word (the bytes past the token are zeros, so a token without a
    tail mixes a zero word, a no-op) and the final mix. Bitwise to
    :func:`murmur32` token by token."""
    b, lens = _byte_matrix(tokens)
    n = b.shape[0]
    words = np.ascontiguousarray(b).view("<u4").astype(np.uint32)
    nblocks = lens // 4
    h = np.full(n, seed & 0xFFFFFFFF, np.uint32)
    with np.errstate(over="ignore"):
        for j in range(words.shape[1]):
            active = j < nblocks
            if not active.any():
                break
            hj = h ^ _mix_k(words[:, j])
            hj = _rotl(hj, 13) * np.uint32(5) + np.uint32(0xe6546b64)
            h = np.where(active, hj, h)
        tail = np.zeros(n, np.uint32)
        has = nblocks < words.shape[1]
        tail[has] = words[np.flatnonzero(has), nblocks[has]]
        h ^= _mix_k(tail)
        h ^= lens.astype(np.uint32)
        h ^= h >> np.uint32(16)
        h = h * np.uint32(0x85ebca6b)
        h ^= h >> np.uint32(13)
        h = h * np.uint32(0xc2b2ae35)
        h ^= h >> np.uint32(16)
    out = h.astype(np.int64)
    return out % mod if mod > 0 else out


def _flat_rows(slots: np.ndarray, weights: np.ndarray, dim: int) -> np.ndarray:
    """Per row, the flat layout's ``SparseVector``: the row's distinct
    slots in ascending order (slot -1 marks a missing cell and is
    dropped), each slot's weights added in column order starting from
    ``0.0`` (so ``0.0 + (-0.0)`` is ``+0.0``). ``slots`` and ``weights``
    are ``(columns, n)``; a stable sort of each row's slots keeps the
    column order inside a slot's run."""
    S, W = slots.T, weights.T
    n, k = S.shape
    order = np.argsort(S, axis=1, kind="stable")
    S = np.take_along_axis(S, order, 1)
    W = np.take_along_axis(W, order, 1)
    sums = np.empty_like(W)
    cur = np.zeros(n)
    for j in range(k):
        start = S[:, j] != S[:, j - 1] if j else np.ones(n, bool)
        cur = np.where(start, 0.0 + W[:, j], cur + W[:, j])
        sums[:, j] = cur
    last = np.ones((n, k), bool)
    last[:, :-1] = S[:, 1:] != S[:, :-1]
    keep = last & (S >= 0)
    idx = S[keep].astype(np.int32)
    val = sums[keep]
    ends = np.cumsum(keep.sum(1))
    starts = ends - keep.sum(1)
    vecs = np.empty(n, object)
    vecs[:] = [SparseVector.trusted(dim, idx[a:e], val[a:e])
               for a, e in zip(starts.tolist(), ends.tolist())]
    return vecs


class FeatureHasherBatchOp(BatchOperator, HasSelectedCols, HasOutputCol,
                           HasReservedCols):
    """reference: feature/FeatureHasherBatchOp (FTRLExample.java:46-57):
    categorical cols hash (name=value), numeric cols hash (name) with the
    value as weight; output one SparseVector of NUM_FEATURES dims.

    ``field_aware=True``: each column hashes into its own sub-range of
    size ``ceil(num_features / n_cols)`` rounded up to a multiple of 16,
    so every row has exactly one slot per field (nulls hash like a
    value, numeric nulls get weight 0): the field-blocked layout
    (``ops/fieldblock.py``) that the linear trainers detect. The
    effective dim becomes ``n_cols * field_size``; the output is a
    columnar ``SparseVectorColumn``.
    """
    NUM_FEATURES = ParamInfo("num_features", int, default=1 << 18,
                             validator=RangeValidator(1, None))
    CATEGORICAL_COLS = ParamInfo("categorical_cols", list, "treat as categorical")
    FIELD_AWARE = ParamInfo("field_aware", bool, default=False)

    def link_from(self, in_op: BatchOperator) -> "FeatureHasherBatchOp":
        t = in_op.get_output_table()
        cols = self.get_selected_cols() or t.col_names
        out_col = self.params._m.get("output_col") or "output"
        dim = self.get_num_features()
        declared_cat = set(self.get_categorical_cols() or [])
        cat = {c: (c in declared_cat or
                   not AlinkTypes.is_numeric(t.schema.type_of(c))) for c in cols}
        arrays = {c: t.col(c) for c in cols}
        n = t.num_rows
        if self.get_field_aware():
            # field size = num_features/n_cols ceiled to a multiple of 16,
            # so the effective dim (= n_cols * S) is >= num_features
            S = max(16, -(-dim // len(cols) // 16) * 16)
            dim = S * len(cols)
            if dim > np.iinfo(np.int32).max:
                raise ValueError(
                    f"field-aware effective dim {dim} exceeds int32 index "
                    f"range; lower num_features")
            fb = np.empty((n, len(cols)), np.int64)
            wv = np.empty((n, len(cols)), np.float64)
            for k, c in enumerate(cols):
                a = arrays[c]
                if cat[c]:
                    fb[:, k] = k * S + murmur32_cells(
                        _format_tokens(c, a), mod=S)
                    wv[:, k] = 1.0
                else:
                    fb[:, k] = k * S + murmur32(c.encode()) % S
                    if a.dtype == object:
                        # np.asarray would turn None into nan; the contract
                        # is None -> weight 0.0 (real nans stay nan)
                        wv[:, k] = np.fromiter(
                            (float(v) if v is not None else 0.0 for v in a),
                            np.float64, n)
                    else:
                        wv[:, k] = np.asarray(a, np.float64)
            vecs = SparseVectorColumn(fb.astype(np.int32), wv, dim)
        else:
            slots = np.empty((len(cols), n), np.int64)
            weights = np.empty((len(cols), n), np.float64)
            for k, c in enumerate(cols):
                a = arrays[c]
                # only an object column holds None
                miss = (np.fromiter((v is None for v in a), bool, n)
                        if a.dtype == object else np.zeros(n, bool))
                if cat[c]:
                    tokens = _format_tokens(c, a)
                    tokens[miss] = b""  # hashed then overwritten by -1
                    slots[k] = murmur32_cells(tokens, mod=dim)
                    weights[k] = 1.0
                else:
                    slots[k] = murmur32(c.encode()) % dim
                    weights[k] = ([0.0 if m else float(v)
                                   for m, v in zip(miss, a)]
                                  if a.dtype == object
                                  else np.asarray(a, np.float64))
                slots[k][miss] = -1
            vecs = _flat_rows(slots, weights, dim)
        helper = OutputColsHelper(t.schema, [out_col], [AlinkTypes.SPARSE_VECTOR],
                                  self.params._m.get("reserved_cols"))
        self._output = helper.build_output(t, [vecs])
        return self


# ---------------------------------------------------------------------------
# OneHot
# ---------------------------------------------------------------------------

def _distinct_strs(a) -> Tuple[np.ndarray, List[Optional[str]]]:
    """``(inverse, strs)`` of a column: ``strs`` the ``str`` of each
    distinct cell (``None`` for a ``None`` cell), ``inverse`` each
    cell's position in it, so that ``strs[inverse[i]]`` is what
    ``None if a[i] is None else str(a[i])`` gives. Numeric, string and
    bytes columns format each distinct value once (floats by bit
    pattern: -0.0 and 0.0 format apart); an object column cell by cell."""
    a = np.asarray(a)
    kind, size = a.dtype.kind, a.dtype.itemsize
    if a.ndim == 1 and (kind in "biuUS" or (kind == "f" and size in (2, 4, 8))):
        a = np.ascontiguousarray(a)
        if kind == "f":
            bits, inv = np.unique(a.view(f"u{size}"), return_inverse=True)
            uniq = bits.view(a.dtype)
        else:
            uniq, inv = np.unique(a, return_inverse=True)
        return inv.reshape(-1), [str(u) for u in uniq]
    index: Dict[Optional[str], int] = {}
    inv = np.fromiter((index.setdefault(None if v is None else str(v),
                                        len(index)) for v in a),
                      np.int64, len(a))
    return inv, list(index)


class OneHotModelConverter(SimpleModelDataConverter):
    def serialize_model(self, model: Dict[str, List[str]]):
        return Params({"cols": list(model)}), [json.dumps(model)]

    def deserialize_model(self, meta, data):
        return json.loads(data[0])


class OneHotTrainBatchOp(BatchOperator, HasSelectedCols):
    """reference: feature/OneHotTrainBatchOp — vocab per selected column
    (each distinct ``str(v)``, sorted as strings)."""

    def link_from(self, in_op: BatchOperator) -> "OneHotTrainBatchOp":
        t = in_op.get_output_table()
        model = {}
        for c in self.get_selected_cols():
            _, strs = _distinct_strs(t.col(c))
            model[c] = sorted({s for s in strs if s is not None})
        self._output = OneHotModelConverter().save_model(model)
        return self


class OneHotModelMapper(ModelMapper):
    """Encodes selected columns into ONE sparse vector (reference
    OneHotModelMapper: output is a SparseVector over the concatenated vocab
    space, with a final slot per column for unseen values and ``None``).
    The output column is columnar (``SparseVectorColumn``: a row's
    vector is its columns' slots, ascending, each of value 1.0)."""

    def __init__(self, model_schema, data_schema, params=None, **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.model = None

    def load_model(self, model_table: MTable):
        self.model = OneHotModelConverter().load_model(model_table)

    def map_table(self, data: MTable) -> MTable:
        cols = list(self.model.keys())
        idx = np.empty((data.num_rows, len(cols)), np.int32)
        off = 0
        for k, c in enumerate(cols):
            vocab = self.model[c]
            lookup = {t: i for i, t in enumerate(vocab)}
            inv, strs = _distinct_strs(data.col(c))
            code = np.fromiter((lookup.get(s, len(vocab)) for s in strs),
                               np.int64, len(strs))
            idx[:, k] = off + code[inv]
            off += len(vocab) + 1  # +1 unseen slot
        vecs = SparseVectorColumn(idx, np.ones(idx.shape), off)
        return self._helper(data.schema).build_output(data, [vecs])

    def _helper(self, schema) -> OutputColsHelper:
        out_col = self.params._m.get("output_col") or "one_hot"
        return OutputColsHelper(schema, [out_col], [AlinkTypes.SPARSE_VECTOR],
                                self.params._m.get("reserved_cols"))

    def get_output_schema(self):
        return self._helper(self.data_schema).get_output_schema()


class OneHotPredictBatchOp(ModelMapBatchOp, HasOutputCol, HasReservedCols):
    MAPPER_CLS = OneHotModelMapper


# ---------------------------------------------------------------------------
# Quantile discretizer / bucketizer / binarizer
# ---------------------------------------------------------------------------

class QuantileModelConverter(SimpleModelDataConverter):
    def serialize_model(self, model: Dict[str, List[float]]):
        return Params({"cols": list(model)}), [json.dumps(model)]

    def deserialize_model(self, meta, data):
        return {k: [float(x) for x in v] for k, v in json.loads(data[0]).items()}


class QuantileDiscretizerTrainBatchOp(BatchOperator, HasSelectedCols):
    """reference: feature/QuantileDiscretizerTrainBatchOp — split points at
    uniform quantiles. At ``DEVICE_BINNING_MIN_CELLS`` cells or more one
    pass of ``distributed_quantiles`` on ``device`` (``cuda`` unless the
    caller asks for the CPU; raises without it) takes every column;
    below, exact host ``np.quantile`` a column."""
    NUM_BUCKETS = ParamInfo("num_buckets", int, default=2,
                            validator=RangeValidator(2, None))

    def __init__(self, params: Optional[Params] = None, device=None,
                 **kwargs):
        super().__init__(params, **kwargs)
        self.device = resolve_device(device)

    def link_from(self, in_op: BatchOperator) -> "QuantileDiscretizerTrainBatchOp":
        from ....common.mlenv import MLEnvironment
        from ...common.dataproc.quantile import (DEVICE_BINNING_MIN_CELLS,
                                                 distributed_quantiles)
        t = in_op.get_output_table()
        nb = self.get_num_buckets()
        cols = self.get_selected_cols()
        probs = np.linspace(0, 1, nb + 1)[1:-1]
        model = {}
        if t.num_rows * len(cols) >= DEVICE_BINNING_MIN_CELLS:
            X = np.stack([np.asarray(t.col(c), np.float64) for c in cols], 1)
            qs_all = distributed_quantiles(
                X, probs, env=MLEnvironment(device=self.device))
            for j, c in enumerate(cols):
                model[c] = sorted(set(float(q) for q in qs_all[j]
                                      if np.isfinite(q)))
        else:
            for c in cols:
                v = np.asarray(t.col(c), np.float64)
                v = v[~np.isnan(v)]
                qs = np.quantile(v, probs) if v.size else []
                model[c] = sorted(set(float(q) for q in np.atleast_1d(qs)))
        self._output = QuantileModelConverter().save_model(model)
        return self


class _BucketMapperBase(ModelMapper):
    def __init__(self, model_schema, data_schema, params=None, **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.model = None

    def load_model(self, model_table: MTable):
        self.model = QuantileModelConverter().load_model(model_table)

    def map_table(self, data: MTable) -> MTable:
        outs = []
        for c in self.model:
            cuts = np.asarray(self.model[c], np.float64)
            v = np.asarray(data.col(c), np.float64)
            outs.append(np.searchsorted(cuts, v, side="right").astype(np.int64))
        return self._helper(data.schema).build_output(data, outs)

    def _helper(self, schema) -> OutputColsHelper:
        out_cols = self.params._m.get("output_cols") or list(self.model)
        return OutputColsHelper(schema, out_cols,
                                [AlinkTypes.LONG] * len(out_cols))

    def get_output_schema(self):
        return self._helper(self.data_schema).get_output_schema()


class QuantileDiscretizerPredictBatchOp(ModelMapBatchOp, HasOutputCols):
    MAPPER_CLS = _BucketMapperBase


class BucketizerBatchOp(BatchOperator, HasSelectedCols, HasOutputCols):
    """reference: feature/BucketizerBatchOp — explicit cut points, no model."""
    CUTS_ARRAY = ParamInfo("cuts_array", list, "per-column cut points", optional=False)

    def link_from(self, in_op: BatchOperator) -> "BucketizerBatchOp":
        t = in_op.get_output_table()
        cols = self.get_selected_cols()
        out_cols = self.params._m.get("output_cols") or cols
        outs = []
        for c, cuts in zip(cols, self.get_cuts_array()):
            v = np.asarray(t.col(c), np.float64)
            outs.append(np.searchsorted(np.asarray(cuts, np.float64), v,
                                        side="right").astype(np.int64))
        helper = OutputColsHelper(t.schema, out_cols, [AlinkTypes.LONG] * len(out_cols))
        self._output = helper.build_output(t, outs)
        return self


class BinarizerBatchOp(BatchOperator, HasSelectedCol, HasOutputCol):
    """reference: feature/BinarizerBatchOp."""
    THRESHOLD = ParamInfo("threshold", float, default=0.0)

    def link_from(self, in_op: BatchOperator) -> "BinarizerBatchOp":
        t = in_op.get_output_table()
        c = self.get_selected_col()
        out = self.params._m.get("output_col") or c
        v = np.asarray(t.col(c), np.float64)
        helper = OutputColsHelper(t.schema, [out], [AlinkTypes.DOUBLE])
        self._output = helper.build_output(t, [(v > self.get_threshold()).astype(np.float64)])
        return self


# ---------------------------------------------------------------------------
# ChiSqSelector
# ---------------------------------------------------------------------------

class ChiSqSelectorBatchOp(BatchOperator, HasSelectedCols, HasLabelCol):
    """reference: feature/ChiSqSelectorBatchOp — rank columns by chi-square
    statistic against the label; output the selected column subset."""
    NUM_TOP_FEATURES = ParamInfo("num_top_features", int, default=10)

    def link_from(self, in_op: BatchOperator) -> "ChiSqSelectorBatchOp":
        from ...common.statistics.hypothesis import chi_square_test
        t = in_op.get_output_table()
        cols = self.get_selected_cols()
        label = t.col(self.get_label_col())
        scored = []
        for c in cols:
            stat, p, _ = chi_square_test(t.col(c), label)
            scored.append((p, c, stat))
        scored.sort(key=lambda x: x[0])
        chosen = [c for _, c, _ in scored[: self.get_num_top_features()]]
        keep = [c for c in t.col_names if c in set(chosen) or c not in set(cols)]
        self._output = t.select(keep)
        self._side_outputs = [MTable({"col": [c for _, c, _ in scored],
                                      "p_value": [p for p, _, _ in scored],
                                      "chi2": [s for _, _, s in scored]})]
        return self


class VectorChiSqSelectorBatchOp(BatchOperator, HasVectorCol, HasSelectedCol,
                                 HasLabelCol):
    """reference: feature/VectorChiSqSelectorBatchOp — rank vector components
    by chi-square against the label, keep the top ones (sliced vector out)."""
    NUM_TOP_FEATURES = ParamInfo("num_top_features", int, default=10)

    def link_from(self, in_op: BatchOperator) -> "VectorChiSqSelectorBatchOp":
        from ...common.statistics.hypothesis import chi_square_test
        t = in_op.get_output_table()
        col = self.params._m.get("vector_col") or self.params._m.get("selected_col")
        X = extract_dense_matrix(t, None, col)
        label = t.col(self.get_label_col())
        scored = []
        for j in range(X.shape[1]):
            stat, p, _ = chi_square_test(X[:, j], label)
            scored.append((p, j, stat))
        scored.sort(key=lambda x: (x[0], x[1]))
        chosen = sorted(j for _, j, _ in scored[: self.get_num_top_features()])
        self._chosen = chosen
        vecs = np.empty(t.num_rows, object)
        vecs[:] = [DenseVector(x) for x in X[:, chosen]]
        helper = OutputColsHelper(t.schema, [col], [AlinkTypes.DENSE_VECTOR])
        self._output = helper.build_output(t, [vecs])
        self._side_outputs = [MTable({"index": [j for _, j, _ in scored],
                                      "p_value": [p for p, _, _ in scored],
                                      "chi2": [s for _, _, s in scored]})]
        return self


# ---------------------------------------------------------------------------
# PCA
# ---------------------------------------------------------------------------

class PcaModelConverter(SimpleModelDataConverter):
    def serialize_model(self, model):
        mean, std, components, explained = model
        meta = Params({"k": components.shape[0]})
        return meta, [encode_array(mean), encode_array(std),
                      encode_array(components), encode_array(explained)]

    def deserialize_model(self, meta, data):
        return (decode_array(data[0]), decode_array(data[1]),
                decode_array(data[2]), decode_array(data[3]))


class PcaTrainBatchOp(BatchOperator, HasSelectedCols, HasVectorCol):
    """reference: feature/pca/PcaTrainBatchOp — SVD of the centred (CORR:
    and scaled by the population std) data on the host, numpy's, as in
    the JAX package (a device SVD may flip a component's sign)."""
    K = ParamInfo("k", int, "principal components", optional=False,
                  validator=RangeValidator(1, None))
    CALCULATION_TYPE = ParamInfo("calculation_type", str, default="CORR",
                                 validator=InValidator(["CORR", "COV"]))

    def link_from(self, in_op: BatchOperator) -> "PcaTrainBatchOp":
        t = in_op.get_output_table()
        X = extract_dense_matrix(t, self.params._m.get("selected_cols"),
                                 self.params._m.get("vector_col"))
        k = self.get_k()
        mean = X.mean(0)
        Xc = X - mean
        if self.get_calculation_type().upper() == "CORR":
            std = X.std(0)
            std = np.where(std < 1e-12, 1.0, std)
            Xc = Xc / std
        else:
            std = np.ones_like(mean)
        _, s, vt = np.linalg.svd(np.asarray(Xc, np.float64),
                                 full_matrices=False)
        var = (s ** 2) / max(X.shape[0] - 1, 1)
        explained = var / max(var.sum(), 1e-300)
        self._output = PcaModelConverter().save_model(
            (mean, std, vt[:k], explained[:k]))
        return self


class PcaModelMapper(ModelMapper):
    def __init__(self, model_schema, data_schema, params=None, **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.model = None

    def load_model(self, model_table: MTable):
        self.model = PcaModelConverter().load_model(model_table)

    def map_table(self, data: MTable) -> MTable:
        mean, std, comps, _ = self.model
        X = extract_dense_matrix(data, self.params._m.get("selected_cols"),
                                 self.params._m.get("vector_col"))
        Z = ((X - mean) / std) @ comps.T
        vecs = np.empty(len(Z), object)
        vecs[:] = [DenseVector(z) for z in Z]
        return self._helper(data.schema).build_output(data, [vecs])

    def _helper(self, schema) -> OutputColsHelper:
        out_col = self.params._m.get("prediction_col") \
            or self.params._m.get("output_col") or "pca"
        return OutputColsHelper(schema, [out_col], [AlinkTypes.DENSE_VECTOR],
                                self.params._m.get("reserved_cols"))

    def get_output_schema(self):
        return self._helper(self.data_schema).get_output_schema()


class PcaPredictBatchOp(ModelMapBatchOp, HasSelectedCols, HasVectorCol,
                        HasOutputCol, HasReservedCols):
    MAPPER_CLS = PcaModelMapper
    PREDICTION_COL = ParamInfo("prediction_col", str, "output vector column")


# ---------------------------------------------------------------------------
# DCT
# ---------------------------------------------------------------------------

class DCTBatchOp(BatchOperator, HasSelectedCol, HasOutputCol):
    """reference: dataproc/DCTBatchOp over FFT.java — the orthonormal
    DCT-II of every row (``inverse``: its inverse), in float64 on
    ``device`` (``cuda`` unless the caller asks for the CPU; raises
    without it)."""
    INVERSE = ParamInfo("inverse", bool, default=False)

    def __init__(self, params: Optional[Params] = None, device=None,
                 **kwargs):
        super().__init__(params, **kwargs)
        self.device = resolve_device(device)

    def link_from(self, in_op: BatchOperator) -> "DCTBatchOp":
        t = in_op.get_output_table()
        c = self.get_selected_col()
        col = np.empty(t.num_rows, object)
        if t.num_rows:
            X = np.stack([VectorUtil.parse(v).to_dense().data
                          for v in t.col(c)])
            Y = dct2_ortho(torch.from_numpy(X).to(self.device),
                           inverse=self.get_inverse()).cpu().numpy()
            col[:] = [DenseVector(y) for y in Y]
        out = self.params._m.get("output_col") or c
        helper = OutputColsHelper(t.schema, [out], [AlinkTypes.DENSE_VECTOR])
        self._output = helper.build_output(t, [col])
        return self


def dct2_ortho(X: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The orthonormal DCT-II of every row of the float64 ``X`` (n, m)
    (``inverse``: DCT-III, its inverse), on ``X``'s device: the forward
    transform through the FFT of the row and its mirror, the inverse as
    one product with the orthonormal basis (the JAX package's
    ``_dct2_ortho``, its constants formed the same way)."""
    n = X.shape[1]
    f64 = dict(dtype=torch.float64, device=X.device)
    if not inverse:
        ext = torch.cat([X, X.flip(1)], dim=1)
        spec = torch.fft.fft(ext, dim=1)[:, :n]
        phase = torch.exp(-1j * math.pi * torch.arange(n, **f64) / (2 * n))
        y = (spec * phase).real / 2.0
        scale = torch.cat([torch.tensor([1.0 / np.sqrt(n)], **f64),
                           torch.full((n - 1,), np.sqrt(2.0 / n), **f64)])
        return y * scale
    k = torch.arange(n, **f64)
    basis = torch.cos(math.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    scale = torch.cat([torch.tensor([math.sqrt(1.0 / n)], **f64),
                       torch.full((n - 1,), math.sqrt(2.0 / n), **f64)])
    return X @ (basis * scale[:, None])
