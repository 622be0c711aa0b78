"""Feature hashing (murmur into a fixed dim).

Counterpart: ``alink_tpu/operator/batch/feature/feature_ops.py``.
Ported: ``murmur32``, ``_format_tokens``, ``murmur32_cells`` and
``FeatureHasherBatchOp`` (the flat layout and ``field_aware=True``),
the Criteo / avazu front end of the reference's FTRLExample.java:46-57.

:func:`murmur32_cells` hashes a batch in one call of the port's native
library (``alink_tpu_torch/native``, ``murmur_batch``), as the JAX
package does; there is no fallback. :func:`murmur32_cells_plain` is its
plain version: MurmurHash3 x86 32 vectorized in numpy over the ``(n, w)``
byte matrix of the tokens (the 4-byte blocks a column of words at a
time, then the 0-3-byte tail and the final mix, in uint32 arithmetic),
bitwise to :func:`murmur32`, which the tests hold the library against.

Not ported yet: OneHot, QuantileDiscretizer, Bucketizer, Binarizer,
ChiSqSelector, PCA and DCT (ROADMAP Queue A).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ....common.params import ParamInfo, RangeValidator
from ....common.types import AlinkTypes
from ....common.vector import SparseVector, SparseVectorColumn
from ....mapper.base import OutputColsHelper
from ....native import murmur32_batch
from ....params.shared import HasOutputCol, HasReservedCols, HasSelectedCols
from ...base import BatchOperator

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
