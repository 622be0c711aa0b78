"""FTRL online learning — the trainer and the hot-reloading predictor.

Counterpart: ``alink_tpu/operator/stream/onlinelearning/ftrl.py``
(re-design of the reference's stream/onlinelearning/FtrlTrainStreamOp.java
and FtrlPredictStreamOp.java).

Ported: the FTRL-proximal closed form (:func:`ftrl_weights`, the JAX
package's ``_ftrl_weights``); the three strict or chunked sparse steps the
JAX package builds in ``_ftrl_sparse_step_factory`` (``update_mode=
"sample"``, the default), ``_ftrl_sparse_staleness_step_factory`` and
``_ftrl_sparse_chained_step_factory``; the batch steps of ``update_mode=
"batch"``, ``_ftrl_sparse_batch_step_factory`` (:func:`ftrl_batch_step`),
``_ftrl_fb_batch_step_factory`` (:func:`ftrl_fb_batch_step`, both value
variants) and ``_ftrl_dense_batch_step_factory``
(:func:`ftrl_dense_batch_step`); the dense strict step of
``_ftrl_step_factory`` (:func:`ftrl_dense_step`); :class:`FtrlTrainStreamOp`
on sparse, field-aware and dense input, with its layouts (the
field-blocked state and its exact demotion), its batch hook and its
device snapshot consumer; and :class:`FtrlPredictStreamOp`.

On one device the JAX package's feature sharding degenerates: every
slot is local (``lo = 0``), the margin ``psum`` is the identity and the
``where(local, ., 0)`` masks select everything, so the steps below drop
them. The strict and chunked sparse steps are a Python loop over chunks
of K rows on the device-resident ``(z, n)`` state, its gathers,
scatter-adds and (in the strict steps) the walk of each chunk's samples
going through the CUDA kernels of ``kernels/ftrl.py`` (on the CPU, their
plain versions): four launches a chunk. The batch steps gather the
touched slots once (``gather_pair``), compute in eager PyTorch, and add
the micro-batch into the state with the ordered scatter-add
(``kernels/linear.py::scatter_walk``: in place, padded-COO; into a
zeroed float32 buffer of the deltas, field-blocked). The dense steps are
eager PyTorch: the batch one a product and column sums, the strict one
a loop of about 35 small ops a sample.

Durability, as in the JAX package: with ``checkpoint_dir`` and
``checkpoint_every_batches`` the drain persists the ``(z, n)`` state
every N micro-batches and at the end of the stream (one fetch of the
state a boundary, ``common/checkpoint.py``), and a restarted op with the
same directory resumes from the newest valid snapshot: it skips the
committed prefix of the replayed input before encoding it, keeps the
micro-batch geometry of the uninterrupted drain (the batch size latched
on the first micro-batch, the padded-COO width the committed batches
reached, the layout), and ends with the uninterrupted drain's model, bit
for bit, on a deterministic source. A snapshot of another configuration
(:func:`ftrl_checkpoint_signature`) raises ``CheckpointError``.

Left out, raising ``NotImplementedError``: ``health`` (ROADMAP Queue
A10). Not ported: the feature-sharded state, the compile plane, metrics
and tracing.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ....common.checkpoint import (CheckpointError, load_latest_validated,
                                   save_checkpoint)
from ....common.device import resolve_device
from ....common.faults import maybe_crash
from ....common.mtable import MTable
from ....common.params import InValidator, ParamInfo, Params, RangeValidator
from ....common.types import TableSchema
from ....engine.recovery import payload_bytes, record
from ....kernels.ftrl import (ftrl_weights, gather_pair, gather_rows,
                              scatter_add_rows, sigmoid, walk_chunk)
from ....kernels.linear import scatter_walk
from ....ops.fieldblock import (FieldBlockMeta, detect_fieldblock,
                                fb_flat, fb_gather)
from ....params.shared import (HasFeatureCols, HasLabelCol, HasPredictionCol,
                               HasPredictionDetailCol, HasReservedCols,
                               HasVectorCol)
from ...base import BatchOperator, StreamOperator
from ...common.dataproc.feature_extract import extract_design
from ...common.linear.base import (LinearModelData, LinearModelDataConverter,
                                   LinearModelType)
from ...common.linear.mapper import LinearModelMapper
from ..core import merge_timed
from ..prefetch import prefetch

# samples per chunk of the strict per-sample step (the JAX package's K)
SAMPLE_CHUNK = 4
_SHIP_NP = {torch.float32: np.float32, torch.float64: np.float64}


def _corrupt_snapshot_table(snap: MTable) -> MTable:
    """The ``feeder.snapshot`` fault site's ``corrupt`` mode
    (``common/faults.py``), as in the JAX package: a copy of the emitted
    model table with the first coefficient payload row mangled into
    invalid JSON, so the consumer's ``load_model`` fails LOUDLY (the
    serving feeder's poisoned-snapshot path) instead of silently serving
    flipped bits. The trainer's own state is not touched."""
    rows = [list(snap.row(i)) for i in range(snap.num_rows)]
    for r in rows:
        # payload rows carry model_id >= 1 and a JSON string
        if r[0] and isinstance(r[1], str) and r[1]:
            r[1] = "\x00CORRUPT" + r[1][1:]
            break
    return MTable([tuple(r) for r in rows], snap.schema)


def _pad_rows(idx, val, y, K: int):
    """Pad the micro-batch to a multiple of K rows with zero rows: slot 0
    and value 0.0, algebraic no-ops whose zero adds still land on slot 0,
    as the JAX package's do."""
    B, w = idx.shape
    Bp = -(-B // K) * K
    if Bp != B:
        idx = torch.cat([idx, idx.new_zeros((Bp - B, w))])
        val = torch.cat([val, val.new_zeros((Bp - B, w))])
        y = torch.cat([y, y.new_zeros((Bp - B,))])
    return idx, val, y


def _walk_step(idx, val, y, z, n, alpha, beta, l1, l2, K: int,
               chained: bool):
    """The strict steps' chunk loop: per chunk of K rows one gather of
    the chunk's slots of ``z`` and ``n`` from the pre-chunk state
    (:func:`gather_pair`), one walk of its samples in order
    (:func:`walk_chunk`: corrections, weights, margins, deltas) and one
    in-order scatter-add each for ``z`` and ``n``; four launches a chunk
    on the card, none of them per sample."""
    B, w = idx.shape
    idx, val, y = (t.contiguous() for t in _pad_rows(idx, val, y, K))
    margins = val.new_empty(idx.shape[0])
    chunks = idx.shape[0] // K
    # each chunk's views, made in one call per tensor
    rows = zip(idx.view(chunks, K, w).unbind(0),
               idx.view(chunks, K * w).unbind(0),
               val.view(chunks, K, w).unbind(0),
               y.view(chunks, K).unbind(0))
    for c, (xi, flat, xv, yy) in enumerate(rows):
        zn = gather_pair(z, n, flat)
        dz, dn = walk_chunk(xi, xv, yy, zn, margins, c * K, alpha, beta,
                            l1, l2, chained).unbind(0)
        z = scatter_add_rows(z, flat, dz)
        n = scatter_add_rows(n, flat, dn)
    return z, n, margins[:B]


def ftrl_sample_step(idx, val, y, z, n, alpha, beta, l1, l2):
    """One micro-batch of strict per-sample FTRL (``update_mode=
    "sample"``); the JAX package's ``_ftrl_sparse_step_factory``.

    ``idx`` (B, w) int32 slots and ``val`` (B, w) values of a padded COO
    block, ``y`` (B,) 0/1 labels, ``z``/``n`` (S,) state. Returns ``(z,
    n, margins)``; ``margins`` (B,) are each row's margin at the weights
    it saw. Like the JAX package's donated state, the ``z`` and ``n``
    passed in are dead after the call (here they are updated in place):
    use the returned ones.

    Chunks of K = 4 rows, exact strict semantics: sample k's slots are
    corrected by the deltas of the earlier samples j < k at shared slots,
    one in-order partial per earlier sample added in turn (a selection,
    no matmul, so no TF32); see :func:`_walk_step`.
    """
    return _walk_step(idx, val, y, z, n, alpha, beta, l1, l2,
                      SAMPLE_CHUNK, chained=False)


def ftrl_staleness_step(idx, val, y, z, n, alpha, beta, l1, l2, K: int):
    """One micro-batch of bounded-staleness FTRL (``update_mode=
    "staleness"``); the JAX package's
    ``_ftrl_sparse_staleness_step_factory``.

    Every row of a chunk of K computes its margin and gradient at the
    weights from before the chunk (staleness <= K - 1 samples); the
    chunk's updates land in one in-order scatter-add on the state
    stacked as (S, 2), after one gather. ``K = 1`` is the strict
    per-sample program. Arguments and result as
    :func:`ftrl_sample_step`; ``z`` and ``n`` are left as they were and
    new state is returned.
    """
    B = idx.shape[0]
    idx, val, y = _pad_rows(idx, val, y, K)
    w = idx.shape[1]
    zn = torch.stack([z, n], -1)                         # (S, 2)
    margins: List[torch.Tensor] = []
    for c in range(0, idx.shape[0], K):
        xi, xv, yy = idx[c:c + K], val[c:c + K], y[c:c + K]
        flat = xi.reshape(-1)
        s = gather_rows(zn, flat).view(K, w, 2)
        zj, nj = s[..., 0], s[..., 1]
        wj = ftrl_weights(zj, nj, alpha, beta, l1, l2)
        m = (xv * wj).sum(-1)
        g = (sigmoid(m) - yy)[:, None] * xv
        gg = g * g
        sigma = (torch.sqrt(nj + gg) - torch.sqrt(nj)) / alpha
        zn = scatter_add_rows(
            zn, flat, torch.stack([(g - sigma * wj).reshape(-1),
                                   gg.reshape(-1)], -1))
        margins.append(m)
    return (zn[:, 0].contiguous(), zn[:, 1].contiguous(),
            torch.cat(margins)[:B])


def ftrl_chained_step(idx, val, y, z, n, alpha, beta, l1, l2, K: int = 16):
    """One micro-batch of chained-correction strict FTRL (``update_mode=
    "chained"``); the JAX package's ``_ftrl_sparse_chained_step_factory``.

    Chunks of K rows: sample k's slots are corrected by ``sum_{j<k}
    M[k, j] @ D[j]``, the collision tensor of the chunk against the
    (K, w, 2) deltas of the earlier samples, one ordered chain per slot
    (the contract of ``kernels/ftrl.py::chained_corr_plain``); see
    :func:`_walk_step`. Strict semantics: the only difference from the
    per-sample step is the association of the corrections. Arguments and
    result as :func:`ftrl_sample_step` (the state passed in is updated in
    place).
    """
    return _walk_step(idx, val, y, z, n, alpha, beta, l1, l2, K,
                      chained=True)


def ftrl_batch_step(idx, val, y, z, n, alpha, beta, l1, l2):
    """One micro-batch of batched FTRL on a padded-COO block
    (``update_mode="batch"``); the JAX package's
    ``_ftrl_sparse_batch_step_factory``.

    Every row's gradient is taken at the weights from before the
    micro-batch: one gather of the touched slots' ``(z, n)``
    (:func:`gather_pair`), the weights, margins ``(val * wj).sum(-1)``
    and deltas in eager PyTorch, and one ordered scatter-add of ``(dz,
    dn)`` into ``(z, n)`` in row-major order (``scatter_walk``: duplicate
    slots accumulate in update order, as ``z.at[li].add(dz)`` does).
    Arguments and result as :func:`ftrl_sample_step`; the state passed in
    is updated in place and returned.
    """
    B, w = idx.shape
    idx = idx.contiguous()
    zn = gather_pair(z, n, idx.view(-1)).view(B, w, 2)
    zj, nj = zn[..., 0], zn[..., 1]
    wj = ftrl_weights(zj, nj, alpha, beta, l1, l2)
    margins = (val * wj).sum(-1)
    g = (sigmoid(margins) - y)[:, None] * val
    gg = g * g
    sigma = (torch.sqrt(nj + gg) - torch.sqrt(nj)) / alpha
    scatter_walk(z, n, idx, torch.stack([g - sigma * wj, gg], -1))
    return z, n, margins


def ftrl_fb_batch_step(fb_idx, val, y, z, n, meta: FieldBlockMeta,
                       alpha, beta, l1, l2):
    """One micro-batch of batched FTRL on a field-blocked block; the JAX
    package's ``_ftrl_fb_batch_step_factory`` (``val=None``: its
    ``with_val=False`` program, a full batch of one-hot rows whose values
    are 1.0 and are not shipped).

    ``fb_idx`` (B, F) field-local indices (int16 or int32), ``val`` (B, F)
    values or None, ``y`` (B,), ``z``/``n`` the ``meta.dim`` state. The
    JAX package's float32 arithmetic whatever the state dtype: the
    touched slots' ``n`` and ``w`` are gathered and rounded to float32
    (``fb_gather``), and the deltas are rounded to float32 and summed a
    slot in float32 from ``+0.0`` (one ``scatter_walk`` of the pairs into
    a zeroed float32 ``(2, dim)`` buffer, in row order where the JAX
    package's one-hot product sums in XLA's order), then added to the
    state: ``z + dz``, ``n + dn``. Returns new ``(z, n, margins)``.
    """
    flat = fb_flat(fb_idx, meta)
    nw = fb_gather(fb_idx, n, meta,
                   other=ftrl_weights(z, n, alpha, beta, l1, l2))
    nj, wj = nw[..., 0], nw[..., 1]
    v = (torch.ones(flat.shape, dtype=torch.float32, device=flat.device)
         if val is None else val)
    margins = (v * wj).sum(-1)
    g = (sigmoid(margins) - y)[:, None] * v
    sigma = (torch.sqrt(nj + g * g) - torch.sqrt(nj)) / alpha
    d = torch.zeros((2, meta.dim), dtype=torch.float32, device=flat.device)
    scatter_walk(d[0], d[1], flat,
                 torch.stack([g - sigma * wj, g * g], -1).to(torch.float32))
    return z + d[0].to(z.dtype), n + d[1].to(n.dtype), margins


def ftrl_dense_batch_step(X, y, z, n, alpha, beta, l1, l2):
    """One micro-batch of batched FTRL on dense rows ``X`` (B, dim); the
    JAX package's ``_ftrl_dense_batch_step_factory``: the margins ``X @
    w`` (``torch.mv``) at the pre-batch weights, then the deltas' column
    sums added to the state. Returns new ``(z, n, margins)``."""
    w = ftrl_weights(z, n, alpha, beta, l1, l2)
    margins = torch.mv(X, w)
    g = (sigmoid(margins) - y)[:, None] * X
    sigma = (torch.sqrt(n[None, :] + g * g) - torch.sqrt(n[None, :])) / alpha
    return (z + (g - sigma * w[None, :]).sum(0), n + (g * g).sum(0),
            margins)


def ftrl_dense_step(X, y, z, n, alpha, beta, l1, l2):
    """One micro-batch of strict per-sample FTRL on dense rows ``X``
    (B, dim); the JAX package's ``_ftrl_step_factory`` (its ``lax.scan``
    over the rows as a Python loop). Each sample sees the weights of
    every earlier sample's update, over the full-width state: about 35
    small device ops a sample, none of them a kernel of this package.
    Returns new ``(z, n, margins)``."""
    margins = X.new_empty(X.shape[0])
    for i, x in enumerate(X):
        w = ftrl_weights(z, n, alpha, beta, l1, l2)
        m = torch.dot(x, w)
        margins[i] = m
        g = (sigmoid(m) - y[i]) * x
        sigma = (torch.sqrt(n + g * g) - torch.sqrt(n)) / alpha
        z = z + g - sigma * w
        n = n + g * g
    return z, n, margins


def progressive_logloss_sum(margins, y):
    """Sum of the log losses of ``margins`` (computed at pre-update
    weights, so this is progressive validation) against 0/1 labels ``y``,
    as a device scalar; margins clipped to [-35, 35] as the steps clip."""
    m = torch.clamp(margins, -35.0, 35.0)
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    return (torch.logaddexp(zero, -m) * y
            + torch.logaddexp(zero, m) * (1.0 - y)).sum()


class Encoded(NamedTuple):
    """One micro-batch as the trainer ships it: ``kind`` ``"sparse"``
    (``arrays`` = idx, val, y: a padded COO block, the intercept an
    explicit ``(0, 1.0)`` entry), ``"dense"`` (X, y: the intercept a
    column of ones) or ``"fb"`` (fb_idx, val or None, y: field-local
    indices, the intercept a field of its own, ``meta`` its layout);
    host arrays after :meth:`FtrlTrainer.encode`, device tensors after
    :meth:`FtrlTrainer.to_device`."""
    kind: str
    arrays: tuple
    width: int = 0
    meta: Optional[FieldBlockMeta] = None


class FtrlTrainer:
    """The parts of one FTRL drain, one micro-batch at a time:
    :meth:`encode` (host), :meth:`to_device`, :meth:`step` on the
    device-resident state, and :meth:`snapshot` (device to host, model
    table). :class:`FtrlTrainStreamOp` drives them; they are public so a
    caller can time each stage.

    The state has one of two layouts: ``"std"``, the model's coefficient
    order, and ``"fb"`` (field-aware input in batch mode), the intercept
    field of ``fb_S`` slots (only slot 0 used) then the field-major
    features, so a field-blocked micro-batch addresses it by field."""

    def __init__(self, init: LinearModelData, *, alpha: float, beta: float,
                 l1: float, l2: float, update_mode: str, staleness: int,
                 chunk_size: int, vector_col: Optional[str],
                 feature_cols: Optional[List[str]], label_col: str,
                 device: torch.device, ship_dtype: torch.dtype):
        if ship_dtype not in _SHIP_NP:
            raise ValueError(f"ship_dtype {ship_dtype}: want float32 or "
                             f"float64")
        self.init = init
        self.alpha, self.beta, self.l1, self.l2 = alpha, beta, l1, l2
        self.update_mode = update_mode
        self.staleness, self.chunk_size = staleness, chunk_size
        self.vector_col, self.feature_cols = vector_col, feature_cols
        self.label_col = label_col
        self.device, self.ship_dtype = device, ship_dtype
        self.ship_np = _SHIP_NP[ship_dtype]
        self.dim = int(np.asarray(init.coef).shape[0])  # with the intercept
        self.has_intercept = bool(init.has_intercept)

    # -- host side ---------------------------------------------------------
    def labels(self, mt: MTable, b: int, batch_size: int) -> np.ndarray:
        """0/1 labels, padded to ``batch_size``; the positive label is the
        warm-start model's ``label_values[0]``."""
        raw = mt.col(self.label_col)
        pos = str(self.init.label_values[0])
        y = np.zeros(batch_size, self.ship_np)
        r = np.asarray(raw[:b])
        if r.dtype != object and r.dtype.kind != "S":
            # numpy str() formatting matches str(v) per scalar (bytes do
            # not: keep them on the exact path)
            y[:b] = (r.astype("U") == pos)
        else:
            y[:b] = [1.0 if str(v) == pos else 0.0 for v in r]
        return y

    def encode(self, mt: MTable, batch_size: int, width: int = 8,
               allow_fb: bool = False) -> Encoded:
        """The micro-batch padded to ``batch_size`` rows. Dense input
        (``feature_cols``, or dense vectors) becomes a (batch_size, dim)
        block. Sparse input becomes a padded COO block whose width grows in
        steps of 8 from the given one and never shrinks; or, with
        ``allow_fb`` (batch mode, before the state has committed to the
        generic layout), a field-blocked block when the rows are
        field-aware hashed (``detect_fieldblock``): int16 indices when a
        field's slots fit, and no value block for a full micro-batch of
        one-hot rows."""
        ship = self.ship_np
        design = extract_design(mt, self.feature_cols, self.vector_col, ship,
                                vector_size=self.init.vector_size or None)
        b = mt.num_rows
        icpt = self.has_intercept
        y = self.labels(mt, b, batch_size)
        if design["kind"] == "dense":
            Xf = design["X"]
            X = np.zeros((batch_size, self.dim), ship)
            if icpt:
                X[:b, 0] = 1.0
                X[:b, 1:1 + Xf.shape[1]] = Xf
            else:
                X[:b, :Xf.shape[1]] = Xf
            return Encoded("dense", (X, y))
        idx0, val0 = design["idx"], design["val"]
        hi = int(idx0.max()) if idx0.size else -1
        if hi + (1 if icpt else 0) >= self.dim:
            raise IndexError(
                f"sparse feature index {hi} out of range for the "
                f"warm-start model (dim {self.dim}); the dense path fails "
                f"loudly on the same input")
        if allow_fb:
            fbd = detect_fieldblock(idx0, val0, self.dim - (1 if icpt else 0))
            if fbd is not None:
                fb_local, fb_val, meta0 = fbd
                c0 = 1 if icpt else 0
                idt = (np.int16 if meta0.field_size <= np.iinfo(np.int16).max
                       else np.int32)
                fbi = np.zeros((batch_size, meta0.num_fields + c0), idt)
                fbi[:b, c0:] = fb_local
                meta = FieldBlockMeta(meta0.num_fields + c0, meta0.field_size)
                if fb_val is None and b == batch_size:
                    # padding rows rely on val == 0 to be no-ops, so only
                    # a full batch goes without values
                    return Encoded("fb", (fbi, None, y), meta=meta)
                fbv = np.zeros(fbi.shape, ship)
                if icpt:
                    fbv[:b, 0] = 1.0           # intercept field, local 0
                fbv[:b, c0:] = 1.0 if fb_val is None else fb_val
                return Encoded("fb", (fbi, fbv, y), meta=meta)
        if icpt:
            idx0 = np.concatenate(
                [np.zeros((b, 1), idx0.dtype), idx0 + 1], axis=1)
            val0 = np.concatenate(
                [np.ones((b, 1), val0.dtype), val0], axis=1)
        w0 = idx0.shape[1]
        width = max(width, -(-w0 // 8) * 8)
        idx = np.zeros((batch_size, width), np.int32)
        val = np.zeros((batch_size, width), ship)
        idx[:b, :w0] = idx0
        val[:b, :w0] = val0
        return Encoded("sparse", (idx, val, y), width=width)

    # -- device side -------------------------------------------------------
    def to_device(self, enc: Encoded) -> Encoded:
        return enc._replace(arrays=tuple(
            None if a is None else torch.from_numpy(a).to(self.device)
            for a in enc.arrays))

    def fb_size(self, meta: FieldBlockMeta) -> int:
        """The fb layout's state size: the features' and, with an
        intercept, its field of ``field_size`` slots."""
        return (self.dim - 1 + meta.field_size if self.has_intercept
                else self.dim)

    def initial_state(self, enc: Optional[Encoded] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The warm start in the layout ``enc`` takes (the fb layout for a
        field-blocked micro-batch): ``z = -coef * (beta/alpha + l2)`` and
        ``n = 0``, whose weights are the initial model's coefficients."""
        zc = -np.asarray(self.init.coef, np.float64) \
            * (self.beta / self.alpha + self.l2)
        if enc is not None and enc.kind == "fb":
            z0 = np.zeros(self.fb_size(enc.meta))
            if self.has_intercept:
                S = enc.meta.field_size
                z0[0] = zc[0]
                z0[S:S + self.dim - 1] = zc[1:]
            else:
                z0[:] = zc
        else:
            z0 = zc
        z = torch.from_numpy(z0).to(self.device, self.ship_dtype)
        return z, torch.zeros_like(z)

    def to_std_state(self, z, n, fb_S: int):
        """The exact fb -> std translation: dropping the intercept field's
        unused slots loses nothing."""
        if not self.has_intercept:
            return z[:self.dim].clone(), n[:self.dim].clone()
        span = slice(fb_S, fb_S + self.dim - 1)
        return (torch.cat([z[:1], z[span]]), torch.cat([n[:1], n[span]]))

    def step(self, enc: Encoded, z, n):
        """One micro-batch in this trainer's update mode: ``(z, n,
        margins)``; the state passed in is dead afterwards. Dense rows
        outside batch mode take the strict dense step (the JAX package's
        dense scan, in every strict or chunked mode)."""
        hyper = (self.alpha, self.beta, self.l1, self.l2)
        a = enc.arrays
        if enc.kind == "fb":
            return ftrl_fb_batch_step(a[0], a[1], a[2], z, n, enc.meta,
                                      *hyper)
        if enc.kind == "dense":
            if self.update_mode == "batch":
                return ftrl_dense_batch_step(*a, z, n, *hyper)
            return ftrl_dense_step(*a, z, n, *hyper)
        if self.update_mode == "batch":
            return ftrl_batch_step(*a, z, n, *hyper)
        if self.update_mode == "staleness":
            return ftrl_staleness_step(*a, z, n, *hyper, self.staleness)
        if self.update_mode == "chained":
            return ftrl_chained_step(*a, z, n, *hyper, self.chunk_size)
        return ftrl_sample_step(*a, z, n, *hyper)

    def weights(self, z, n) -> torch.Tensor:
        return ftrl_weights(z, n, self.alpha, self.beta, self.l1, self.l2)

    def snapshot(self, z, n, fb_S: Optional[int] = None) -> MTable:
        """The model table of the live state (one device-to-host fetch);
        ``fb_S`` the field size of an fb-layout state, whose intercept and
        features map back to the model's coefficient order."""
        w = self.weights(z, n).cpu().numpy()
        if fb_S is not None and self.has_intercept:
            w = np.concatenate([w[:1], w[fb_S:fb_S + self.dim - 1]])
        else:
            w = w[:self.dim]
        init = self.init
        m = LinearModelData(
            model_name="FTRL", linear_model_type=LinearModelType.LR,
            has_intercept=init.has_intercept, vector_col=init.vector_col,
            feature_names=init.feature_names, vector_size=init.vector_size,
            coef=w, label_values=list(init.label_values),
            label_type=init.label_type)
        return LinearModelDataConverter(init.label_type).save_model(m)


def ftrl_checkpoint_signature(trainer: FtrlTrainer) -> Dict[str, Any]:
    """The identity of an FTRL drain's snapshots, with the keys of the JAX
    package's (``common/plan.py::ftrl_checkpoint_signature``): the
    hyperparameters, the geometry (one device: ``dim_pad`` is ``dim``),
    the update mode with its chunk sizes, and a blake2b of the warm-start
    coefficients (a same-dim but different warm model is another model).
    The input stream itself cannot be fingerprinted at link time: resume
    assumes a deterministic, replayed source."""
    warm = hashlib.blake2b(np.ascontiguousarray(
        np.asarray(trainer.init.coef)).tobytes(), digest_size=12).hexdigest()
    mode = trainer.update_mode
    sig: Dict[str, Any] = {
        "kind": "ftrl_state", "alpha": trainer.alpha, "beta": trainer.beta,
        "l1": trainer.l1, "l2": trainer.l2, "dim": trainer.dim,
        "dim_pad": trainer.dim, "update_mode": mode,
        "staleness": trainer.staleness if mode == "staleness" else None,
        "has_intercept": trainer.has_intercept, "warm_coef_blake2b": warm}
    if mode == "chained":
        sig["chunk_size"] = trainer.chunk_size
    return sig


class FtrlTrainStreamOp(StreamOperator, HasVectorCol, HasFeatureCols, HasLabelCol):
    """Online FTRL trainer; output is the model-snapshot stream.

    Requires a batch-trained initial linear model (warm start), exactly as
    the reference does (FtrlTrainStreamOp.java:56-60). ``device`` is
    resolved once: ``cuda`` by default, ``RuntimeError`` without it.
    ``ship_dtype`` is the state and value dtype: float32 on the card,
    float64 to match the JAX package under x64.
    """

    ALPHA = ParamInfo("alpha", float, default=0.1)
    BETA = ParamInfo("beta", float, default=1.0)
    L1 = ParamInfo("l1", float, default=0.0)
    L2 = ParamInfo("l2", float, default=0.0)
    TIME_INTERVAL = ParamInfo("time_interval", float, default=1.0)
    VECTOR_SIZE = ParamInfo("vector_size", int, default=0)
    WITH_INTERCEPT = ParamInfo("with_intercept", bool, default=True)
    # "sample" = strict per-sample order; "chained" = the same strict
    # semantics through the chained-correction chunk step; "staleness" =
    # gradients at weights <= staleness-1 samples old (the reference's
    # feedback-edge contract, FtrlTrainStreamOp.java:120-135, with the
    # bound made explicit); "batch" = gradients at the pre-batch weights,
    # one update a micro-batch (exact for collision-free batches)
    UPDATE_MODE = ParamInfo("update_mode", str, default="sample",
                            validator=InValidator(["sample", "chained",
                                                   "staleness", "batch"]))
    STALENESS = ParamInfo("staleness", int, default=32,
                          description="chunk size for update_mode="
                                      "'staleness' (max update delay in "
                                      "samples)",
                          validator=RangeValidator(1, None))
    CHUNK_SIZE = ParamInfo("chunk_size", int, default=16,
                           description="chunk length for update_mode="
                                       "'chained'",
                           validator=RangeValidator(1, None))
    # stream durability (common/checkpoint.py): persist the (z, n) state
    # every N micro-batches with bounded retention; a crash-restarted op
    # with the same checkpoint_dir resumes from the newest valid snapshot
    # and SKIPS the already-committed prefix of the (replayed) input
    # stream: on a deterministic source the recovered model is
    # bit-identical to the uninterrupted run's
    CHECKPOINT_DIR = ParamInfo("checkpoint_dir", str, default=None)
    CHECKPOINT_EVERY = ParamInfo("checkpoint_every_batches", int, default=0,
                                 description="micro-batches between state "
                                             "snapshots (0 = off)")
    CHECKPOINT_KEEP = ParamInfo("checkpoint_keep", int, default=3,
                                validator=RangeValidator(1, None))
    RESUME = ParamInfo("resume", bool, default=True,
                       description="resume from the newest valid snapshot "
                                   "in checkpoint_dir when one exists")
    # health monitoring (ROADMAP Queue A10) is not ported yet: a monitor
    # raises NotImplementedError at link
    HEALTH = ParamInfo("health", object, default=None)

    def __init__(self, initial_model: Optional[BatchOperator] = None,
                 params: Optional[Params] = None, device=None,
                 ship_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(params, **kwargs)
        self._initial_model = initial_model
        self.device = resolve_device(device)
        self.ship_dtype = ship_dtype
        self.trainer: Optional[FtrlTrainer] = None
        self._progressive: List[Tuple[int, float]] = []
        self._batch_hook = None
        self._device_snapshot_hook = None

    def set_batch_hook(self, hook) -> "FtrlTrainStreamOp":
        """Register a micro-batch lifecycle hook (the online DAG's pacing
        point): ``hook("pre", b, t)`` runs before batch ``b``'s state
        update (1-based, ``t`` its event time) and ``hook("post", b, t)``
        after the update, and any snapshot emission it triggered, has
        committed. It runs on the drain thread and may block."""
        self._batch_hook = hook
        return self

    def set_device_snapshot_consumer(self, hook) -> "FtrlTrainStreamOp":
        """Register a device-to-device snapshot consumer: at each emission
        boundary ``hook(w_device, info)`` is handed the live device
        weights of the state (in its layout) and ``info`` (``fb_S``,
        ``dim``, ``has_intercept``, ``batch``, ``event_time``). When it
        returns True the host snapshot, and its fetch, is skipped for
        that boundary: nothing is yielded. A False or None return falls
        back to the host snapshot."""
        self._device_snapshot_hook = hook
        return self

    def progressive_logloss(self) -> List[Tuple[int, float]]:
        """``(batch, mean log loss)`` of every micro-batch of the latest
        drain, at the weights each sample saw before its update, fetched
        at the snapshot boundaries."""
        return list(self._progressive)

    def _load_initial(self) -> LinearModelData:
        if self._initial_model is None:
            raise ValueError(
                "FTRL requires an initial batch model (reference "
                "FtrlTrainStreamOp.java:56-60 warm start)")
        return LinearModelDataConverter.load_table(
            self._initial_model.get_output_table())

    def link_from(self, data_op: StreamOperator) -> "FtrlTrainStreamOp":
        m = self.params._m
        if m.get("health") is not None:
            raise NotImplementedError(
                "FtrlTrainStreamOp: health is not ported yet (ROADMAP Queue "
                "A10)")
        init = self._load_initial()
        self._schema = LinearModelDataConverter(init.label_type).schema
        update_mode = m.get("update_mode", "sample")
        trainer = self.trainer = FtrlTrainer(
            init, alpha=float(self.get_alpha()), beta=float(self.get_beta()),
            l1=float(self.get_l1()), l2=float(self.get_l2()),
            update_mode=update_mode, staleness=int(m.get("staleness", 32)),
            chunk_size=int(m.get("chunk_size", 16)),
            vector_col=m.get("vector_col") or init.vector_col,
            feature_cols=m.get("feature_cols") or init.feature_names,
            label_col=self.get_label_col(), device=self.device,
            ship_dtype=self.ship_dtype)
        interval = float(self.get_time_interval())
        batch_mode = update_mode == "batch"
        ck_dir = m.get("checkpoint_dir")
        ck_every = int(m.get("checkpoint_every_batches", 0) or 0)
        ck_keep = int(m.get("checkpoint_keep", 3))
        ck_resume = bool(m.get("resume", True))
        ck_signature = ftrl_checkpoint_signature(trainer) if ck_dir else None

        def restore():
            """The newest valid snapshot's ``(payload, meta)``, checked
            against this drain's signature and ship dtype; None when
            there is none (or resuming is off)."""
            if not (ck_dir and ck_resume):
                return None
            t0 = time.perf_counter()
            got = load_latest_validated(ck_dir, ck_signature, scope="ftrl",
                                        what="FTRL program")
            if got is None:
                return None
            if got[0]["z"].dtype != trainer.ship_np:
                raise CheckpointError(
                    f"{ck_dir}: the snapshot's state is "
                    f"{got[0]['z'].dtype}, this drain ships "
                    f"{np.dtype(trainer.ship_np)}; refusing to resume")
            record(scope="ftrl", what="load",
                   tag=int(got[1]["batches_done"]),
                   load_ms=(time.perf_counter() - t0) * 1e3)
            return got

        def gen():
            # -- crash-restart resume (common/checkpoint.py): the newest
            # valid snapshot carries the committed (z, n) state, the count
            # of micro-batches folded into it and the padded-COO width
            # they reached; the replayed input's committed prefix is
            # skipped below, before encode
            restored = restore()
            resume_skip = 0 if restored is None \
                else int(restored[1]["batches_done"])
            # cleared once the state commits to the generic layout; the
            # encode thread reads it, so an fb micro-batch already encoded
            # ahead of the flip is encoded again below
            allow_fb = [batch_mode and (restored is None
                                        or restored[1]["layout"] == "fb")]
            # the COO width of the committed micro-batches: a sparse
            # micro-batch is padded to max(this, its own width), whoever
            # encoded it, so a resumed drain pads as the uninterrupted one
            width0 = 8 if restored is None \
                else int(restored[1]["coo_width"])

            def encoded():
                """Host leg, run ahead by one thread: the batch size
                latches on the first non-empty micro-batch (later ones pad
                to it), even when a resume skips it; the committed prefix
                is skipped before encode; the COO width only grows."""
                batch_size = None
                width = width0
                seen = 0
                for t, mt in data_op.timed_batches():
                    if mt.num_rows == 0:
                        continue
                    if batch_size is None:
                        batch_size = max(1, mt.num_rows)
                    seen += 1
                    if seen <= resume_skip:
                        continue           # committed before the crash
                    bs = max(batch_size, mt.num_rows)
                    enc = trainer.encode(mt, bs, width, allow_fb[0])
                    width = max(width, enc.width)
                    yield t, mt, bs, trainer.to_device(enc)

            progressive = self._progressive = []
            pending: List[Tuple[int, int, torch.Tensor]] = []
            pace = self._batch_hook

            def flush():
                # one host fetch per snapshot boundary for every queued
                # per-batch loss: the state fetch has synced the card
                for b, rows, ll in pending:
                    progressive.append((b, float(ll) / rows))
                pending.clear()

            z = n = None
            layout = fb_S = fb_meta = None
            next_emit = None
            b_done = resume_skip
            width_done = width0
            if restored is not None:
                payload, meta = restored
                layout = meta["layout"]
                # next_emit is NOT restored: it re-derives from the first
                # replayed batch's event time, so a restart never
                # re-emits for the committed prefix
                if layout == "fb":
                    fb_S = int(meta["fb_S"])
                    fb_meta = FieldBlockMeta(int(meta["fb_num_fields"]),
                                             int(meta["fb_field_size"]))
                z = torch.from_numpy(np.array(payload["z"])).to(
                    trainer.device)
                n = torch.from_numpy(np.array(payload["n"])).to(
                    trainer.device)

            def save_state():
                # ONE fetch of (z, n) a boundary: everything before the
                # snapshot is committed, everything after replays on
                # restart
                meta = {"signature": ck_signature, "layout": layout,
                        "batches_done": b_done,
                        "next_emit": None if next_emit is None
                        else float(next_emit), "coo_width": width_done}
                if layout == "fb":
                    meta["fb_S"] = int(fb_S)
                    meta["fb_num_fields"] = int(fb_meta.num_fields)
                    meta["fb_field_size"] = int(fb_meta.field_size)
                t0 = time.perf_counter()
                zn = torch.stack([z, n]).cpu().numpy()
                t1 = time.perf_counter()
                path = save_checkpoint(ck_dir, b_done,
                                       {"z": zn[0], "n": zn[1]}, meta=meta,
                                       scope="ftrl", keep_last=ck_keep)
                record(scope="ftrl", what="save", tag=b_done,
                       fetch_ms=(t1 - t0) * 1e3,
                       write_ms=(time.perf_counter() - t1) * 1e3,
                       bytes=payload_bytes(path))

            def device_emit(t_ev, batch) -> bool:
                hook = self._device_snapshot_hook
                if hook is None:
                    return False
                return bool(hook(trainer.weights(z, n),
                                 {"fb_S": fb_S, "dim": trainer.dim,
                                  "has_intercept": trainer.has_intercept,
                                  "batch": batch, "event_time": t_ev}))

            for t, mt, bs, enc in prefetch(encoded()):
                if pace is not None:
                    pace("pre", b_done + 1, t)
                if next_emit is None:
                    next_emit = (np.floor(t / interval) + 1) * interval
                if (layout == "fb" and (enc.kind != "fb"
                                        or enc.meta != fb_meta)) or (
                        layout == "std" and enc.kind == "fb"):
                    # the first micro-batch's layout was coincidental (or
                    # the rows changed shape): demote the state to the
                    # generic layout, exactly, and stay there
                    if layout == "fb":
                        z, n = trainer.to_std_state(z, n, fb_S)
                    layout, fb_S, fb_meta = "std", None, None
                    allow_fb[0] = False
                    enc = trainer.to_device(trainer.encode(mt, bs,
                                                           width_done))
                elif enc.kind == "sparse" and enc.width < width_done:
                    # encoded ahead with a width a re-encoded micro-batch
                    # has since outgrown
                    enc = trainer.to_device(trainer.encode(mt, bs,
                                                           width_done))
                if layout is None:
                    if enc.kind == "fb":
                        layout, fb_S, fb_meta = ("fb", enc.meta.field_size,
                                                 enc.meta)
                    else:
                        layout = "std"
                        allow_fb[0] = False
                    z, n = trainer.initial_state(enc)
                rows = mt.num_rows
                y = enc.arrays[-1]
                z, n, mg = trainer.step(enc, z, n)
                width_done = max(width_done, enc.width)
                pending.append((b_done + 1, rows,
                                progressive_logloss_sum(mg[:rows], y[:rows])))
                if t + 1e-12 >= next_emit:
                    if not device_emit(t, b_done + 1):
                        # fault site: kill/error fail the emission before
                        # the snapshot fetch; corrupt mangles the EMITTED
                        # table without touching the state
                        poison = maybe_crash("feeder.snapshot")
                        snap = trainer.snapshot(z, n, fb_S)
                        if poison:
                            snap = _corrupt_snapshot_table(snap)
                        flush()
                        yield (t, snap)
                    else:
                        flush()
                    while next_emit <= t + 1e-12:
                        next_emit += interval
                b_done += 1
                if pace is not None:
                    pace("post", b_done, t)
                # the injected-preemption point sits BEFORE the periodic
                # save: a crash at batch k genuinely loses the work since
                # the last snapshot
                maybe_crash("ftrl.batch", b_done)
                if ck_dir and ck_every and b_done % ck_every == 0:
                    save_state()
            if ck_dir and ck_every and z is not None \
                    and b_done > resume_skip and b_done % ck_every != 0:
                # end-of-stream snapshot so a restart of a COMPLETED drain
                # resumes instead of retraining the tail
                save_state()
            if z is None:
                # empty stream: emit the warm-start model
                z, n = trainer.initial_state()
            t_end = next_emit if next_emit is not None else interval
            if not device_emit(t_end, b_done if b_done > 0 else None):
                poison = maybe_crash("feeder.snapshot")
                snap = trainer.snapshot(z, n, fb_S)
                if poison:
                    snap = _corrupt_snapshot_table(snap)
                flush()
                yield (t_end, snap)
            else:
                flush()

        self._stream_fn = gen
        return self


class FtrlPredictStreamOp(StreamOperator, HasPredictionCol, HasPredictionDetailCol,
                          HasReservedCols, HasVectorCol):
    """Score a data stream with a hot-reloading model stream.

    reference: FtrlPredictStreamOp.java:62-110 — ``CollectModel`` assembles
    complete models from the model stream and swaps the LinearModelMapper
    live. Here the model stream and data stream merge in event-time order
    (ties to the model stream); each model snapshot replaces the mapper,
    rebuilt lazily at the next data batch, for all later data. Until the
    first snapshot the warm-start model scores. Scoring is the host
    mapper's (``LinearModelMapper.map_table``), as in the JAX package.
    """

    def __init__(self, initial_model: Optional[BatchOperator] = None,
                 params: Optional[Params] = None, **kwargs):
        super().__init__(params, **kwargs)
        self._initial_model = initial_model

    def link_from(self, model_op: StreamOperator,
                  data_op: StreamOperator) -> "FtrlPredictStreamOp":
        self._schema = None  # resolved once the first mapper loads

        def make_mapper(model_table: MTable, data_schema: TableSchema):
            mapper = LinearModelMapper(model_table.schema, data_schema, self.params)
            mapper.load_model(model_table)
            return mapper

        def gen():
            mapper = None
            latest_model = None
            for t, which, mt in merge_timed(model_op.timed_batches(),
                                            data_op.timed_batches()):
                if which == 0:     # model stream: hot swap
                    latest_model = mt
                    mapper = None  # rebuild lazily against the data schema
                    continue
                if mapper is None:
                    model = latest_model
                    if model is None:
                        if self._initial_model is None:
                            continue  # no model yet: drop (reference buffers)
                        model = self._initial_model.get_output_table()
                    mapper = make_mapper(model, mt.schema)
                    self._schema = mapper.get_output_schema()
                yield (t, mapper.map_table(mt))

        self._stream_fn = gen
        return self
