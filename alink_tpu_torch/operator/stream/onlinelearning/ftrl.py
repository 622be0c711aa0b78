"""FTRL online learning — the sparse trainer and the hot-reloading predictor.

Counterpart: ``alink_tpu/operator/stream/onlinelearning/ftrl.py``
(re-design of the reference's stream/onlinelearning/FtrlTrainStreamOp.java
and FtrlPredictStreamOp.java).

Ported: the FTRL-proximal closed form (:func:`ftrl_weights`, the JAX
package's ``_ftrl_weights``), the three sparse steps the JAX package
builds in ``_ftrl_sparse_step_factory`` (``update_mode="sample"``, the
default), ``_ftrl_sparse_staleness_step_factory`` and
``_ftrl_sparse_chained_step_factory``, :class:`FtrlTrainStreamOp` on
sparse input and :class:`FtrlPredictStreamOp`.

On one device the JAX package's feature sharding degenerates: every
slot is local (``lo = 0``), the margin ``psum`` is the identity and the
``where(local, ., 0)`` masks select everything, so the steps below drop
them. A step is a Python loop over chunks of K rows on the
device-resident ``(z, n)`` state, its gathers, scatter-adds and (in the
strict steps) the walk of each chunk's samples going through the CUDA
kernels of ``kernels/ftrl.py`` (on the CPU, their plain versions): four
launches a chunk. The staleness step's other ops are eager PyTorch.

Left out, raising ``NotImplementedError``: ``update_mode="batch"``, dense
input (``feature_cols``, or a vector column of dense vectors), which
needs the dense strict step, ``checkpoint_dir``, ``health``,
``set_batch_hook`` and ``set_device_snapshot_consumer``. Not ported: the
feature-sharded state, the field-blocked batch path, the compile plane,
metrics and tracing.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ....common.device import resolve_device
from ....common.mtable import MTable
from ....common.params import InValidator, ParamInfo, Params, RangeValidator
from ....common.types import TableSchema
from ....kernels.ftrl import (ftrl_weights, gather_pair, gather_rows,
                              scatter_add_rows, sigmoid, walk_chunk)
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


def progressive_logloss_sum(margins, y):
    """Sum of the log losses of ``margins`` (computed at pre-update
    weights, so this is progressive validation) against 0/1 labels ``y``,
    as a device scalar; margins clipped to [-35, 35] as the steps clip."""
    m = torch.clamp(margins, -35.0, 35.0)
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    return (torch.logaddexp(zero, -m) * y
            + torch.logaddexp(zero, m) * (1.0 - y)).sum()


class FtrlSparseTrainer:
    """The parts of one sparse FTRL drain, one micro-batch at a time:
    :meth:`encode` (host), :meth:`to_device`, :meth:`step` on the
    device-resident state, and :meth:`snapshot` (device to host, model
    table). :class:`FtrlTrainStreamOp` drives them; they are public so a
    caller can time each stage."""

    def __init__(self, init: LinearModelData, *, alpha: float, beta: float,
                 l1: float, l2: float, update_mode: str, staleness: int,
                 chunk_size: int, vector_col: str, label_col: str,
                 device: torch.device, ship_dtype: torch.dtype):
        if ship_dtype not in _SHIP_NP:
            raise ValueError(f"ship_dtype {ship_dtype}: want float32 or "
                             f"float64")
        self.init = init
        self.alpha, self.beta, self.l1, self.l2 = alpha, beta, l1, l2
        self.update_mode = update_mode
        self.staleness, self.chunk_size = staleness, chunk_size
        self.vector_col, self.label_col = vector_col, label_col
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

    def encode(self, mt: MTable, batch_size: int, width: int = 8):
        """``(idx, val, y, width)``: the micro-batch as a padded (batch_size,
        width) COO block, the intercept an explicit ``(0, 1.0)`` entry of
        every real row and feature indices shifted by one, the width grown
        in steps of 8 from the given one and never shrunk."""
        design = extract_design(mt, None, self.vector_col, self.ship_np,
                                vector_size=self.init.vector_size or None)
        if design["kind"] == "dense":
            raise NotImplementedError(
                "FtrlTrainStreamOp: dense input (the dense strict step) is "
                "not ported yet; feed sparse vectors")
        b = mt.num_rows
        idx0, val0 = design["idx"], design["val"]
        hi = int(idx0.max()) if idx0.size else -1
        if hi + (1 if self.has_intercept else 0) >= self.dim:
            raise IndexError(
                f"sparse feature index {hi} out of range for the "
                f"warm-start model (dim {self.dim}); the dense path fails "
                f"loudly on the same input")
        if self.has_intercept:
            idx0 = np.concatenate(
                [np.zeros((b, 1), idx0.dtype), idx0 + 1], axis=1)
            val0 = np.concatenate(
                [np.ones((b, 1), val0.dtype), val0], axis=1)
        w0 = idx0.shape[1]
        width = max(width, -(-w0 // 8) * 8)
        idx = np.zeros((batch_size, width), np.int32)
        val = np.zeros((batch_size, width), self.ship_np)
        idx[:b, :w0] = idx0
        val[:b, :w0] = val0
        return idx, val, self.labels(mt, b, batch_size), width

    # -- device side -------------------------------------------------------
    def to_device(self, idx: np.ndarray, val: np.ndarray, y: np.ndarray):
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (idx, val, y))

    def initial_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The warm start: ``z = -coef * (beta/alpha + l2)`` and ``n = 0``,
        whose weights are the initial model's coefficients."""
        z0 = -np.asarray(self.init.coef, np.float64) \
            * (self.beta / self.alpha + self.l2)
        z = torch.from_numpy(z0).to(self.device, self.ship_dtype)
        return z, torch.zeros_like(z)

    def step(self, idx, val, y, z, n):
        """One micro-batch in this trainer's update mode: ``(z, n,
        margins)``; the state passed in is dead afterwards."""
        hyper = (self.alpha, self.beta, self.l1, self.l2)
        if self.update_mode == "staleness":
            return ftrl_staleness_step(idx, val, y, z, n, *hyper,
                                       self.staleness)
        if self.update_mode == "chained":
            return ftrl_chained_step(idx, val, y, z, n, *hyper,
                                     self.chunk_size)
        return ftrl_sample_step(idx, val, y, z, n, *hyper)

    def weights(self, z, n) -> torch.Tensor:
        return ftrl_weights(z, n, self.alpha, self.beta, self.l1, self.l2)

    def snapshot(self, z, n) -> MTable:
        """The model table of the live state (one device-to-host fetch)."""
        w = self.weights(z, n).cpu().numpy()[:self.dim]
        init = self.init
        m = LinearModelData(
            model_name="FTRL", linear_model_type=LinearModelType.LR,
            has_intercept=init.has_intercept, vector_col=init.vector_col,
            feature_names=init.feature_names, vector_size=init.vector_size,
            coef=w, label_values=list(init.label_values),
            label_type=init.label_type)
        return LinearModelDataConverter(init.label_type).save_model(m)


class FtrlTrainStreamOp(StreamOperator, HasVectorCol, HasFeatureCols, HasLabelCol):
    """Online FTRL trainer on sparse input; output is the model-snapshot
    stream.

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
    # bound made explicit); "batch" is not ported yet
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
    # durability and health monitoring are not ported yet: a
    # checkpoint_dir or a health monitor raises NotImplementedError at
    # link; the params that only tune a checkpoint are not declared
    CHECKPOINT_DIR = ParamInfo("checkpoint_dir", str, default=None)
    HEALTH = ParamInfo("health", object, default=None)

    def __init__(self, initial_model: Optional[BatchOperator] = None,
                 params: Optional[Params] = None, device=None,
                 ship_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(params, **kwargs)
        self._initial_model = initial_model
        self.device = resolve_device(device)
        self.ship_dtype = ship_dtype
        self.trainer: Optional[FtrlSparseTrainer] = None
        self._progressive: List[Tuple[int, float]] = []

    def set_batch_hook(self, hook) -> "FtrlTrainStreamOp":
        raise NotImplementedError(
            "FtrlTrainStreamOp.set_batch_hook (the online DAG's pacing) is "
            "not ported yet")

    def set_device_snapshot_consumer(self, hook) -> "FtrlTrainStreamOp":
        raise NotImplementedError(
            "FtrlTrainStreamOp.set_device_snapshot_consumer is not ported "
            "yet")

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
        update_mode = m.get("update_mode", "sample")
        if update_mode == "batch":
            raise NotImplementedError(
                "FtrlTrainStreamOp: update_mode='batch' is not ported yet")
        for key in ("checkpoint_dir", "health"):
            if m.get(key) is not None:
                raise NotImplementedError(
                    f"FtrlTrainStreamOp: {key} is not ported yet")
        init = self._load_initial()
        self._schema = LinearModelDataConverter(init.label_type).schema
        vector_col = m.get("vector_col") or init.vector_col
        if m.get("feature_cols") or not vector_col:
            raise NotImplementedError(
                "FtrlTrainStreamOp: dense input (feature_cols) is not "
                "ported yet; set vector_col to a column of sparse vectors")
        trainer = self.trainer = FtrlSparseTrainer(
            init, alpha=float(self.get_alpha()), beta=float(self.get_beta()),
            l1=float(self.get_l1()), l2=float(self.get_l2()),
            update_mode=update_mode, staleness=int(m.get("staleness", 32)),
            chunk_size=int(m.get("chunk_size", 16)), vector_col=vector_col,
            label_col=self.get_label_col(), device=self.device,
            ship_dtype=self.ship_dtype)
        interval = float(self.get_time_interval())

        def encoded():
            """Host leg, run ahead by one thread: the batch size latches
            on the first non-empty micro-batch (later ones pad to it) and
            the COO width only grows."""
            batch_size = None
            width = 8
            for t, mt in data_op.timed_batches():
                if mt.num_rows == 0:
                    continue
                if batch_size is None:
                    batch_size = max(1, mt.num_rows)
                idx, val, y, width = trainer.encode(
                    mt, max(batch_size, mt.num_rows), width)
                yield t, mt.num_rows, (idx, val, y)

        def gen():
            progressive = self._progressive = []
            pending: List[Tuple[int, int, torch.Tensor]] = []

            def flush():
                # one host fetch per snapshot boundary for every queued
                # per-batch loss: the state fetch has synced the card
                for b, rows, ll in pending:
                    progressive.append((b, float(ll) / rows))
                pending.clear()

            z = n = None
            next_emit = None
            b_done = 0
            for t, rows, enc in prefetch(encoded()):
                if next_emit is None:
                    next_emit = (np.floor(t / interval) + 1) * interval
                if z is None:
                    z, n = trainer.initial_state()
                idx, val, y = trainer.to_device(*enc)
                z, n, mg = trainer.step(idx, val, y, z, n)
                pending.append((b_done + 1, rows,
                                progressive_logloss_sum(mg[:rows], y[:rows])))
                if t + 1e-12 >= next_emit:
                    snap = trainer.snapshot(z, n)
                    flush()
                    yield (t, snap)
                    while next_emit <= t + 1e-12:
                        next_emit += interval
                b_done += 1
            if z is None:
                # empty stream: emit the warm-start model
                z, n = trainer.initial_state()
            snap = trainer.snapshot(z, n)
            flush()
            yield (next_emit if next_emit is not None else interval, snap)

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
