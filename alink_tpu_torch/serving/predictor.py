"""CompiledPredictor — shape-bucketed device serving with hot model swap.

Counterpart: ``alink_tpu/serving/predictor.py``. A mapper's
:class:`ServingKernel` splits model application into ``encode`` (host:
rows -> padded tensors), ``device_fns`` (device scoring) and ``decode``
(host: scores -> output table, the mapper's own label/detail logic).
Request batches pad with zero rows to the smallest covering bucket from
``ALINK_TPU_SERVE_BUCKETS``; larger tables are served in top-bucket
chunks. Padding rows are numerical no-ops: scoring is row-independent,
so a real row scores bitwise the same in every bucket.

The JAX package compiles one program per (signature, kind, bucket) and
caches it. PyTorch runs eagerly and the kernels take any row count, so
the port has no program cache; buckets still fix the shapes the kernels
see. Left out for later slices: ``serving/plan.py``, the AOT cache, the
compile ledger, sharding and replicas, metrics and tracing.

Hot model swap is double-buffered: :meth:`CompiledPredictor.swap_model`
builds the new version — mapper load, kernel extraction, the copy of
the weights to the device — on the caller's thread, then flips the
active-slot reference in one store. A dispatch in flight keeps the
version it started with, so no request sees a torn model.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common.device import resolve_device
from ..common.mtable import MTable

DEFAULT_BUCKETS = (1, 8, 32, 128, 512)


def serve_buckets(default: Sequence[int] = DEFAULT_BUCKETS) -> Tuple[int, ...]:
    """``ALINK_TPU_SERVE_BUCKETS``: the shape-bucket set, sorted unique
    positive ints (comma-separated)."""
    from ..common.flags import flag_value
    raw = flag_value("ALINK_TPU_SERVE_BUCKETS", "")
    if not raw:
        return tuple(default)
    return _parse_buckets(raw) or tuple(default)


def serve_window_s() -> float:
    """``ALINK_TPU_SERVE_WINDOW_MS`` (batching latency budget) in
    seconds."""
    from ..common.flags import flag_value
    return float(flag_value("ALINK_TPU_SERVE_WINDOW_MS", 2.0)) / 1e3


def serve_min_fill() -> int:
    """``ALINK_TPU_SERVE_MIN_FILL``: the micro-batcher's fill target —
    batches below it are held up to the window for stragglers."""
    from ..common.flags import flag_value
    return int(flag_value("ALINK_TPU_SERVE_MIN_FILL", 1))


def serve_queue_depth() -> int:
    """``ALINK_TPU_SERVE_QUEUE``: admission-control bound of the request
    channel (requests beyond it block the submitter — backpressure)."""
    from ..common.flags import flag_value
    return int(flag_value("ALINK_TPU_SERVE_QUEUE", 1024))


def _parse_buckets(raw: str) -> Tuple[int, ...]:
    out = []
    for part in str(raw).split(","):
        part = part.strip()
        if not part:
            continue
        out.append(int(part))
    return tuple(sorted({b for b in out if b > 0}))


@dataclass
class ServingKernel:
    """One model's serving contract (built by the mapper).

    ``signature``     — hashable model identity: geometry, ship dtype
                        and serving dtype, everything but the weight
                        values.
    ``model_arrays``  — the weights, a tuple of CPU tensors; the
                        predictor copies them to its device once per
                        model version.
    ``encode(mt, bucket)`` -> ``(kind, tensors)`` — host encode of a
                        request table into CPU tensors padded with zero
                        rows to ``bucket``; ``kind`` names the encoding
                        (dense or sparse).
    ``device_fns[kind](model_arrays, *tensors)`` — device scoring; the
                        output's leading axis is rows.
    ``decode(outputs, mt)`` — host decode of the real-row slice of the
                        outputs (numpy) into the mapper's output table.
    """
    signature: Tuple
    model_arrays: Tuple[torch.Tensor, ...]
    encode: Callable[[MTable, int], Tuple[str, Tuple[torch.Tensor, ...]]]
    device_fns: Dict[str, Callable]
    decode: Callable[[Tuple[np.ndarray, ...], MTable], MTable]


def _merge_parts(parts):
    """Concatenate chunk outputs column-wise in ONE pass."""
    first = parts[0]
    cols = {}
    for nm in first.col_names:
        arrs = []
        for p in parts:
            c = p.col(nm)
            if getattr(c, "__mtable_column__", False):
                c = c.materialize()
            arrs.append(c)
        if any(a.dtype == object for a in arrs):
            out = np.empty(sum(a.shape[0] for a in arrs), object)
            off = 0
            for a in arrs:
                out[off:off + a.shape[0]] = a
                off += a.shape[0]
        else:
            out = np.concatenate(arrs)
        cols[nm] = out
    return MTable(cols, first.schema)


class _ModelVersion:
    """One immutable model slot: kernel, mapper and the weights on the
    device, copied there once, on the thread that builds the slot."""

    __slots__ = ("version", "kernel", "mapper", "arrays")

    def __init__(self, version: int, kernel: ServingKernel, mapper,
                 device: torch.device):
        self.version = version
        self.kernel = kernel
        self.mapper = mapper
        self.arrays = tuple(a.to(device) for a in kernel.model_arrays)


class CompiledPredictor:
    """Shape-bucketed model application on one device, with hot swap.

    ``CompiledPredictor(mapper)`` takes a LOADED ModelMapper that
    implements ``serving_kernel()``. ``device`` defaults to ``cuda``
    (``RuntimeError`` without CUDA; pass ``device="cpu"`` for the CPU,
    where the kernels' plain versions score). ``ship_dtype`` is the
    dtype of the weights and request values: float32 on the card,
    float64 in the parity tests against the JAX package.
    """

    def __init__(self, mapper, buckets: Optional[Sequence[int]] = None,
                 device=None, ship_dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.ship_dtype = ship_dtype
        kernel = mapper.serving_kernel(ship_dtype)
        if kernel is None:
            raise TypeError(
                f"{type(mapper).__name__} does not provide a serving "
                f"kernel; serve it with its map_table")
        self._buckets = tuple(sorted({int(b) for b in buckets if int(b) > 0})) \
            if buckets else serve_buckets()
        if not self._buckets:
            raise ValueError("empty bucket set")
        self._swap_lock = threading.Lock()
        self._versions = 1
        self._active = _ModelVersion(1, kernel, mapper, self.device)

    # -- model hot swap -------------------------------------------------
    def swap_model(self, model_table: MTable) -> int:
        """Load ``model_table`` into the standby slot and flip it active.

        Runs on the caller's thread: mapper construction, ``load_model``,
        kernel extraction and the weight copy all happen BEFORE the
        flip, which is one reference store. Returns the new version
        number. Serialized across swappers; never blocks a dispatch."""
        with self._swap_lock:
            base = self._active.mapper
            mapper = type(base)(model_table.schema, base.data_schema,
                                base.params)
            mapper.load_model(model_table)
            standby = _ModelVersion(self._versions + 1,
                                    mapper.serving_kernel(self.ship_dtype),
                                    mapper, self.device)
            self._versions += 1
            self._active = standby     # the flip
        return standby.version

    @property
    def model_version(self) -> int:
        return self._active.version

    @property
    def buckets(self) -> Tuple[int, ...]:
        return self._buckets

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (requests larger than the top bucket are
        served in top-bucket chunks)."""
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    # -- prediction -----------------------------------------------------
    def _chunks(self, n: int):
        top = self._buckets[-1]
        return [(s, min(s + top, n)) for s in range(0, n, top)]

    def _score_chunk(self, ver: _ModelVersion, data: MTable) -> np.ndarray:
        """Encode, score on the device, fetch: the real rows' scores."""
        n = data.num_rows
        kind, tensors = ver.kernel.encode(data, self.bucket_for(n))
        placed = tuple(t.to(self.device) for t in tensors)
        out = ver.kernel.device_fns[kind](ver.arrays, *placed)
        return out.cpu().numpy()[:n]

    def predict_table(self, data: MTable) -> MTable:
        """Serve a whole request table through the bucketed kernels.

        Output is bitwise-identical for the real rows no matter which
        bucket (or chunk split) served them."""
        n = data.num_rows
        if n == 0:
            return self._active.mapper.map_table(data)
        parts = []
        for s, e in self._chunks(n):
            ver = self._active           # one consistent model per chunk
            chunk = data if (s, e) == (0, n) \
                else data.take_rows(np.arange(s, e))
            scores = self._score_chunk(ver, chunk)
            parts.append(ver.kernel.decode((scores,), chunk))
        return parts[0] if len(parts) == 1 else _merge_parts(parts)

    def predict_scores(self, data: MTable) -> np.ndarray:
        """The raw device scores of ``data``'s rows (what
        :meth:`predict_table` decodes) — for parity checks."""
        n = data.num_rows
        ver = self._active
        return np.concatenate(
            [self._score_chunk(ver, data.take_rows(np.arange(s, e)))
             for s, e in self._chunks(n)]) if n else np.zeros(0)

    def predict_row(self, row: Tuple) -> Tuple:
        """Single-row serving: the 1-row table trip through the
        bucket-1 kernel launch."""
        one = MTable([row], self._active.mapper.data_schema)
        return self.predict_table(one).row(0)

    def host_reference(self, data: MTable) -> MTable:
        """The active model applied through the HOST mapper path
        (``map_table``) — the parity baseline of the device tier."""
        return self._active.mapper.map_table(data)

    @property
    def output_schema(self):
        return self._active.mapper.get_output_schema()

    @property
    def data_schema(self):
        return self._active.mapper.data_schema
