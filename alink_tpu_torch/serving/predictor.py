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
see. The predictor resolves ONE :class:`~alink_tpu_torch.serving.plan.
ServingPlan` at construction and counts each dispatch under
``plan.program_key(kind, bucket, trailing shapes)``: a key's first
dispatch is a miss and every later one a hit, so :meth:`cache_stats`
(and the server's ``bucket_hit_rate``) equal the JAX package's program
cache counts on the same request sequence.

Hot model swap is double-buffered: :meth:`CompiledPredictor.swap_model`
builds the new version — mapper load, kernel extraction, the copy of
the weights to the device — on the caller's thread (a feeder's), then
flips the active-slot reference in one store. A dispatch in flight
keeps the version it started with, so no request sees a torn model.

**Why a dispatch never reads a half-copied weight.** The standby's
copies are enqueued on the swapping thread's current stream, then a
CUDA event is recorded behind them (``_ModelVersion.ready``), and only
then is the reference stored. A dispatch reads the reference first and
makes its own stream wait on that event before it launches a kernel
on the weights; with both threads on the default stream (the port
starts no other) the wait is also implied by stream order. So the
kernel runs after the copy has completed, whichever thread enqueued
it. ``ALINK_TPU_SERVE_SWAP=sync`` additionally blocks the swapping
thread on the event before the flip; that changes no answer (every
dispatch waits on the event either way), only when ``swap_model``
returns. The serving loop never blocks on a swap.

Fault sites (``common/faults.py``): ``serve.dispatch`` before each
dispatch's encode (error = a catchable transient failure, what trips
the server's breaker; delay:MS = injected latency; kill = the loop
supervisor's respawn path), ``serve.swap`` at each swap, before the
standby is built. The ``alink_serve_*`` series and the ``serve.batch``
/ ``serve.swap`` spans are the JAX package's. Request timelines get
their ``dispatch`` (encode, copy in, launch), ``device`` (the fetch
that waits on the card) and ``decode`` marks here.

Left out: the AOT cache, the compile ledger, ``serving_event_plan``
and ``warm_from_disk`` (the compile plane, ROADMAP A10(b); a server's
``stats()["warmed_programs"]`` stays 0); sharding and
``ensure_replicas`` (ROADMAP A9).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import reqtrace
from ..common.device import resolve_device
from ..common.faults import maybe_crash
from ..common.metrics import get_registry, metrics_enabled
from ..common.mtable import MTable
from ..common.tracing import trace_complete, trace_span
from .plan import ServingPlan

DEFAULT_BUCKETS = (1, 8, 32, 128, 512)


class GeometryRefused(ValueError):
    """A serving kernel's ``encode`` refusing a request's geometry (more
    features than the model, a feature index out of its range): the
    request cannot go through this kernel, and a caller may serve it
    through the host mapper instead. No other error of the serving path
    is one: a wrapper's or a kernel's error is a fault of the path."""


def record_serve_fallback(mapper_name: str, reason: str,
                          detail: str = "") -> None:
    """Record one serving-tier fallback: ``alink_serve_fallback_total
    {mapper=, reason=}`` always, plus ONE RuntimeWarning per
    (mapper, reason) pair per process.

    ``reason`` must be a SMALL ENUM of stable strings — it is a metric
    label, and data-dependent text (exception messages carry request
    widths etc.) would mint a new time series per distinct value.
    Request-specific context goes in ``detail``, which reaches only the
    warning text."""
    from ..common.metrics import record_fallback_once
    record_fallback_once(
        "serve", "alink_serve_fallback_total",
        {"mapper": mapper_name, "reason": reason},
        f"serving falls back to the host mapper path for {mapper_name}: "
        f"{reason}{' (' + detail + ')' if detail else ''} (recorded as "
        f"alink_serve_fallback_total{{mapper={mapper_name!r},"
        f"reason={reason!r}}}; this warning fires once per "
        f"mapper+reason)")


def _reset_fallback_warnings() -> None:
    """Test hook: re-arm the once-per-(mapper, reason) warnings."""
    from ..common.metrics import reset_fallback_warnings
    reset_fallback_warnings("serve")


def serve_compiled_enabled() -> bool:
    """``ALINK_TPU_SERVE_COMPILED``: route the stream predict twins
    (ModelMapStreamOp) through the serving path. Default off — the
    flag-off path runs the host mapper."""
    from ..common.flags import flag_value
    return flag_value("ALINK_TPU_SERVE_COMPILED", False)


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


def serve_swap_mode() -> str:
    """``ALINK_TPU_SERVE_SWAP``: ``double`` (default — standby slot
    prepared off the serving loop, one-store flip) or ``sync`` (the flip
    additionally waits until the standby weights are on the device; the
    serving loop still never blocks)."""
    from ..common.flags import flag_value
    return str(flag_value("ALINK_TPU_SERVE_SWAP", "double"))


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
    ``model_arrays``  — the weights, a tuple of tensors (CPU tensors
                        from the mapper; device tensors after
                        ``swap_weights``); the predictor copies them to
                        its device once per model version.
    ``encode(mt, bucket)`` -> ``(kind, tensors)`` — host encode of a
                        request table into CPU tensors padded with zero
                        rows to ``bucket``; ``kind`` names the encoding
                        (dense or sparse). A request the kernel cannot
                        take raises :class:`GeometryRefused`.
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
    device, copied there once, on the thread that builds the slot.
    ``ready`` is a CUDA event recorded behind the copies (``None`` on
    the CPU, where a copy is done when it returns); a dispatch waits on
    it before it launches a kernel on the weights."""

    __slots__ = ("version", "kernel", "mapper", "arrays", "ready")

    def __init__(self, version: int, kernel: ServingKernel, mapper,
                 device: torch.device):
        self.version = version
        self.kernel = kernel
        self.mapper = mapper
        self.arrays = tuple(a.to(device) for a in kernel.model_arrays)
        self.ready = None
        if device.type == "cuda":
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(device))


class CompiledPredictor:
    """Shape-bucketed model application on one device, with hot swap.

    ``CompiledPredictor(mapper)`` takes a LOADED ModelMapper that
    implements ``serving_kernel()``; :meth:`for_mapper` returns ``None``
    instead of raising for mappers without a kernel (the stream-twin
    routing falls back to the host path, recorded). ``device`` defaults
    to ``cuda`` (``RuntimeError`` without CUDA; pass ``device="cpu"``
    for the CPU, where the kernels' plain versions score).
    ``ship_dtype`` is the dtype of the weights and request values:
    float32 on the card, float64 in the parity tests against the JAX
    package.
    """

    def __init__(self, mapper, buckets: Optional[Sequence[int]] = None,
                 device=None, ship_dtype: torch.dtype = torch.float32,
                 name: str = "serve"):
        self.device = resolve_device(device)
        self.ship_dtype = ship_dtype
        self.name = name
        kernel = mapper.serving_kernel(ship_dtype)
        if kernel is None:
            raise TypeError(
                f"{type(mapper).__name__} does not provide a serving "
                f"kernel; use CompiledPredictor.for_mapper() to fall "
                f"back to the host mapper path")
        self._buckets = tuple(sorted({int(b) for b in buckets if int(b) > 0})) \
            if buckets else serve_buckets()
        if not self._buckets:
            raise ValueError("empty bucket set")
        # ONE resolved plan: every accounting key and the swap signature
        # derive from it
        self.plan = ServingPlan(signature=kernel.signature,
                                buckets=self._buckets)
        self._swap_lock = threading.Lock()
        self._cache_lock = threading.Lock()
        self._keys: set = set()
        self._hits = 0
        self._hits_reported = 0
        self._misses = 0
        self._versions = 1
        self._active = _ModelVersion(1, kernel, mapper, self.device)

    @classmethod
    def for_mapper(cls, mapper, buckets: Optional[Sequence[int]] = None,
                   name: str = "serve", **kw) -> Optional["CompiledPredictor"]:
        """A predictor, or ``None`` when the mapper has no kernel — and
        the fallback is RECORDED (``alink_serve_fallback_total`` + one
        RuntimeWarning per mapper+reason), never silent. The device is
        resolved first: no CUDA without ``device="cpu"`` raises."""
        resolve_device(kw.get("device"))
        try:
            kernel = mapper.serving_kernel(
                kw.get("ship_dtype", torch.float32))
            reason, detail = "no-serving-kernel", ""
        except RuntimeError as e:
            kernel = None
            reason, detail = "kernel-error", str(e)
        if kernel is None:
            record_serve_fallback(type(mapper).__name__, reason, detail)
            return None
        return cls(mapper, buckets=buckets, name=name, **kw)

    # -- model hot swap -------------------------------------------------
    def _flip(self, standby: _ModelVersion) -> None:
        """Publish ``standby``: in sync mode wait until its weights are
        on the device first; the flip itself is one reference store
        (callers hold ``_swap_lock``)."""
        if serve_swap_mode() == "sync" and standby.ready is not None:
            standby.ready.synchronize()
        self._active = standby

    def _record_swap(self, standby: _ModelVersion, dt: float,
                     mode: Optional[str] = None) -> None:
        # stamp the flip onto every request in flight: a tail exemplar
        # overlapping this swap names it
        args = {"predictor": self.name, "version": standby.version}
        if mode is not None:
            args["mode"] = mode
        reqtrace.annotate_inflight("swap", args)
        if metrics_enabled():
            reg = get_registry()
            reg.inc("alink_serve_model_swaps_total", 1,
                    {"predictor": self.name})
            reg.observe("alink_serve_swap_seconds", dt,
                        {"predictor": self.name})

    def swap_model(self, model_table: MTable) -> int:
        """Load ``model_table`` into the standby slot and flip it active.

        Runs on the caller's thread: mapper construction, ``load_model``,
        kernel extraction and the weight copy all happen BEFORE the
        flip, which is one reference store. Returns the new version
        number. Serialized across swappers; never blocks a dispatch."""
        with self._swap_lock:
            t0 = time.perf_counter()
            # fault site: an error-mode fault fails the swap BEFORE the
            # standby build — the active version never flips, so the
            # last good model keeps serving
            maybe_crash("serve.swap")
            with trace_span("serve.swap", cat="serve"):
                base = self._active.mapper
                mapper = type(base)(model_table.schema, base.data_schema,
                                    base.params)
                mapper.load_model(model_table)
                standby = _ModelVersion(self._versions + 1,
                                        mapper.serving_kernel(
                                            self.ship_dtype),
                                        mapper, self.device)
                self._versions += 1
                self._flip(standby)
            dt = time.perf_counter() - t0
        self._record_swap(standby, dt)
        return standby.version

    def swap_weights(self, model_arrays: Sequence[torch.Tensor]) -> int:
        """Same-geometry weight swap: install ``model_arrays`` (host or
        device tensors with the ACTIVE kernel's shapes and dtypes) as a
        new model version WITHOUT reloading a model table. Device
        tensors on the predictor's device are taken as they are (device
        ops only, no host copy). The mapper's decode state (labels,
        detail schema) is geometry, not weights, so it carries over. A
        different geometry raises ``ValueError``: it goes through
        :meth:`swap_model`. The flip is :meth:`swap_model`'s."""
        with self._swap_lock:
            t0 = time.perf_counter()
            maybe_crash("serve.swap")   # same site as swap_model: both
                                        # are the feeder's swap boundary
            with trace_span("serve.swap", cat="serve",
                            args={"mode": "weights"}):
                base = self._active
                arrays = tuple(model_arrays)
                if len(arrays) != len(base.kernel.model_arrays):
                    raise ValueError(
                        f"swap_weights got {len(arrays)} arrays; the "
                        f"active kernel has "
                        f"{len(base.kernel.model_arrays)}")
                for a, old in zip(arrays, base.kernel.model_arrays):
                    if tuple(a.shape) != tuple(old.shape) \
                            or a.dtype != old.dtype:
                        raise ValueError(
                            f"swap_weights geometry mismatch: "
                            f"{tuple(a.shape)}/{a.dtype} vs "
                            f"{tuple(old.shape)}/{old.dtype} — a "
                            f"different geometry must go through "
                            f"swap_model")
                kernel = replace(base.kernel, model_arrays=arrays)
                standby = _ModelVersion(self._versions + 1, kernel,
                                        base.mapper, self.device)
                self._versions += 1
                self._flip(standby)
            dt = time.perf_counter() - t0
        self._record_swap(standby, dt, mode="weights")
        return standby.version

    @property
    def model_version(self) -> int:
        return self._active.version

    @property
    def model_arrays(self) -> Tuple[torch.Tensor, ...]:
        """The active version's weights on the predictor's device, in
        the serving kernel's layout (what :meth:`swap_weights` takes)."""
        return self._active.arrays

    @property
    def swap_signature(self) -> str:
        """The serving geometry of the active version as a JSON-stable
        string (``ServingPlan.swap_signature``): a same-geometry swap
        keeps it, a swap to another geometry changes it."""
        return self.plan.with_signature(
            self._active.kernel.signature).swap_signature()

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

    # -- bucket accounting (the JAX package's program-cache counts) -----
    def _count(self, ver: _ModelVersion, kind: str, bucket: int,
               tensors: Tuple[torch.Tensor, ...]) -> None:
        """Count one dispatch under its plan key: a miss the first time
        the key is seen, a hit after. The hit path is lock-free (a set
        probe and an int bump on the serving loop)."""
        key = self.plan.program_key(
            kind, bucket, tuple(tuple(t.shape[1:]) for t in tensors),
            signature=ver.kernel.signature, sharded=False)
        if key in self._keys:
            self._hits += 1
            return
        with self._cache_lock:
            if key in self._keys:
                self._hits += 1
                return
            self._keys.add(key)
            self._misses += 1
        if metrics_enabled():
            get_registry().inc("alink_serve_program_cache_total", 1,
                               {"result": "miss", "predictor": self.name})

    def cache_stats(self) -> Dict[str, int]:
        self.flush_metrics()
        with self._cache_lock:
            return {"hits": self._hits, "misses": self._misses,
                    "programs": len(self._keys)}

    def flush_metrics(self) -> None:
        """Push the (lock-free) hit counter delta into the registry —
        per-hit registry updates would tax every dispatched batch, so
        hits batch up and flush at stats/accounting boundaries."""
        if not metrics_enabled():
            return
        with self._cache_lock:
            delta = self._hits - self._hits_reported
            self._hits_reported = self._hits
        if delta > 0:
            get_registry().inc("alink_serve_program_cache_total", delta,
                               {"result": "hit", "predictor": self.name})

    # -- prediction -----------------------------------------------------
    def _chunks(self, n: int):
        top = self._buckets[-1]
        return [(s, min(s + top, n)) for s in range(0, n, top)]

    def _score_chunk(self, ver: _ModelVersion, data: MTable
                     ) -> Tuple[np.ndarray, int]:
        """Encode, score on the device, fetch: the real rows' scores and
        the bucket that served them."""
        n = data.num_rows
        bucket = self.bucket_for(n)
        kind, tensors = ver.kernel.encode(data, bucket)
        placed = tuple(t.to(self.device) for t in tensors)
        self._count(ver, kind, bucket, tensors)
        if ver.ready is not None:
            # the weights' copy completes before the kernel reads them
            torch.cuda.current_stream(self.device).wait_event(ver.ready)
        out = ver.kernel.device_fns[kind](ver.arrays, *placed)
        # request-timeline phase boundaries: dispatch work (encode,
        # copy in, launch) ends here; the device wait is the fetch
        reqtrace.batch_mark("dispatch")
        host = out.cpu().numpy()[:n]
        reqtrace.batch_mark("device")
        return host, bucket

    def predict_table(self, data: MTable) -> MTable:
        """Serve a whole request table through the bucketed kernels.

        Output is bitwise-identical for the real rows no matter which
        bucket (or chunk split) served them."""
        n = data.num_rows
        if n == 0:
            return self._active.mapper.map_table(data)
        chunks = self._chunks(n)
        if len(chunks) == 1:
            return self._predict_chunk(data)
        return _merge_parts([self._predict_chunk(
            data.take_rows(np.arange(s, e))) for s, e in chunks])

    def _predict_chunk(self, data: MTable) -> MTable:
        t0 = time.perf_counter()
        # deterministic fault site BEFORE encode: a shed or failed
        # dispatch must not have paid any device work
        maybe_crash("serve.dispatch")
        ver = self._active           # one consistent model per chunk
        scores, bucket = self._score_chunk(ver, data)
        result = ver.kernel.decode((scores,), data)
        reqtrace.batch_mark("decode")
        n = data.num_rows
        trace_complete("serve.batch", time.perf_counter() - t0, cat="serve",
                       args={"rows": n, "bucket": bucket,
                             "model_version": ver.version})
        if metrics_enabled():
            reg = get_registry()
            lbl = {"predictor": self.name}
            reg.inc("alink_serve_batches_total", 1, lbl)
            reg.observe("alink_serve_batch_occupancy", n / bucket, lbl)
        return result

    def predict_scores(self, data: MTable) -> np.ndarray:
        """The raw device scores of ``data``'s rows (what
        :meth:`predict_table` decodes) — for parity checks."""
        n = data.num_rows
        ver = self._active
        return np.concatenate(
            [self._score_chunk(ver, data.take_rows(np.arange(s, e)))[0]
             for s, e in self._chunks(n)]) if n else np.zeros(0)

    def predict_row(self, row: Tuple) -> Tuple:
        """Single-row serving: the 1-row table trip through the
        bucket-1 kernel launch (the serial-dispatch baseline the
        micro-batcher is measured against)."""
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
