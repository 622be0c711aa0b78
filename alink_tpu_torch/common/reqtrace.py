"""Request-scoped tracing — per-request timelines of the serving tier.

Counterpart: ``alink_tpu/common/reqtrace.py``, copied. Metrics and
flight-recorder spans are *component* scoped: they can say the p99
regressed, not which request sat behind which swap flip or breaker
probe. This module adds the per-request causality substrate:

  * :class:`RequestContext` — one id + a monotonic timeline, minted at
    ``PredictServer`` admission and threaded through the serving
    machinery. Call sites ``mark(phase)`` at each hand-off (``admit``
    → ``dequeue`` → ``coalesce`` → ``dispatch`` → ``device`` →
    ``decode``) and the finished document carries the per-phase
    durations (``queue_s``, ``dispatch_s``, ...).
  * **overlap annotations** — concurrent swap / breaker events call
    :func:`annotate_inflight` and every request in flight at that
    instant gets the event stamped onto its timeline (bounded per
    request), so a tail-latency exemplar is *explained*, not just
    measured. The same events land in a bounded process event ring
    (:func:`recent_events`) — the swap history the post-mortem bundle
    archives.
  * a bounded **finished-request ring** (``ALINK_TPU_REQTRACE_RING``)
    behind :func:`recent` / :func:`find` — what ``/requestz`` serves
    and post-mortem bundles freeze.
  * :func:`batch_scope` / :func:`batch_mark` — a contextvar channel so
    ``CompiledPredictor`` (which knows nothing about requests) can
    stamp its dispatch/device/decode boundaries onto every request
    riding the current batch.

Everything here is host-side bookkeeping (perf_counter reads + list
appends); no tensor or launch depends on it. The switch is
``ALINK_TPU_REQTRACE`` (default **on**; the steady cost is a few
timestamps per request, not per row). ``tenant`` is kept in the
signatures for the JAX package's multi-tenant fleet, which the port has
not yet (ROADMAP A9).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .flags import flag_value
from .tracing import trace_complete, tracing_enabled

__all__ = [
    "RequestContext", "admit", "finish", "annotate_inflight",
    "batch_scope", "batch_mark", "recent", "recent_events", "find",
    "inflight_docs", "p99_exemplar", "reqtrace_enabled",
    "ring_capacity", "reset",
]

#: per-request annotation bound: a swap storm overlapping one slow
#: request must not grow its timeline without limit — beyond this the
#: document records only the overflow count
MAX_ANNOTATIONS = 16
#: mark bound (phases are a fixed small vocabulary; this is a guard
#: against a looping call site, not a tunable)
MAX_MARKS = 32
#: process event ring (swap/evict/lane-rebuild/breaker history)
EVENT_RING = 128

#: mark name -> phase name in the finished document (the queue phase
#: ends at the *dequeue* mark; every other phase is named by the mark
#: that ends it)
_PHASE_OF_MARK = {"dequeue": "queue"}


def reqtrace_enabled() -> bool:
    """Live switch (``ALINK_TPU_REQTRACE``, default on)."""
    return bool(flag_value("ALINK_TPU_REQTRACE", True))


def ring_capacity() -> int:
    return int(flag_value("ALINK_TPU_REQTRACE_RING", 1024))


_id_counter = itertools.count(1)


class RequestContext:
    """One request's monotonic timeline: an id, ``mark()`` timestamps
    (offsets from admission, seconds) and bounded overlap annotations.
    Mutation is append-only from the request's own thread plus
    :func:`annotate_inflight` callers; the per-context lock keeps the
    two from tearing a list."""

    __slots__ = ("trace_id", "tenant", "created_unix", "_t0", "marks",
                 "annotations", "dropped_annotations", "outcome",
                 "_lock")

    def __init__(self, trace_id: str, tenant: Optional[str] = None):
        self.trace_id = trace_id
        self.tenant = tenant
        self.created_unix = time.time()
        self._t0 = time.perf_counter()
        self.marks: List[Tuple[str, float]] = [("admit", 0.0)]
        self.annotations: List[Dict[str, Any]] = []
        self.dropped_annotations = 0
        self.outcome: Optional[str] = None
        self._lock = threading.Lock()

    def mark(self, phase: str) -> None:
        """Timestamp a phase boundary (offset from admission)."""
        t = time.perf_counter() - self._t0
        with self._lock:
            if len(self.marks) < MAX_MARKS:
                self.marks.append((str(phase), t))

    def annotate(self, kind: str, args: Optional[Dict[str, Any]] = None
                 ) -> None:
        """Stamp a concurrent event (swap/evict/breaker/...) onto this
        request's timeline; bounded at :data:`MAX_ANNOTATIONS`."""
        t = time.perf_counter() - self._t0
        with self._lock:
            if len(self.annotations) >= MAX_ANNOTATIONS:
                self.dropped_annotations += 1
                return
            ev: Dict[str, Any] = {"kind": str(kind), "t_s": round(t, 6)}
            if args:
                ev["args"] = dict(args)
            self.annotations.append(ev)

    def elapsed_s(self) -> float:
        return time.perf_counter() - self._t0

    def phase_end(self, phase_or_mark: str) -> Optional[float]:
        """Offset (s) of a named mark — ``phase_end("dispatch")`` is
        the admission→dispatch wait the queue-wait histogram exports."""
        with self._lock:
            for name, t in self.marks:
                if name == phase_or_mark:
                    return t
        return None

    def phases(self) -> Dict[str, float]:
        """Per-phase durations from consecutive marks: ``queue_s`` =
        dequeue − admit, ``dispatch_s`` = dispatch − previous mark, ..."""
        with self._lock:
            marks = list(self.marks)
        out: Dict[str, float] = {}
        for (_, prev_t), (name, t) in zip(marks, marks[1:]):
            out[_PHASE_OF_MARK.get(name, name) + "_s"] = round(
                t - prev_t, 6)
        return out

    def to_doc(self, total_s: Optional[float] = None) -> Dict[str, Any]:
        with self._lock:
            doc: Dict[str, Any] = {
                "trace_id": self.trace_id,
                "created_unix": self.created_unix,
                "marks": [{"phase": n, "t_s": round(t, 6)}
                          for n, t in self.marks],
                "annotations": list(self.annotations),
            }
            if self.tenant is not None:
                doc["tenant"] = self.tenant
            if self.dropped_annotations:
                doc["dropped_annotations"] = self.dropped_annotations
            if self.outcome is not None:
                doc["outcome"] = self.outcome
        doc["phases"] = self.phases()
        if total_s is not None:
            doc["total_s"] = round(total_s, 6)
        return doc


# -- process-wide state ---------------------------------------------------

_lock = threading.Lock()
_inflight: Dict[str, RequestContext] = {}
_ring: deque = deque(maxlen=1024)
_events: deque = deque(maxlen=EVENT_RING)


def _ring_locked() -> deque:
    """The finished-request ring at its flagged capacity (re-created,
    keeping the newest tail, when the flag changed). Caller holds
    ``_lock``."""
    global _ring
    cap = max(1, ring_capacity())
    if _ring.maxlen != cap:
        _ring = deque(_ring, maxlen=cap)
    return _ring


def admit(tenant: Optional[str] = None) -> Optional[RequestContext]:
    """Mint a context at server admission (``None`` when the layer is
    off — every downstream call site tolerates a ``None`` ctx)."""
    if not reqtrace_enabled():
        return None
    ctx = RequestContext(f"r{next(_id_counter):08d}", tenant)
    with _lock:
        _inflight[ctx.trace_id] = ctx
    return ctx


def finish(ctx: Optional[RequestContext],
           outcome: str = "ok") -> Optional[Dict[str, Any]]:
    """Close a request's timeline: move it from the in-flight set to
    the finished ring and (tracing on) emit one ``serve.request``
    complete-event carrying the trace id, so the flight recorder's
    ``/tracez?trace_id=`` view can find it."""
    if ctx is None:
        return None
    total = ctx.elapsed_s()
    ctx.outcome = outcome
    doc = ctx.to_doc(total_s=total)
    with _lock:
        _inflight.pop(ctx.trace_id, None)
        _ring_locked().append(doc)
    if tracing_enabled():
        args: Dict[str, Any] = {"trace_id": ctx.trace_id,
                                "outcome": outcome}
        if ctx.tenant is not None:
            args["tenant"] = ctx.tenant
        trace_complete("serve.request", total, cat="serve", args=args)
    return doc


def annotate_inflight(kind: str,
                      args: Optional[Dict[str, Any]] = None) -> int:
    """Stamp a concurrent event onto every in-flight request AND the
    process event ring (the swap/evict/breaker history post-mortem
    bundles archive). Returns the number of requests annotated. Cheap
    when idle: one empty-dict probe."""
    if not _inflight and not reqtrace_enabled():
        return 0
    with _lock:
        ctxs = list(_inflight.values())
        ev: Dict[str, Any] = {"kind": str(kind), "t_unix": time.time()}
        if args:
            ev["args"] = dict(args)
        _events.append(ev)
    for c in ctxs:
        c.annotate(kind, args)
    return len(ctxs)


def recent_events(n: Optional[int] = None) -> List[Dict[str, Any]]:
    """Newest-last slice of the process event ring."""
    with _lock:
        evs = list(_events)
    return evs if n is None else evs[-int(n):]


def recent(n: Optional[int] = None, tenant: Optional[str] = None,
           trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Newest-first finished-request documents, optionally filtered."""
    with _lock:
        docs = list(_ring)
    docs.reverse()
    if tenant is not None:
        docs = [d for d in docs if d.get("tenant") == tenant]
    if trace_id is not None:
        docs = [d for d in docs if d.get("trace_id") == trace_id]
    return docs if n is None else docs[:int(n)]


def find(trace_id: str) -> Optional[Dict[str, Any]]:
    """One request document by id (finished ring first, then the live
    in-flight set)."""
    with _lock:
        for d in reversed(_ring):
            if d.get("trace_id") == trace_id:
                return d
        ctx = _inflight.get(trace_id)
    return ctx.to_doc() if ctx is not None else None


def inflight_docs() -> List[Dict[str, Any]]:
    """Snapshots of the requests in flight right now (post-mortem
    bundles include them — the requests the incident caught mid-air)."""
    with _lock:
        ctxs = list(_inflight.values())
    return [c.to_doc() for c in ctxs]


def reset() -> None:
    """Test hook: clear the in-flight set, ring, and event history."""
    with _lock:
        _inflight.clear()
        _ring.clear()
        _events.clear()


# -- the batch-phase channel ----------------------------------------------
# The predictor's _predict_chunk knows encode/dispatch/device/decode
# boundaries but not which requests ride the batch; the server knows
# the requests but not the chunk internals. A contextvar bridges them
# without threading a parameter through every dispatch layer.

_batch_var: contextvars.ContextVar[Tuple[RequestContext, ...]] = \
    contextvars.ContextVar("alink_reqtrace_batch", default=())


@contextlib.contextmanager
def batch_scope(ctxs: List[Optional[RequestContext]]) -> Iterator[None]:
    """Bind the requests riding the current dispatch so
    :func:`batch_mark` inside the predictor stamps all of them."""
    token = _batch_var.set(tuple(c for c in ctxs if c is not None))
    try:
        yield
    finally:
        _batch_var.reset(token)


def batch_mark(phase: str) -> None:
    """Mark a phase boundary on every request in the active batch
    scope (no-op outside one — direct ``predict_table`` callers)."""
    for c in _batch_var.get():
        c.mark(phase)


# -- exemplar resolution --------------------------------------------------

def p99_exemplar(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The exemplar of the bucket a histogram-snapshot record's p99
    falls in (the nearest lower bucket's when that bucket never caught
    one) — how a p99 number resolves to a concrete request timeline."""
    counts = rec.get("counts") or []
    total = sum(counts)
    if not total:
        return None
    exemplars = rec.get("exemplars") or []
    target = 0.99 * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target:
            for j in range(i, -1, -1):
                if j < len(exemplars) and exemplars[j]:
                    return exemplars[j]
            return None
    return None
