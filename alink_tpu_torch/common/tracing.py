"""Structured tracing — hierarchical spans, instant events, flight recorder.

Counterpart: ``alink_tpu/common/tracing.py``, copied. The aggregate
metrics (``common/metrics.py``) answer "how much, in total" but not
"when, and inside what" — that needs a trace: a tree of timed spans plus
point events. This module is the **host-side** timeline of the port's
own control flow (the card's own timeline is ``torch.profiler``'s):

  * ``Tracer.span(name)`` — a context manager that records one *complete*
    span (start + duration). Nesting is automatic: the current span is
    carried in a ``contextvars.ContextVar``, so a span opened inside
    another becomes its child — across ``with`` blocks, call stacks and
    (because each thread starts a fresh context) cleanly per thread.
  * ``Tracer.instant(name)`` — a zero-duration marker (a swap, a breaker
    transition, a shed request), parented to the current span.
  * **flight recorder** — events land in a bounded ring buffer
    (``collections.deque(maxlen=...)``); when full, the *oldest* events
    fall out and a drop counter advances. Always-on tracing is therefore
    memory-safe in production: the buffer holds the most recent history,
    like an aircraft flight recorder.

Two exporters:

  * ``export_chrome(path)`` — Chrome Trace Event Format JSON, loadable in
    Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``;
  * ``export_jsonl(path)`` — one JSON object per line (meta record first),
    the JAX package's run-log shape (``format: alink_tpu_trace_v1``).

Switches (``common.flags.env_flag`` parsing: unset -> default,
``0/false/off/no`` -> off):

  * ``ALINK_TPU_TRACE``        — default OFF. Master switch for every
    instrumented producer (``trace_span``/``trace_instant`` below are
    no-ops without it). All events are host-side: tracing changes no
    tensor and launches nothing on the card.
  * ``ALINK_TPU_TRACE_BUFFER`` — flight-recorder capacity in events
    (default 65536; ~200 bytes/event, so the default bounds memory at a
    few tens of MB).

Producers in the port: the serving tier (``serve.batch``, ``serve.swap``,
``serve.request``, ``serve.breaker``, ``serve.shed``, ``serve.respawn``,
``serve.model_stream``) and the post-mortem writer. They go through the
module-level :func:`trace_span` / :func:`trace_instant` helpers, which
gate on the env switch and the process-wide tracer (:func:`get_tracer` /
:func:`set_tracer`, mirroring the metrics registry).
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

from .metrics import env_flag

__all__ = [
    "Tracer", "Span", "get_tracer", "set_tracer", "tracing_enabled",
    "trace_span", "trace_instant", "trace_complete", "events_to_chrome",
    "TRACE_ENV", "TRACE_BUFFER_ENV", "DEFAULT_BUFFER_EVENTS",
]

TRACE_ENV = "ALINK_TPU_TRACE"
TRACE_BUFFER_ENV = "ALINK_TPU_TRACE_BUFFER"
DEFAULT_BUFFER_EVENTS = 65536

TRACE_FORMAT = "alink_tpu_trace_v1"


def tracing_enabled() -> bool:
    """``ALINK_TPU_TRACE`` switch (default off). Read live, so tests and
    long-lived processes can toggle it per run."""
    return env_flag(TRACE_ENV, default=False)


def _buffer_capacity() -> int:
    # registry-declared (common/flags.py): tolerant int parse, clamped
    # to >= 1, default DEFAULT_BUFFER_EVENTS
    from .flags import flag_value
    return flag_value(TRACE_BUFFER_ENV, DEFAULT_BUFFER_EVENTS)


# The current span rides in a ContextVar, NOT a thread-local: nesting must
# survive ``with``-block composition inside one task while new threads
# (stream prefetch, load-generator clients) start with a fresh context —
# each thread becomes its own root lane in the exported timeline.
_current_span: "contextvars.ContextVar[Optional[Span]]" = \
    contextvars.ContextVar("alink_tpu_trace_span", default=None)


class Span:
    """One open span. Use as a context manager (``Tracer.span`` returns
    it unentered); mutate ``args`` mid-flight via :meth:`set` — e.g. a
    cache status only known at the end of the region."""

    __slots__ = ("name", "cat", "args", "id", "parent", "tid",
                 "_tracer", "_start_ns", "_token")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args: Dict[str, Any] = dict(args) if args else {}
        self.id = 0
        self.parent: Optional[int] = None
        self.tid = 0
        self._start_ns = 0
        self._token = None

    def set(self, **kw) -> "Span":
        """Attach/overwrite args on the open span (chainable)."""
        self.args.update(kw)
        return self

    def __enter__(self) -> "Span":
        cur = _current_span.get()
        self.parent = cur.id if cur is not None else None
        self.id = self._tracer._next_id()
        self.tid = threading.get_ident()
        self._token = _current_span.set(self)
        self._start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end_ns = time.perf_counter_ns()
        if self._token is not None:
            _current_span.reset(self._token)
            self._token = None
        self._tracer._record(
            ph="X", name=self.name, cat=self.cat,
            ts_ns=self._start_ns, dur_ns=end_ns - self._start_ns,
            tid=self.tid, id=self.id, parent=self.parent,
            args=self.args or None)
        return False


class _NullSpan:
    """Shared no-op stand-in returned by :func:`trace_span` when tracing
    is off — zero allocation on the fast path. ``set`` discards."""

    __slots__ = ()

    def set(self, **kw) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe span tracer with a bounded in-memory ring buffer.

    >>> tr = Tracer()
    >>> with tr.span("exec"):
    ...     with tr.span("prepare"):
    ...         pass
    ...     tr.instant("cache", args={"result": "hit"})
    >>> tr.export_chrome("/tmp/trace.json")   # open in Perfetto

    Events are plain dicts ``{ph, name, cat, ts, dur, tid, id, parent,
    args}`` with ``ts``/``dur`` in microseconds relative to the tracer's
    start. ``ph`` follows the Chrome Trace Event phases this module
    emits: ``X`` (complete span) and ``i`` (instant). The buffer holds
    the newest ``capacity`` events; older ones are dropped and counted
    (``dropped``), never grown past the bound.
    """

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = int(capacity) if capacity is not None \
            else _buffer_capacity()
        if self.capacity < 1:
            raise ValueError(f"tracer capacity must be >= 1, "
                             f"got {self.capacity}")
        self._events: "deque[Dict[str, Any]]" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._dropped = 0
        self._id = 0
        self._origin_ns = time.perf_counter_ns()
        self._origin_unix = time.time()
        self._thread_names: Dict[int, str] = {}

    # -- recording --------------------------------------------------------
    def _next_id(self) -> int:
        with self._lock:
            self._id += 1
            return self._id

    def _record(self, *, ph: str, name: str, cat: str, ts_ns: int,
                dur_ns: Optional[int], tid: int, id: Optional[int],
                parent: Optional[int], args: Optional[Dict[str, Any]]):
        ev: Dict[str, Any] = {
            "ph": ph, "name": name, "cat": cat,
            "ts": (ts_ns - self._origin_ns) / 1e3,  # microseconds
            "tid": tid,
        }
        if dur_ns is not None:
            ev["dur"] = dur_ns / 1e3
        if id is not None:
            ev["id"] = id
        if parent is not None:
            ev["parent"] = parent
        if args:
            ev["args"] = args
        with self._lock:
            if tid not in self._thread_names:
                t = threading.current_thread()
                self._thread_names[tid] = t.name
            if len(self._events) == self.capacity:
                self._dropped += 1      # deque(maxlen) evicts the oldest
            self._events.append(ev)

    def span(self, name: str, cat: str = "host",
             args: Optional[Dict[str, Any]] = None) -> Span:
        """A new (unentered) span; enter it with ``with``."""
        return Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "host",
                args: Optional[Dict[str, Any]] = None) -> None:
        """Record a point event, parented to the current span."""
        cur = _current_span.get()
        self._record(ph="i", name=name, cat=cat,
                     ts_ns=time.perf_counter_ns(), dur_ns=None,
                     tid=threading.get_ident(), id=self._next_id(),
                     parent=cur.id if cur is not None else None, args=args)

    def complete(self, name: str, dur_s: float, cat: str = "host",
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Record a span retroactively: it ends *now* and lasted
        ``dur_s``. For regions timed with an existing ``perf_counter``
        pair where entering a context manager is awkward (e.g. generator
        bodies that must not hold a context across a ``yield`` — the
        caller's context would inherit the open span)."""
        cur = _current_span.get()
        end_ns = time.perf_counter_ns()
        dur_ns = max(0, int(dur_s * 1e9))
        self._record(ph="X", name=name, cat=cat, ts_ns=end_ns - dur_ns,
                     dur_ns=dur_ns, tid=threading.get_ident(),
                     id=self._next_id(),
                     parent=cur.id if cur is not None else None, args=args)

    # -- reading / management ---------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of buffered events in timestamp order."""
        with self._lock:
            evs = list(self._events)
        return sorted(evs, key=lambda e: e["ts"])

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    # -- exporters --------------------------------------------------------
    def _meta(self) -> Dict[str, Any]:
        with self._lock:
            return {"kind": "meta", "format": TRACE_FORMAT,
                    "origin_unix": self._origin_unix,
                    "exported_unix": time.time(),
                    "capacity": self.capacity, "dropped": self._dropped,
                    "threads": {str(k): v
                                for k, v in self._thread_names.items()}}

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome Trace Event Format object (``{"traceEvents": [...]}``).

        Span ids/parents ride in each event's ``args`` (``span_id`` /
        ``parent_id``) so the tree survives the format round-trip —
        Perfetto itself nests by interval containment per tid.
        """
        return events_to_chrome(self._meta(), self.events())

    def export_chrome(self, path: str) -> str:
        """Write the Chrome-trace JSON; open in Perfetto or
        ``chrome://tracing``. Returns ``path``."""
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome(), f)
        os.replace(tmp, path)
        return path

    def export_jsonl(self, path: str) -> str:
        """Write the JSONL run log (meta line first, then one event per
        line, timestamp-ordered). Returns ``path``."""
        lines = [json.dumps(self._meta())]
        lines += [json.dumps(ev) for ev in self.events()]
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            f.write("\n".join(lines))
            f.write("\n")
        os.replace(tmp, path)
        return path


def events_to_chrome(meta: Dict[str, Any],
                     events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Chrome Trace Event Format document from normalized tracer events.

    The ONE emitter of the Chrome mapping (``Tracer.to_chrome``
    delegates here), as in the JAX package. ``meta`` is a ``Tracer._meta()``-shaped dict (only
    ``threads`` and the passthrough keys are read)."""
    out: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
         "args": {"name": "alink_tpu"}}]
    for tid, tname in sorted((meta.get("threads") or {}).items()):
        out.append({"ph": "M", "name": "thread_name", "pid": 1,
                    "tid": int(tid), "args": {"name": tname}})
    for ev in events:
        ce: Dict[str, Any] = {"ph": ev["ph"], "name": ev["name"],
                              "cat": ev.get("cat", "?"), "pid": 1,
                              "tid": ev["tid"], "ts": ev["ts"]}
        if ev["ph"] == "X":
            ce["dur"] = ev.get("dur", 0.0)
        else:
            ce["s"] = "t"               # instant scoped to its thread
        args = dict(ev.get("args") or {})
        if "id" in ev:
            args["span_id"] = ev["id"]
        if "parent" in ev:
            args["parent_id"] = ev["parent"]
        if args:
            ce["args"] = args
        out.append(ce)
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {k: v for k, v in meta.items()
                          if k not in ("kind", "threads")}}


# -- the process-wide tracer ------------------------------------------------

# created lazily so ALINK_TPU_TRACE_BUFFER set after import (but before
# first use) still sizes it; capacity latches at first get_tracer()
_default_tracer: Optional[Tracer] = None
_default_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The flight recorder every runtime producer reports into."""
    global _default_tracer
    if _default_tracer is None:
        with _default_lock:
            if _default_tracer is None:
                _default_tracer = Tracer()
    return _default_tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-wide tracer (per-run isolation, tests); returns
    the previous one (created on the spot if none existed yet)."""
    global _default_tracer
    with _default_lock:
        prev = _default_tracer if _default_tracer is not None else Tracer()
        _default_tracer = tracer
    return prev


# -- instrumentation helpers (the call-site API) ----------------------------

def trace_span(name: str, cat: str = "host",
               args: Optional[Dict[str, Any]] = None):
    """A span on the process tracer, or a shared no-op when
    ``ALINK_TPU_TRACE`` is off. The disabled fast path costs one env
    lookup and allocates nothing."""
    if not tracing_enabled():
        return _NULL_SPAN
    return get_tracer().span(name, cat=cat, args=args)


def trace_instant(name: str, cat: str = "host",
                  args: Optional[Dict[str, Any]] = None) -> None:
    """An instant event on the process tracer; no-op when tracing is off."""
    if tracing_enabled():
        get_tracer().instant(name, cat=cat, args=args)


def trace_complete(name: str, dur_s: float, cat: str = "host",
                   args: Optional[Dict[str, Any]] = None) -> None:
    """A retroactive span (ends now, lasted ``dur_s``) on the process
    tracer; no-op when tracing is off. See :meth:`Tracer.complete`."""
    if tracing_enabled():
        get_tracer().complete(name, dur_s, cat=cat, args=args)
