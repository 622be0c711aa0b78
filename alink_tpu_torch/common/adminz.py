"""Live operations plane — in-process admin HTTP endpoint.

Counterpart: ``alink_tpu/common/adminz.py``, copied. JSONL dumps and
trace exports are read after a process exits; a long-lived
:class:`~alink_tpu_torch.serving.server.PredictServer` is *operated*,
and needs a live plane. This module is it:

* :class:`AdminServer` — a **stdlib-only** ``ThreadingHTTPServer``
  serving, from the LIVE process state (nothing is copied or dumped):

  ========== ==========================================================
  path        serves
  ========== ==========================================================
  /metrics    Prometheus exposition text straight from the live
              ``MetricsRegistry`` (``render_text()``)
  /varz       the same registry as JSON records (``snapshot()`` shape,
              meta record first)
  /healthz    liveness: 200 while every registered
              :class:`ReadinessSource` reports healthy, else 503
  /readyz     readiness: 200 while every source reports ready, else 503
  /statusz    build info, every resolved flag of ``common/flags.py``,
              and the registered status sections (a server's
              ``stats()``)
  /tracez     a bounded snapshot of the flight-recorder ring
              (``?trace_id=`` narrows to one request's events)
  /requestz   recent request timelines (admission → queue → coalesce →
              dispatch → device → decode) plus everything in flight;
              ``?trace_id=`` / ``?tenant=`` filter
  ========== ==========================================================

  The JAX package's ``/compilez`` (its compile ledger) is left out: the
  port compiles no programs (ROADMAP A10(b)).

* the :class:`ReadinessSource` contract — components plug their REAL
  state in: a readiness callable returns a dict with at least
  ``{"ready": bool}`` (optional ``"healthy"`` defaults to ``ready``;
  everything else is detail rendered verbatim). A callable that raises
  reports as unready with the error attached — a crashed probe must
  degrade the verdict, never 500 the endpoint.

* a refcounted process-wide instance (:func:`acquire_admin` /
  :func:`release_admin`): ``ALINK_TPU_ADMIN_PORT`` armed, the first
  component to start (a ``PredictServer``) brings the endpoint up and
  the last one down — the endpoint's lifetime IS the components'
  lifetime. Off unless ``ALINK_TPU_ADMIN_PORT`` is set.

The server only *reads* host-side state; nothing on the card depends
on it.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from .flags import FLAGS, flag_value
from .metrics import get_registry, metrics_enabled

__all__ = [
    "AdminServer", "acquire_admin", "release_admin", "get_admin",
    "admin_enabled", "admin_port", "admin_host", "admin_tracez_events",
    "admin_requestz_entries",
]


def admin_port() -> int:
    """``ALINK_TPU_ADMIN_PORT``: 0 = plane off, -1 = ephemeral port,
    otherwise the fixed port to bind."""
    return int(flag_value("ALINK_TPU_ADMIN_PORT"))


def admin_host() -> str:
    """``ALINK_TPU_ADMIN_HOST``: bind address (loopback default)."""
    return str(flag_value("ALINK_TPU_ADMIN_HOST"))


def admin_tracez_events() -> int:
    """``ALINK_TPU_ADMIN_TRACEZ``: max events per /tracez response."""
    return int(flag_value("ALINK_TPU_ADMIN_TRACEZ"))


def admin_requestz_entries() -> int:
    """``ALINK_TPU_ADMIN_REQUESTZ``: max request timelines per
    /requestz response."""
    return int(flag_value("ALINK_TPU_ADMIN_REQUESTZ"))


def admin_enabled() -> bool:
    """Whether the admin plane is armed (port flag != 0)."""
    return admin_port() != 0


def _json_safe(v: Any) -> Any:
    """Best-effort JSON coercion for status payloads — a status section
    returning a non-serializable value must degrade to its repr, never
    500 the endpoint."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_json_safe(x) for x in v]
    return repr(v)


class _Handler(BaseHTTPRequestHandler):
    server_version = "alink-adminz/1"

    # the admin plane must never spam stderr per scrape
    def log_message(self, *a) -> None:  # pragma: no cover - silencer
        pass

    def do_GET(self) -> None:
        admin: "AdminServer" = self.server.admin  # type: ignore[attr-defined]
        t0 = time.perf_counter()
        parsed = urlparse(self.path)
        path = parsed.path.rstrip("/") or "/"
        try:
            if path == "/":
                code, ctype, body = 200, "text/plain; charset=utf-8", \
                    admin._index()
            elif path == "/metrics":
                code, ctype, body = 200, \
                    "text/plain; version=0.0.4; charset=utf-8", \
                    get_registry().render_text()
            elif path == "/varz":
                code, ctype, body = 200, "application/json", \
                    json.dumps(admin._varz())
            elif path == "/healthz":
                ok, doc = admin.health()
                code, ctype, body = (200 if ok else 503), \
                    "application/json", json.dumps(doc)
            elif path == "/readyz":
                ok, doc = admin.readiness()
                code, ctype, body = (200 if ok else 503), \
                    "application/json", json.dumps(doc)
            elif path == "/statusz":
                code, ctype, body = 200, "application/json", \
                    json.dumps(_json_safe(admin.statusz()))
            elif path == "/tracez":
                q = parse_qs(parsed.query)
                try:
                    n = int(q["n"][0]) if "n" in q else None
                except (TypeError, ValueError):
                    n = None
                trace_id = q["trace_id"][0] if "trace_id" in q else None
                code, ctype, body = 200, "application/json", \
                    json.dumps(_json_safe(admin._tracez(n, trace_id)))
            elif path == "/requestz":
                q = parse_qs(parsed.query)
                try:
                    n = int(q["n"][0]) if "n" in q else None
                except (TypeError, ValueError):
                    n = None
                trace_id = q["trace_id"][0] if "trace_id" in q else None
                tenant = q["tenant"][0] if "tenant" in q else None
                code, ctype, body = 200, "application/json", \
                    json.dumps(_json_safe(
                        admin._requestz(n, trace_id, tenant)))
            else:
                code, ctype, body = 404, "text/plain; charset=utf-8", \
                    f"404: unknown admin path {path!r}\n" + admin._index()
        except Exception as e:  # a handler bug must answer, not hang
            code, ctype = 500, "text/plain; charset=utf-8"
            body = f"500: {type(e).__name__}: {e}"
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):  # scraper gone
            return
        if metrics_enabled():
            # path label is the bounded route set, never the raw path
            route = path if path in ("/", "/metrics", "/varz", "/healthz",
                                     "/readyz", "/statusz", "/tracez",
                                     "/requestz") \
                else "other"
            reg = get_registry()
            reg.inc("alink_admin_requests_total", 1,
                    {"path": route, "code": code})
            reg.observe("alink_admin_scrape_seconds",
                        time.perf_counter() - t0, {"path": route})


class AdminServer:
    """The live-operations HTTP endpoint (see module docstring).

    Construct directly for tests/tools (``port<=0`` binds an ephemeral
    OS-assigned port; the resolved one is :attr:`port`), or let
    components share the flag-armed process instance via
    :func:`acquire_admin`/:func:`release_admin`.
    """

    ENDPOINTS = ("/metrics", "/varz", "/healthz", "/readyz", "/statusz",
                 "/tracez", "/requestz")

    def __init__(self, port: Optional[int] = None,
                 host: Optional[str] = None, name: str = "alink"):
        self.requested_port = admin_port() if port is None else int(port)
        self.host = admin_host() if host is None else str(host)
        self.name = name
        self.port: Optional[int] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._sources: Dict[str, Callable[[], dict]] = {}
        self._status: Dict[str, Callable[[], Any]] = {}
        self._started_unix = time.time()

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "AdminServer":
        bind = self.requested_port if self.requested_port > 0 else 0
        httpd = ThreadingHTTPServer((self.host, bind), _Handler)
        httpd.daemon_threads = True
        httpd.admin = self  # type: ignore[attr-defined]
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._started_unix = time.time()
        self._thread = threading.Thread(
            target=httpd.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True, name=f"alink-adminz-{self.name}")
        self._thread.start()
        if metrics_enabled():
            get_registry().set_gauge("alink_admin_port", self.port)
        return self

    def close(self) -> None:
        with self._lock:
            httpd, self._httpd = self._httpd, None
            thread, self._thread = self._thread, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)

    @property
    def url(self) -> str:
        host = "127.0.0.1" if self.host in ("", "0.0.0.0") else self.host
        return f"http://{host}:{self.port}"

    def __enter__(self) -> "AdminServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- source / status registration ------------------------------------
    def add_source(self, name: str, fn: Callable[[], dict]) -> None:
        """Register a readiness source: ``fn()`` returns a dict with at
        least ``{"ready": bool}`` (``"healthy"`` defaults to ready).
        Re-registering a name replaces it (restart-friendly)."""
        with self._lock:
            self._sources[str(name)] = fn

    def remove_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(str(name), None)

    def add_status(self, name: str, fn: Callable[[], Any]) -> None:
        """Register a ``/statusz`` section: ``fn()`` returns any
        JSON-coercible document rendered under ``sections[name]``."""
        with self._lock:
            self._status[str(name)] = fn

    def remove_status(self, name: str) -> None:
        with self._lock:
            self._status.pop(str(name), None)

    # -- verdicts ---------------------------------------------------------
    def _probe_sources(self) -> Dict[str, dict]:
        with self._lock:
            sources = dict(self._sources)
        out: Dict[str, dict] = {}
        for name, fn in sorted(sources.items()):
            try:
                doc = dict(fn())
            except Exception as e:
                doc = {"ready": False, "healthy": False,
                       "error": f"{type(e).__name__}: {e}"}
            doc.setdefault("ready", False)
            doc.setdefault("healthy", bool(doc["ready"]))
            out[name] = doc
        return out

    def health(self) -> Tuple[bool, dict]:
        """Liveness: every source healthy (an open breaker reports
        unhealthy). No sources = a bare process serving its registry:
        healthy."""
        probes = self._probe_sources()
        ok = all(bool(d.get("healthy")) for d in probes.values())
        return ok, {"healthy": ok,
                    "sources": _json_safe(probes)}

    def readiness(self) -> Tuple[bool, dict]:
        """Readiness: every source ready."""
        probes = self._probe_sources()
        ok = all(bool(d.get("ready")) for d in probes.values())
        return ok, {"ready": ok, "sources": _json_safe(probes)}

    # -- documents --------------------------------------------------------
    def _index(self) -> str:
        lines = [f"alink_tpu admin plane ({self.name}) — endpoints:"]
        lines += [f"  {p}" for p in self.ENDPOINTS]
        return "\n".join(lines) + "\n"

    def _varz(self) -> list:
        """The registry as JSON records — the ``dump()`` JSONL shape
        (meta record first), so dump-file consumers work unmodified."""
        reg = get_registry()
        meta = {"kind": "meta", "format": "alink_tpu_metrics_v1",
                "created_unix": reg._created_unix,
                "dumped_unix": time.time(),
                "dropped_series": reg._dropped_series}
        return [meta] + reg.snapshot()

    def statusz(self) -> dict:
        """Build info + every resolved flag + registered sections."""
        torch_mod = sys.modules.get("torch")
        flags: Dict[str, Any] = {}
        for f in FLAGS:
            import os
            raw = os.environ.get(f.name)
            try:
                val = f.read()
            except (TypeError, ValueError):
                val = raw
            flags[f.name] = {"kind": f.kind, "value": val,
                             "default": f.default,
                             "set": raw is not None,
                             "section": f.section}
        with self._lock:
            sections = dict(self._status)
        docs: Dict[str, Any] = {}
        for name, fn in sorted(sections.items()):
            try:
                docs[name] = fn()
            except Exception as e:
                docs[name] = {"error": f"{type(e).__name__}: {e}"}
        import os
        return {
            "name": self.name,
            "build": {
                "python": sys.version.split()[0],
                "torch": getattr(torch_mod, "__version__", None),
                "argv0": sys.argv[0] if sys.argv else None,
            },
            "pid": os.getpid(),
            "uptime_s": round(time.time() - self._started_unix, 3),
            "url": self.url,
            "flags": flags,
            "sections": docs,
        }

    def _tracez(self, n: Optional[int] = None,
                trace_id: Optional[str] = None) -> dict:
        """A bounded flight-recorder snapshot: the ring's meta plus the
        LAST ``n`` events (default ``ALINK_TPU_ADMIN_TRACEZ``).
        ``?trace_id=`` keeps only events whose args carry that request
        id (still clamped — the filter narrows, never widens)."""
        from .tracing import get_tracer
        tr = get_tracer()
        cap = admin_tracez_events()
        n = cap if n is None else max(1, min(int(n), cap))
        events = tr.events()
        total = len(events)
        if trace_id is not None:
            events = [e for e in events
                      if (e.get("args") or {}).get("trace_id") == trace_id]
        doc = {"meta": tr._meta(), "returned": min(n, len(events)),
               "total_buffered": total, "events": events[-n:]}
        if trace_id is not None:
            doc["trace_id"] = trace_id
        return doc

    def _requestz(self, n: Optional[int] = None,
                  trace_id: Optional[str] = None,
                  tenant: Optional[str] = None) -> dict:
        """Recent request timelines from the request flight recorder
        (:mod:`~alink_tpu_torch.common.reqtrace`): completed requests newest
        first, plus everything currently in flight. ``?n=`` is clamped
        to ``ALINK_TPU_ADMIN_REQUESTZ``; ``?trace_id=`` / ``?tenant=``
        filter (an exact trace_id match also searches in-flight)."""
        from . import reqtrace
        cap = admin_requestz_entries()
        n = cap if n is None else max(1, min(int(n), cap))
        recent = reqtrace.recent(n=n, tenant=tenant, trace_id=trace_id)
        inflight = reqtrace.inflight_docs()
        if tenant is not None:
            inflight = [d for d in inflight if d.get("tenant") == tenant]
        if trace_id is not None:
            inflight = [d for d in inflight
                        if d.get("trace_id") == trace_id]
        return {"enabled": reqtrace.reqtrace_enabled(),
                "returned": len(recent), "inflight": inflight,
                "events": reqtrace.recent_events(n),
                "requests": recent}


# -- the refcounted process-wide instance ---------------------------------
# The first flag-armed component up brings the endpoint up; the last one
# down takes it down. Components NEVER own the port — two servers in one
# process share one endpoint and one /statusz.

_shared_lock = threading.Lock()
_shared: Optional[AdminServer] = None
_shared_refs = 0
_bind_warned = False


def acquire_admin(name: str = "alink") -> Optional[AdminServer]:
    """The shared admin endpoint, started on first acquisition when
    ``ALINK_TPU_ADMIN_PORT`` is armed; ``None`` when the plane is off
    (the default) or the bind failed (warned once; the component runs
    on, unobserved — an ops plane must never take the workload down)."""
    global _shared, _shared_refs, _bind_warned
    if not admin_enabled():
        return None
    with _shared_lock:
        if _shared is None:
            try:
                _shared = AdminServer(name=name).start()
            except OSError as e:
                if not _bind_warned:
                    _bind_warned = True
                    warnings.warn(
                        f"adminz: could not bind the admin endpoint "
                        f"({admin_host()}:{admin_port()}): {e} — the "
                        f"live operations plane is OFF for this process",
                        RuntimeWarning, stacklevel=3)
                if metrics_enabled():
                    get_registry().inc("alink_admin_bind_errors_total", 1)
                return None
        _shared_refs += 1
        return _shared


def release_admin() -> None:
    """Drop one acquisition; the endpoint closes when the last holder
    releases."""
    global _shared, _shared_refs
    with _shared_lock:
        if _shared is None:
            return
        _shared_refs -= 1
        if _shared_refs <= 0:
            srv, _shared, _shared_refs = _shared, None, 0
        else:
            return
    srv.close()


def get_admin() -> Optional[AdminServer]:
    """The live shared endpoint, if one is up (tests/smokes use this to
    discover the ephemeral port)."""
    return _shared
