"""Automatic post-mortem bundles — the durable incident artifact.

When the serving tier breaches (SLO burn fires, a circuit breaker
opens, a DAG stage aborts, an injected kill lands), the evidence that
explains it lives in process-local rings that die with the process:
the flight-recorder trace, the request timelines, the live metrics.
:func:`maybe_bundle` freezes all of it into ONE versioned JSON file —
written atomically (tmp + rename, the checkpoint publish discipline)
into ``ALINK_TPU_POSTMORTEM_DIR`` — so the verdict and any single
request's lifetime can be read *offline*, with no live process left to
scrape. Counterpart: ``alink_tpu/common/postmortem.py``, copied, with
the same bundle format; ``flags`` resolves the port's registry. The
port's triggers are the JAX package's: a serving breaker opening, an
injected kill, an SLO's fast-window burn (``online/slo.py``) and the
online DAG's first stage abort (``online/dag.py``).

Bundle shape (``format: alink_tpu_postmortem_v1``)::

    reason / detail / created_unix / pid
    trace     — flight-recorder meta + events (the span ring)
    requests  — finished request timelines (common/reqtrace.py ring)
    inflight  — the requests the incident caught mid-air
    events    — swap/evict/lane-rebuild/breaker history ring
    metrics   — MetricsRegistry.snapshot() (exemplars included)
    flags     — every registered flag's resolved value
    statusz   — the live admin plane's /statusz doc (when armed)
    context   — producer-set pointers (checkpoint path, model version)
    extra     — trigger-site payload (breaker step, SLO clause, ...)

Triggers are debounced process-wide (``ALINK_TPU_POSTMORTEM_DEBOUNCE_S``,
default 60 s): one incident typically fires several triggers at once
(the breaker opens, THEN the burn alert pages) and a storm of
near-identical bundles would bury the one that matters — suppressed
triggers count in ``alink_postmortem_suppressed_total`` instead.
Retention is bounded (``ALINK_TPU_POSTMORTEM_KEEP`` newest bundles).

Capture never throws into the triggering hot path: a failed write
warns once per error kind and counts in
``alink_postmortem_errors_total``. Everything here is host-side.
The whole layer is off until ``ALINK_TPU_POSTMORTEM_DIR`` is set.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, Optional

from . import reqtrace
from .flags import FLAGS, flag_value
from .metrics import get_registry, metrics_enabled, record_fallback_once
from .tracing import get_tracer, trace_instant

__all__ = ["BUNDLE_FORMAT", "maybe_bundle", "postmortem_dir",
           "set_context", "clear_context", "load_bundle",
           "reset_debounce"]

BUNDLE_FORMAT = "alink_tpu_postmortem_v1"

_lock = threading.Lock()
_last_monotonic: float = 0.0
_seq = itertools.count(1)
_context: Dict[str, Any] = {}


def postmortem_dir() -> str:
    """The bundle directory (``ALINK_TPU_POSTMORTEM_DIR``; empty =
    capture off)."""
    return str(flag_value("ALINK_TPU_POSTMORTEM_DIR", "") or "")


def set_context(key: str, value: Any) -> None:
    """Attach a producer pointer to every future bundle (e.g. a
    ``checkpoint`` path, so a bundle names the restart point)."""
    with _lock:
        _context[str(key)] = value


def clear_context(key: Optional[str] = None) -> None:
    with _lock:
        if key is None:
            _context.clear()
        else:
            _context.pop(key, None)


def reset_debounce() -> None:
    """Test hook: re-arm the process-wide debounce window."""
    global _last_monotonic
    with _lock:
        _last_monotonic = 0.0


def _json_safe(v: Any) -> Any:
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


def _resolved_flags() -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for f in FLAGS:
        try:
            out[f.name] = _json_safe(f.read())
        except Exception:                      # junk env for a strict flag
            out[f.name] = {"raw": FLAGS.raw(f.name),
                           "error": "unparsable"}
    return out


def _statusz_doc() -> Dict[str, Any]:
    from .adminz import get_admin
    admin = get_admin()
    if admin is None:
        return {"armed": False}
    try:
        doc = admin.statusz()
        doc["armed"] = True
        return doc
    except Exception as e:                     # a probe source mid-teardown
        return {"armed": True, "error": f"{type(e).__name__}: {e}"}


def maybe_bundle(reason: str, detail: str = "",
                 extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Write one post-mortem bundle for ``reason`` unless capture is
    off or the debounce window is still open; returns the bundle path
    (``None`` when nothing was written). Never raises."""
    global _last_monotonic
    out_dir = postmortem_dir()
    if not out_dir:
        return None
    debounce = float(flag_value("ALINK_TPU_POSTMORTEM_DEBOUNCE_S", 60.0))
    now = time.monotonic()
    with _lock:
        if _last_monotonic and now - _last_monotonic < debounce:
            if metrics_enabled():
                get_registry().inc("alink_postmortem_suppressed_total",
                                   1, {"reason": str(reason)})
            return None
        _last_monotonic = now
        seq = next(_seq)
        context = dict(_context)
    try:
        path = _write_bundle(out_dir, str(reason), str(detail), extra,
                             context, seq)
    except Exception as e:
        # capture failing must not take the serving path down with it
        record_fallback_once(
            "postmortem", "alink_postmortem_errors_total",
            {"kind": type(e).__name__},
            f"post-mortem bundle write failed ({type(e).__name__}: {e}) "
            f"— check ALINK_TPU_POSTMORTEM_DIR ({out_dir!r}) is writable")
        return None
    if metrics_enabled():
        get_registry().inc("alink_postmortem_bundles_total", 1,
                           {"reason": str(reason)})
    trace_instant("postmortem.bundle", cat="postmortem",
                  args={"reason": str(reason), "path": path})
    return path


def _write_bundle(out_dir: str, reason: str, detail: str,
                  extra: Optional[Dict[str, Any]],
                  context: Dict[str, Any], seq: int) -> str:
    tracer = get_tracer()
    doc: Dict[str, Any] = {
        "format": BUNDLE_FORMAT,
        "reason": reason,
        "detail": detail,
        "created_unix": time.time(),
        "pid": os.getpid(),
        "trace": {"meta": tracer._meta(), "events": tracer.events()},
        "requests": reqtrace.recent(),
        "inflight": reqtrace.inflight_docs(),
        "events": reqtrace.recent_events(),
        "metrics": get_registry().snapshot(),
        "flags": _resolved_flags(),
        "statusz": _statusz_doc(),
        "context": {k: _json_safe(v) for k, v in context.items()},
    }
    if extra:
        doc["extra"] = {k: _json_safe(v) for k, v in extra.items()}
    os.makedirs(out_dir, exist_ok=True)
    fname = (f"postmortem_{reason}_{int(doc['created_unix'] * 1e3)}"
             f"_{os.getpid()}_{seq:03d}.json")
    path = os.path.join(out_dir, fname)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, default=repr)
    os.replace(tmp, path)                      # atomic publish
    _prune(out_dir, keep=int(flag_value("ALINK_TPU_POSTMORTEM_KEEP", 8)))
    return path


def _prune(out_dir: str, keep: int) -> None:
    """Bounded retention: drop the oldest bundles beyond ``keep``."""
    try:
        bundles = sorted(
            (p for p in os.listdir(out_dir)
             if p.startswith("postmortem_") and p.endswith(".json")),
            key=lambda p: os.path.getmtime(os.path.join(out_dir, p)))
    except OSError:
        return
    for p in bundles[:max(0, len(bundles) - max(1, keep))]:
        try:
            os.remove(os.path.join(out_dir, p))
        except OSError:
            pass                               # a concurrent prune won


def load_bundle(path: str) -> Dict[str, Any]:
    """Parse + version-check one bundle."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("format") != BUNDLE_FORMAT:
        raise ValueError(
            f"{path}: not an alink_tpu post-mortem bundle "
            f"(format={doc.get('format') if isinstance(doc, dict) else '?'!r},"
            f" want {BUNDLE_FORMAT})")
    return doc
