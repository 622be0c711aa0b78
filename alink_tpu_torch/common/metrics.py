"""Process-wide runtime metrics — counters, gauges, histograms, exporters.

Counterpart: ``alink_tpu/common/metrics.py``, copied: the same
registry, the same JSONL run report (``format: alink_tpu_metrics_v1``,
so one reader takes both packages' dumps) and the same Prometheus
exposition text. A **zero-dependency, thread-safe** ``MetricsRegistry``
the runtime reports into, with two exporters —

  * ``registry.dump(path)``  — JSONL run report (one JSON object per line;
    ``MetricsRegistry.load`` round-trips it);
  * ``registry.render_text()`` — Prometheus exposition text, for scraping
    or eyeballing (the admin plane's ``/metrics``).

Producers in the port: the serving tier (``serving/predictor.py``,
``serving/server.py``, ``serving/resilience.py``), the admin plane, the
post-mortem writer and the request channel's depth gauge. The JAX
package's engine, FTRL and checkpoint series are not reported here yet
(ROADMAP A10(a)).

Metrics are ON by default; export ``ALINK_TPU_METRICS=0`` (or ``false`` /
``off``) and every producer skips its registry updates. The recording cost
is a dict update behind one lock per event — events are per batch,
request or swap, never per row.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "MetricsRegistry", "get_registry", "set_registry", "metrics_enabled",
    "env_flag", "DEFAULT_BUCKETS",
]

# the one boolean parser every ``ALINK_TPU_*`` on/off switch goes
# through, so "``=0`` disables" holds everywhere. It lives in
# ``common/flags.py``; re-exported here, the import point of every
# instrumented producer, as in the JAX package.
from .flags import _FALSY, env_flag  # noqa: F401  (re-export)


def metrics_enabled() -> bool:
    """Runtime switch for every instrumented hot path (``ALINK_TPU_METRICS``,
    default on). Read live so tests and long-lived processes can toggle it."""
    return env_flag("ALINK_TPU_METRICS", default=True)


# Latency-shaped default buckets (seconds): serving dispatches sit in the
# 1 ms band, whole trainings in the 1-30 s band — one fixed ladder covers
# both without per-metric tuning (the JAX package's ladder).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_KINDS = ("counter", "gauge", "histogram")


def _label_key(labels: Optional[Dict[str, Any]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Series:
    __slots__ = ("value", "counts", "sum", "count", "exemplars")

    def __init__(self, n_buckets: int = 0):
        self.value = 0.0
        if n_buckets:                      # histogram series
            self.counts = [0] * n_buckets  # per-bucket (non-cumulative)
            self.sum = 0.0
            self.count = 0
            # one exemplar slot per bucket (OpenMetrics-style, last
            # observation wins) — bounded by construction, so a p99
            # bucket can link to a concrete request timeline
            # without the registry ever growing per-request state
            self.exemplars: List[Optional[Dict[str, Any]]] = \
                [None] * n_buckets


class _Family:
    """One named metric: a kind, fixed buckets (histograms), and a series
    per distinct label set, capped to bound cardinality."""

    def __init__(self, registry: "MetricsRegistry", name: str, kind: str,
                 help: str = "", buckets: Optional[Sequence[float]] = None):
        self._registry = registry
        self.name = name
        self.kind = kind
        self.help = help
        if kind == "histogram":
            bs = tuple(buckets) if buckets is not None else DEFAULT_BUCKETS
            if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
                raise ValueError(f"histogram {name}: buckets must be "
                                 f"strictly increasing, got {bs}")
            # final implicit +Inf bucket
            self.buckets: Tuple[float, ...] = bs
        else:
            self.buckets = ()
        self._series: Dict[Tuple[Tuple[str, str], ...], _Series] = {}
        self._overflow_warned = False

    # -- series management ------------------------------------------------
    _OVERFLOW_KEY = (("alink_overflow", "true"),)

    def _get_series(self, labels: Optional[Dict[str, Any]]) -> _Series:
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:
            if len(self._series) >= self._registry.max_series_per_metric \
                    and key != self._OVERFLOW_KEY:
                # cardinality guard: runaway label values (e.g. an id
                # leaking into a label) collapse into one overflow series
                # instead of growing the registry without bound. Warn ONCE
                # per metric name — per-sample warnings on a hot path
                # would be their own flood (the samples keep folding into
                # the overflow series regardless)
                if not self._overflow_warned:
                    self._overflow_warned = True
                    warnings.warn(
                        f"metric {self.name!r}: label-set cardinality cap "
                        f"({self._registry.max_series_per_metric}) reached; "
                        f"further new label sets fold into the "
                        f"alink_overflow=true series (is an unbounded id "
                        f"leaking into a label?)",
                        RuntimeWarning, stacklevel=4)
                self._registry._dropped_series += 1
                return self._get_series(dict(self._OVERFLOW_KEY))
            n_b = len(self.buckets) + 1 if self.kind == "histogram" else 0
            s = self._series[key] = _Series(n_b)
        return s

    # -- recording (caller holds the registry lock via public methods) ----
    def inc(self, amount: float = 1.0,
            labels: Optional[Dict[str, Any]] = None) -> None:
        if self.kind != "counter":
            raise TypeError(f"{self.name} is a {self.kind}, not a counter")
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment")
        with self._registry._lock:
            self._get_series(labels).value += amount

    def set(self, value: float,
            labels: Optional[Dict[str, Any]] = None) -> None:
        if self.kind != "gauge":
            raise TypeError(f"{self.name} is a {self.kind}, not a gauge")
        with self._registry._lock:
            self._get_series(labels).value = float(value)

    def observe(self, value: float,
                labels: Optional[Dict[str, Any]] = None,
                exemplar: Optional[Dict[str, Any]] = None) -> None:
        if self.kind != "histogram":
            raise TypeError(f"{self.name} is a {self.kind}, not a histogram")
        value = float(value)
        with self._registry._lock:
            s = self._get_series(labels)
            i = 0
            n = len(self.buckets)
            while i < n and value > self.buckets[i]:
                i += 1
            s.counts[i] += 1
            s.sum += value
            s.count += 1
            if exemplar:
                ex = dict(exemplar)
                ex["value"] = value
                s.exemplars[i] = ex

    # -- reading ----------------------------------------------------------
    def series(self) -> List[Tuple[Dict[str, str], _Series]]:
        with self._registry._lock:
            return [(dict(k), s) for k, s in self._series.items()]

    def value(self, labels: Optional[Dict[str, Any]] = None) -> float:
        """Current value of one counter/gauge series (0.0 if never set)."""
        if self.kind == "histogram":
            raise TypeError(f"{self.name} is a histogram; read it via "
                            f"series() (sum/count/counts), not value()")
        with self._registry._lock:
            s = self._series.get(_label_key(labels))
            return s.value if s is not None else 0.0


class MetricsRegistry:
    """Thread-safe registry of counters, gauges and fixed-bucket histograms.

    >>> reg = MetricsRegistry()
    >>> reg.inc("requests_total", 1, {"route": "/fit"})
    >>> reg.set_gauge("queue_depth", 3)
    >>> reg.observe("latency_seconds", 0.012)
    >>> reg.dump("/tmp/run.jsonl"); print(reg.render_text())

    One process-wide instance (``get_registry()``) backs the runtime's
    instrumentation; independent instances can be created freely (tests,
    per-run isolation via ``set_registry``).
    """

    def __init__(self, max_series_per_metric: int = 256):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}
        self.max_series_per_metric = int(max_series_per_metric)
        self._dropped_series = 0
        self._created_unix = time.time()

    # -- family accessors (create-or-get; kind conflicts fail loudly) -----
    def _family(self, name: str, kind: str, help: str = "",
                buckets: Optional[Sequence[float]] = None) -> _Family:
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(self, name, kind,
                                                     help, buckets)
            elif fam.kind != kind:
                raise TypeError(f"metric {name!r} already registered as "
                                f"{fam.kind}, requested {kind}")
            elif (kind == "histogram" and buckets is not None
                  and tuple(buckets) != fam.buckets):
                raise ValueError(f"histogram {name!r} already registered "
                                 f"with buckets {fam.buckets}")
            if help and not fam.help:
                fam.help = help
            return fam

    def counter(self, name: str, help: str = "") -> _Family:
        return self._family(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> _Family:
        return self._family(name, "gauge", help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> _Family:
        return self._family(name, "histogram", help, buckets)

    # -- one-call conveniences (the instrumentation call sites) -----------
    def inc(self, name: str, amount: float = 1.0,
            labels: Optional[Dict[str, Any]] = None) -> None:
        self.counter(name).inc(amount, labels)

    def set_gauge(self, name: str, value: float,
                  labels: Optional[Dict[str, Any]] = None) -> None:
        self.gauge(name).set(value, labels)

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, Any]] = None,
                buckets: Optional[Sequence[float]] = None,
                exemplar: Optional[Dict[str, Any]] = None) -> None:
        self.histogram(name, buckets=buckets).observe(value, labels,
                                                      exemplar)

    def value(self, name: str,
              labels: Optional[Dict[str, Any]] = None) -> float:
        """Read one counter/gauge series (0.0 when absent — reads never
        create series)."""
        with self._lock:
            fam = self._families.get(name)
        return fam.value(labels) if fam is not None else 0.0

    def reset(self) -> None:
        with self._lock:
            self._families.clear()
            self._dropped_series = 0
            self._created_unix = time.time()

    # -- snapshots / exporters -------------------------------------------
    def snapshot(self) -> List[Dict[str, Any]]:
        """List of plain-dict records, one per series (JSONL line shape)."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                for labels, s in fam.series():
                    rec: Dict[str, Any] = {"kind": fam.kind, "name": name,
                                           "labels": labels}
                    if fam.help:
                        rec["help"] = fam.help
                    if fam.kind == "histogram":
                        rec["buckets"] = list(fam.buckets)
                        rec["counts"] = list(s.counts)
                        rec["sum"] = s.sum
                        rec["count"] = s.count
                        if any(s.exemplars):
                            rec["exemplars"] = [dict(e) if e else None
                                                for e in s.exemplars]
                    else:
                        rec["value"] = s.value
                    out.append(rec)
        return out

    def dump(self, path: str) -> str:
        """Write the JSONL run report; returns ``path``. First line is a
        meta record; every following line is one series."""
        with self._lock:
            meta = {"kind": "meta", "format": "alink_tpu_metrics_v1",
                    "created_unix": self._created_unix,
                    "dumped_unix": time.time(),
                    "dropped_series": self._dropped_series}
            lines = [json.dumps(meta)]
            lines += [json.dumps(rec) for rec in self.snapshot()]
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            f.write("\n".join(lines))
            f.write("\n")
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "MetricsRegistry":
        """Rebuild a registry from a ``dump()`` JSONL file (round-trip).

        Tolerates a TORN FINAL line (a process killed mid-``dump``):
        the complete
        prefix loads and a ``RuntimeWarning`` names the truncation.
        An unparsable line anywhere BEFORE the end is real corruption
        and still raises — silent mid-file skips would fabricate
        report numbers."""
        reg = cls()
        with open(path) as f:
            lines = f.readlines()
        while lines and not lines[-1].strip():
            lines.pop()
        for i, ln in enumerate(lines):
            ln = ln.strip()
            if not ln:
                continue
            try:
                rec = json.loads(ln)
            except ValueError:
                if i == len(lines) - 1:
                    warnings.warn(
                        f"{path}: final metrics record is torn "
                        f"(truncated dump, {len(ln)} bytes) — loaded "
                        f"the {i} complete record(s) before it",
                        RuntimeWarning, stacklevel=2)
                    break
                raise ValueError(
                    f"{path}: unparsable metrics record at line "
                    f"{i + 1} (mid-file corruption, not a torn tail)")
            kind = rec.get("kind")
            if kind == "meta":
                reg._created_unix = rec.get("created_unix",
                                            reg._created_unix)
                reg._dropped_series = rec.get("dropped_series", 0)
                continue
            if kind not in _KINDS:
                raise ValueError(f"{path}: unknown record kind {kind!r}")
            labels = rec.get("labels") or None
            if kind == "histogram":
                fam = reg.histogram(rec["name"], rec.get("help", ""),
                                    buckets=rec["buckets"])
                with reg._lock:
                    s = fam._get_series(labels)
                    s.counts = list(rec["counts"])
                    s.sum = float(rec["sum"])
                    s.count = int(rec["count"])
                    if rec.get("exemplars"):
                        ex = list(rec["exemplars"])
                        ex += [None] * (len(s.counts) - len(ex))
                        s.exemplars = ex[:len(s.counts)]
            elif kind == "counter":
                reg.counter(rec["name"], rec.get("help", "")) \
                   .inc(float(rec["value"]), labels)
            else:
                reg.gauge(rec["name"], rec.get("help", "")) \
                   .set(float(rec["value"]), labels)
        return reg

    @staticmethod
    def _fmt_labels(labels: Dict[str, str],
                    extra: Optional[Tuple[str, str]] = None) -> str:
        items = sorted(labels.items())
        if extra is not None:
            items.append(extra)
        if not items:
            return ""
        body = ",".join('%s="%s"' % (k, str(v).replace("\\", "\\\\")
                                     .replace('"', '\\"').replace("\n", "\\n"))
                        for k, v in items)
        return "{%s}" % body

    def render_text(self) -> str:
        """Prometheus exposition text (histograms as cumulative
        ``_bucket{le=...}`` + ``_sum`` + ``_count``)."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                if fam.help:
                    lines.append(f"# HELP {name} {fam.help}")
                lines.append(f"# TYPE {name} {fam.kind}")
                for labels, s in fam.series():
                    if fam.kind == "histogram":
                        cum = 0
                        for le, c in zip(list(fam.buckets) + ["+Inf"],
                                         s.counts):
                            cum += c
                            lines.append(
                                f"{name}_bucket"
                                f"{self._fmt_labels(labels, ('le', str(le)))}"
                                f" {cum}")
                        lines.append(f"{name}_sum"
                                     f"{self._fmt_labels(labels)} {s.sum}")
                        lines.append(f"{name}_count"
                                     f"{self._fmt_labels(labels)} {s.count}")
                    else:
                        lines.append(f"{name}{self._fmt_labels(labels)}"
                                     f" {s.value}")
        return "\n".join(lines) + "\n"


# -- the process-wide registry ------------------------------------------

_default_registry = MetricsRegistry()
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The registry every runtime producer reports into."""
    return _default_registry


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-wide registry (per-run isolation, tests); returns
    the previous one."""
    global _default_registry
    with _default_lock:
        prev, _default_registry = _default_registry, reg
    return prev


# -- once-per-key fallback recording ------------------------------------
# Shared by the serving tier (record_serve_fallback, the feeders'
# record_feeder_error) and the post-mortem writer: a fallback must always
# count in the registry but only WARN once per (scope, key) per process —
# per-event warnings would be noise, and a second distinct key is a
# distinct problem that must not be muted by the first.

_fallback_once_lock = threading.Lock()
_fallback_once_seen: set = set()


def record_fallback_once(scope: str, metric: str, labels: Dict[str, str],
                         message: str, *, stacklevel: int = 4) -> bool:
    """Increment ``metric{labels}`` (metrics on), then emit ``message``
    as a RuntimeWarning the FIRST time this (scope, labels-key) is seen.
    Returns True when the warning fired. ``labels`` values must be a
    small stable enum (they are metric labels AND the dedup key)."""
    if metrics_enabled():
        get_registry().inc(metric, 1, labels)
    key = (scope,) + tuple(sorted(labels.items()))
    with _fallback_once_lock:
        if key in _fallback_once_seen:
            return False
        _fallback_once_seen.add(key)
    warnings.warn(message, RuntimeWarning, stacklevel=stacklevel)
    return True


def reset_fallback_warnings(scope: Optional[str] = None) -> None:
    """Test hook: re-arm the once-per-key warnings (one scope, or all)."""
    with _fallback_once_lock:
        if scope is None:
            _fallback_once_seen.clear()
        else:
            for k in [k for k in _fallback_once_seen if k[0] == scope]:
                _fallback_once_seen.discard(k)
