"""Training-health monitoring — probe series, watchdog rules, HealthReport.

Counterpart: ``alink_tpu/common/health.py``, copied (the module imports
no JAX). The reference platform gets model-level training visibility
from two places: the per-superstep loss the optimizers print through
slf4j (``UpdateModel.java`` logs the loss curve) and whatever the user
bolts on top of the emitted model stream. Nothing watches *health*: a
NaN in the L-BFGS carry, a diverging loss, or silent weight drift in the
FTRL model stream is invisible until the final model is wrong. This
module is the missing layer:

  * **probe channel** (``engine/context.py``): stages publish named
    per-superstep scalars (``ctx.probe("loss", v)``,
    ``ctx.probe_nonfinite("grad", g)``). Each probe rides the carry as
    one ``(max_iter,)`` float32 series written on the device, with no
    host read, fetched at the boundaries where the checkpoint subsystem
    already copies the carry to the host, and after the run.
  * :class:`HealthMonitor` — ingests probe series (bulk, from a
    ``ComQueueResult`` or a checkpoint-boundary carry) or incremental
    per-batch values (the FTRL stream path), runs a pluggable rule set
    over them, and emits three artifacts per new alert:
      - ``alink_health_*`` counters/gauges into the MetricsRegistry,
      - a ``health.alert`` instant event into the structured tracer,
      - an entry in the versioned :meth:`HealthMonitor.report` JSON
        (the JAX package's ``tools/health.py`` renders it).
  * **rule catalog** (severities in parentheses):
      - :class:`NonFiniteRule` (critical) — a ``nonfinite.*`` count probe
        went positive, or any probe value itself is NaN/Inf;
      - :class:`DivergenceRule` (warn) — the objective rose a relative
        ``rel`` above its running best and stayed there;
      - :class:`PlateauRule` (info) — no relative improvement over the
        last ``window`` steps (early-stall);
      - :class:`UpdateRatioRule` (warn) — exploding ‖Δw‖/‖w‖;
      - :class:`DriftRule` (warn) — FTRL weight drift vs the last
        snapshot beyond a threshold.

Master switch: ``ALINK_TPU_HEALTH`` (default **on**, like
``ALINK_TPU_METRICS``; ``0/false/off/no`` disables). With it off,
``ctx.probe`` is a no-op, so the carry holds no probe series, and the
checkpoint signature lacks ``health_probes``: a probe-less snapshot is
never resumed by a probed run, nor the reverse.
"""

from __future__ import annotations

import fnmatch
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .metrics import env_flag, get_registry, metrics_enabled
from .tracing import trace_instant

__all__ = [
    "HEALTH_ENV", "HEALTH_FORMAT", "health_enabled",
    "HealthAlert", "HealthAlertError", "HealthRule",
    "NonFiniteRule", "DivergenceRule", "PlateauRule", "ThresholdRule",
    "UpdateRatioRule", "DriftRule", "default_rules",
    "HealthMonitor", "sparkline",
]

HEALTH_ENV = "ALINK_TPU_HEALTH"
HEALTH_FORMAT = "alink_tpu_health_v1"

# severity ladder, least to most severe (report ordering + raise_on sets)
SEVERITIES = ("info", "warn", "critical")


def health_enabled() -> bool:
    """``ALINK_TPU_HEALTH`` master switch (default ON). Read live so tests
    and long-lived processes can toggle it per run; the engine folds the
    value into the program-cache key, so a toggle recompiles instead of
    serving a stale probe-less (or probe-carrying) program."""
    return env_flag(HEALTH_ENV, default=True)


def warn_if_disabled(context: str, stacklevel: int = 3) -> bool:
    """Shared 'monitor attached but the switch is off' warning for every
    ``health=`` hook (optimizers, kmeans, FTRL). Returns the live switch
    value so call sites read ``if not warn_if_disabled(...)`` naturally."""
    on = health_enabled()
    if not on:
        import warnings
        warnings.warn(
            f"{context}: a HealthMonitor is attached but {HEALTH_ENV} is "
            f"off — no probes are recorded, so the monitor will see "
            f"nothing", RuntimeWarning, stacklevel=stacklevel)
    return on


@dataclass(frozen=True)
class HealthAlert:
    """One rule violation at one step of one probe series."""
    rule: str
    severity: str          # "info" | "warn" | "critical"
    series: str            # probe name ("loss", "nonfinite.grad", ...)
    step: int              # 1-based superstep / micro-batch index
    value: float
    message: str
    source: str = "run"    # monitor source label ("qn", "kmeans", "ftrl")

    def to_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "severity": self.severity,
                "series": self.series, "step": int(self.step),
                "value": float(self.value), "message": self.message,
                "source": self.source}

    @property
    def key(self) -> Tuple[str, str, int]:
        """Dedupe identity: re-evaluating a growing series must not
        re-report the same violation."""
        return (self.rule, self.series, int(self.step))


class HealthAlertError(RuntimeError):
    """Raised by :meth:`HealthMonitor.evaluate` when an alert's severity
    is in the monitor's ``raise_on`` set — the watchdog abort. The
    triggering alerts ride on ``.alerts``."""

    def __init__(self, alerts: Sequence[HealthAlert]):
        self.alerts = list(alerts)
        worst = max(alerts, key=lambda a: SEVERITIES.index(a.severity))
        super().__init__(
            f"training health watchdog: {worst.message} "
            f"({len(alerts)} alert(s); see HealthMonitor.report())")


def _finite_min_accum(v: np.ndarray) -> np.ndarray:
    """Running minimum ignoring non-finite entries (they are the
    NonFiniteRule's business, not the divergence baseline's)."""
    clean = np.where(np.isfinite(v), v, np.inf)
    return np.minimum.accumulate(clean)


class HealthRule:
    """One pluggable check over probe series.

    ``pattern`` is an ``fnmatch`` glob (or tuple of globs) selecting which
    series the rule applies to; ``check(name, steps, values)`` returns
    alerts for one series (``steps`` 1-based ints, ``values`` float64).
    """

    name = "rule"
    severity = "warn"

    def __init__(self, pattern="*"):
        self.patterns: Tuple[str, ...] = \
            (pattern,) if isinstance(pattern, str) else tuple(pattern)

    def applies(self, series_name: str) -> bool:
        return any(fnmatch.fnmatch(series_name, p) for p in self.patterns)

    def check(self, name: str, steps: np.ndarray,
              values: np.ndarray) -> List[HealthAlert]:  # pragma: no cover
        raise NotImplementedError

    def describe(self) -> Dict[str, Any]:
        return {"rule": self.name, "severity": self.severity,
                "patterns": list(self.patterns)}

    def _alert(self, series, step, value, message) -> HealthAlert:
        return HealthAlert(rule=self.name, severity=self.severity,
                           series=series, step=int(step),
                           value=float(value), message=message)


class NonFiniteRule(HealthRule):
    """NaN/Inf watchdog — the one alert that means the run is garbage.

    Fires when a ``nonfinite.*`` count probe (``ctx.probe_nonfinite``)
    goes positive, and when any probe value itself is non-finite (a NaN
    loss is as fatal as a NaN gradient). Reports the FIRST offending step
    per series — everything after the first NaN is poisoned anyway.
    """

    name = "nonfinite"
    severity = "critical"

    def __init__(self, pattern="*"):
        super().__init__(pattern)

    def check(self, name, steps, values):
        if name.startswith("nonfinite."):
            bad = np.isnan(values) | (values > 0)
        else:
            bad = ~np.isfinite(values)
        if not bad.any():
            return []
        i = int(np.argmax(bad))
        if name.startswith("nonfinite."):
            what = (f"{int(values[i])} non-finite element(s)"
                    if np.isfinite(values[i]) else "a non-finite count")
        else:
            what = "a non-finite value"
        # "step", not "superstep": the same rule watches engine superstep
        # series AND per-micro-batch stream series
        return [self._alert(
            name, steps[i], values[i],
            f"probe '{name}' reports {what} at step {int(steps[i])}")]


class DivergenceRule(HealthRule):
    """Objective rising: value exceeds its running best by a relative
    margin after a grace period. The comparison floor self-scales to the
    series (``max(|best|, floor_rel * |first value|, atol)``) so noise
    around a fully-converged ~0 objective never fires, negative
    objectives are handled, and a genuine rise back toward the starting
    loss always does."""

    name = "divergence"
    severity = "warn"

    # default patterns cover OPTIMIZATION objectives (monotone-ish by
    # construction). Per-batch progressive-validation series are noisy
    # samples hovering near zero on a converged model — a relative-rise
    # criterion is meaningless there; attach an explicit
    # DivergenceRule("ftrl.pv_logloss", atol=<scale>) to opt in.
    def __init__(self, pattern=("loss", "inertia"),
                 rel: float = 0.5, grace: int = 3, atol: float = 1e-8,
                 floor_rel: float = 1e-3):
        super().__init__(pattern)
        self.rel = float(rel)
        self.grace = int(grace)
        self.atol = float(atol)
        self.floor_rel = float(floor_rel)

    def check(self, name, steps, values):
        if len(values) <= self.grace:
            return []
        best = _finite_min_accum(values)
        finite = values[np.isfinite(values)]
        first = abs(float(finite[0])) if finite.size else 0.0
        floor = max(self.atol, self.floor_rel * first)
        with np.errstate(invalid="ignore"):
            bad = (values - best) > self.rel * np.maximum(np.abs(best),
                                                          floor)
        bad &= np.isfinite(values) & np.isfinite(best)
        bad[:self.grace] = False
        if not bad.any():
            return []
        i = int(np.argmax(bad))
        return [self._alert(
            name, steps[i], values[i],
            f"'{name}' diverged at step {int(steps[i])}: {values[i]:.6g} is "
            f">{self.rel:.0%} above its best {best[i]:.6g}")]

    def describe(self):
        d = super().describe()
        d.update(rel=self.rel, grace=self.grace, floor_rel=self.floor_rel)
        return d


class PlateauRule(HealthRule):
    """Early stall: the objective's best value improved by less than
    ``rel_tol`` (relative) over the last ``window`` steps. One alert per
    series (anchored at the first step the stall is visible), severity
    ``info`` — a converged run stopping early is often fine; the alert
    exists so a *stalled-but-still-burning-chips* run is noticed."""

    name = "plateau"
    severity = "info"

    def __init__(self, pattern=("loss", "inertia"), window: int = 8,
                 rel_tol: float = 1e-4):
        super().__init__(pattern)
        self.window = int(window)
        self.rel_tol = float(rel_tol)

    def check(self, name, steps, values):
        w = self.window
        if len(values) < 2 * w:
            return []
        best = _finite_min_accum(values)
        if not np.isfinite(best[-1]):
            return []
        for t in range(2 * w - 1, len(values)):
            before, now = best[t - w], best[t]
            if not (np.isfinite(before) and np.isfinite(now)):
                continue
            if (before - now) <= self.rel_tol * max(abs(before), 1e-12):
                return [self._alert(
                    name, steps[t], values[t],
                    f"'{name}' plateaued: best improved "
                    f"{before - now:.3g} over the last {w} steps "
                    f"(step {int(steps[t])})")]
        return []

    def describe(self):
        d = super().describe()
        d.update(window=self.window, rel_tol=self.rel_tol)
        return d


class ThresholdRule(HealthRule):
    """Generic 'value crossed a threshold' rule; reports the first
    offending step per series."""

    name = "threshold"
    severity = "warn"

    def __init__(self, pattern, threshold: float):
        super().__init__(pattern)
        self.threshold = float(threshold)

    def check(self, name, steps, values):
        with np.errstate(invalid="ignore"):
            bad = values > self.threshold
        bad &= np.isfinite(values)
        if not bad.any():
            return []
        i = int(np.argmax(bad))
        return [self._alert(
            name, steps[i], values[i],
            f"'{name}' = {values[i]:.6g} exceeds {self.threshold:.6g} "
            f"at step {int(steps[i])}")]

    def describe(self):
        d = super().describe()
        d["threshold"] = self.threshold
        return d


class UpdateRatioRule(ThresholdRule):
    """Exploding update: ‖Δw‖/‖w‖ beyond ``threshold`` (default 10 — a
    step that moves the weights 10x their own norm)."""

    name = "update_ratio"

    def __init__(self, threshold: float = 10.0, pattern="*update_ratio*"):
        super().__init__(pattern, threshold)


class DriftRule(ThresholdRule):
    """FTRL weight drift vs the last emitted snapshot: relative L2
    distance beyond ``threshold`` between consecutive model snapshots —
    the 'model silently walked away' detector for long online runs."""

    name = "drift"

    def __init__(self, threshold: float = 1.0, pattern="*drift*"):
        super().__init__(pattern, threshold)


def default_rules() -> List[HealthRule]:
    """The stock watchdog set every trainer gets."""
    return [NonFiniteRule(), DivergenceRule(), PlateauRule(),
            UpdateRatioRule(), DriftRule()]


class HealthMonitor:
    """Pluggable-rule watchdog over probe series.

    >>> mon = HealthMonitor(source="qn")
    >>> coef, curve, steps = optimize(obj, data, OptimParams(health=mon))
    >>> mon.healthy, [a.message for a in mon.alerts]
    >>> mon.save_report("health.json")     # render: python tools/health.py

    Two ingestion paths:
      * :meth:`ingest` / :meth:`ingest_result` — bulk series (the engine
        hands over the stacked probe carry after a run, and — for
        checkpointed runs — the prefix at every snapshot boundary, so a
        watchdog with ``raise_on={"critical"}`` aborts a poisoned run at
        the next boundary instead of burning the full budget);
      * :meth:`record` — one (step, value) point (the FTRL stream path).

    :meth:`evaluate` runs every rule over every matching series, dedupes
    against already-reported alerts, and for each NEW alert increments
    ``alink_health_alerts_total{rule,severity,source}``, sets
    ``alink_health_last_alert_step{source}``, and emits a ``health.alert``
    tracer instant. If a new alert's severity is in ``raise_on``, a
    :class:`HealthAlertError` is raised AFTER recording/emitting.

    Not thread-safe by design: one monitor belongs to one training run
    (the registry/tracer it emits into are themselves thread-safe).
    """

    def __init__(self, rules: Optional[Sequence[HealthRule]] = None,
                 source: str = "run",
                 raise_on: Iterable[str] = (),
                 max_points: int = 4096):
        self.rules: List[HealthRule] = \
            default_rules() if rules is None else list(rules)
        for r in self.rules:
            # fail fast: an out-of-ladder severity would otherwise crash
            # far away, inside worst_severity()/report() ordering
            if r.severity not in SEVERITIES:
                raise ValueError(
                    f"rule {r.name!r}: unknown severity {r.severity!r} "
                    f"(choose from {SEVERITIES})")
        self.source = source
        self.raise_on = frozenset(raise_on)
        unknown = self.raise_on - set(SEVERITIES)
        if unknown:
            raise ValueError(f"raise_on: unknown severities {sorted(unknown)}"
                             f" (choose from {SEVERITIES})")
        # bounded retention, like the tracer's flight recorder: a
        # long-running stream (FTRL records points per micro-batch,
        # forever) must not grow host memory without bound, and each
        # evaluate() re-scans the retained window — the cap also bounds
        # the rule work per evaluation. The newest ``max_points`` points
        # per series are kept; rules see a sliding window (alert steps
        # stay absolute).
        self.max_points = int(max_points)
        if self.max_points < 8:
            raise ValueError(f"max_points must be >= 8, got {max_points}")
        self.alerts: List[HealthAlert] = []
        self._seen: set = set()
        # (rule, series) -> is the violation still present as of the last
        # evaluation? A CONTINUING incident reports once — without this,
        # the bounded retention window sliding under a persistent anomaly
        # re-anchors the rule's "first offending step" and the same
        # incident would re-alert at ever-shifting steps
        self._active: Dict[Tuple[str, str], bool] = {}
        self._series: "Dict[str, Tuple[List[int], List[float]]]" = {}

    def _trim(self, name: str) -> None:
        steps, vals = self._series[name]
        # amortize: trim in chunks, not per append
        if len(vals) > self.max_points + self.max_points // 4:
            drop = len(vals) - self.max_points
            del steps[:drop]
            del vals[:drop]

    # -- ingestion --------------------------------------------------------
    def record(self, name: str, step: int, value: float) -> None:
        """Append one point to a series (stream producers)."""
        steps, vals = self._series.setdefault(name, ([], []))
        steps.append(int(step))
        vals.append(float(value))
        self._trim(name)

    def ingest(self, series: Dict[str, Any], start_step: int = 1) -> None:
        """Replace whole series from dense per-step arrays: element ``i``
        is step ``start_step + i``. Re-ingesting a longer prefix of the
        same run simply replaces the series (alerts stay deduped). Only
        the newest ``max_points`` elements are retained."""
        for name, arr in series.items():
            v = np.asarray(arr, dtype=np.float64).reshape(-1)
            first = start_step
            if len(v) > self.max_points:
                first += len(v) - self.max_points
                v = v[-self.max_points:]
            self._series[name] = (
                list(range(first, first + len(v))), list(v))

    def ingest_result(self, result) -> None:
        """Pull every probe series out of a ``ComQueueResult``."""
        self.ingest(result.probes())

    def series(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        steps, vals = self._series[name]
        return np.asarray(steps, np.int64), np.asarray(vals, np.float64)

    def series_names(self) -> List[str]:
        return sorted(self._series)

    # -- evaluation -------------------------------------------------------
    def evaluate(self) -> List[HealthAlert]:
        """Run every rule; returns (and records/emits) the NEW alerts."""
        new: List[HealthAlert] = []
        for rule in self.rules:
            for name in sorted(self._series):
                if not rule.applies(name):
                    continue
                steps, vals = self.series(name)
                if not len(vals):
                    continue
                got = rule.check(name, steps, vals)
                ak = (rule.name, name)
                if not got:
                    self._active[ak] = False   # recovered: may re-alert
                    continue
                if self._active.get(ak):
                    continue                   # continuing incident
                self._active[ak] = True
                for alert in got:
                    if alert.source != self.source:
                        alert = HealthAlert(**{**alert.to_dict(),
                                               "source": self.source})
                    if alert.key in self._seen:
                        continue
                    self._seen.add(alert.key)
                    self.alerts.append(alert)
                    new.append(alert)
        if metrics_enabled():
            reg = get_registry()
            for name, (steps, vals) in self._series.items():
                if vals:
                    reg.set_gauge("alink_health_probe_last", vals[-1],
                                  {"probe": name, "source": self.source})
        if new:
            self._emit(new)
        fatal = [a for a in new if a.severity in self.raise_on]
        if fatal:
            raise HealthAlertError(fatal)
        return new

    def _emit(self, alerts: Sequence[HealthAlert]) -> None:
        mx = metrics_enabled()
        reg = get_registry() if mx else None
        for a in alerts:
            if mx:
                reg.inc("alink_health_alerts_total", 1,
                        {"rule": a.rule, "severity": a.severity,
                         "source": a.source})
                reg.set_gauge("alink_health_last_alert_step",
                              a.step, {"source": a.source})
            trace_instant("health.alert", cat="health",
                          args={"rule": a.rule, "severity": a.severity,
                                "series": a.series, "step": a.step,
                                "value": a.value, "source": a.source})
        if mx:
            reg.set_gauge("alink_health_alerts", len(self.alerts),
                          {"source": self.source})

    # -- reporting --------------------------------------------------------
    @property
    def healthy(self) -> bool:
        """True while nothing above ``info`` has fired."""
        return not any(a.severity != "info" for a in self.alerts)

    def worst_severity(self) -> Optional[str]:
        if not self.alerts:
            return None
        return max((a.severity for a in self.alerts),
                   key=SEVERITIES.index)

    def report(self) -> Dict[str, Any]:
        """The versioned HealthReport document (``tools/health.py`` input).

        Series ride as parallel ``steps``/``values`` lists (JSON-safe:
        NaN/Inf values are serialized as strings by :meth:`save_report`).
        """
        return {
            "format": HEALTH_FORMAT,
            "source": self.source,
            "created_unix": time.time(),
            "healthy": self.healthy,
            "worst_severity": self.worst_severity(),
            "rules": [r.describe() for r in self.rules],
            "alerts": [a.to_dict() for a in sorted(
                self.alerts, key=lambda a: (-SEVERITIES.index(a.severity),
                                            a.step))],
            "series": {
                name: {"steps": [int(s) for s in steps],
                       "values": [float(v) for v in vals]}
                for name, (steps, vals) in sorted(self._series.items())},
        }

    def save_report(self, path: str) -> str:
        """Write the HealthReport JSON (atomic publish); returns ``path``.
        Non-finite floats are encoded as strings (``"NaN"``/``"Infinity"``)
        so the file stays strict-JSON parseable everywhere."""
        doc = _jsonify(self.report())
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, allow_nan=False)
        os.replace(tmp, path)
        return path

    @staticmethod
    def load_report(path: str) -> Dict[str, Any]:
        """Read a :meth:`save_report` file back, decoding the string-coded
        non-finite floats."""
        with open(path) as f:
            doc = json.load(f)
        if doc.get("format") != HEALTH_FORMAT:
            raise ValueError(f"{path}: not an {HEALTH_FORMAT} report "
                             f"(format={doc.get('format')!r})")
        for s in (doc.get("series") or {}).values():
            s["values"] = [_unjsonify_float(v) for v in s.get("values", [])]
        for a in doc.get("alerts") or []:
            a["value"] = _unjsonify_float(a.get("value"))
        return doc


_NONFINITE_STR = {"NaN": float("nan"), "Infinity": float("inf"),
                  "-Infinity": float("-inf")}


def _jsonify(v):
    if isinstance(v, float) and not np.isfinite(v):
        if np.isnan(v):
            return "NaN"
        return "Infinity" if v > 0 else "-Infinity"
    if isinstance(v, dict):
        return {k: _jsonify(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonify(x) for x in v]
    return v


def _unjsonify_float(v):
    if isinstance(v, str) and v in _NONFINITE_STR:
        return _NONFINITE_STR[v]
    return v


# -- rendering helpers (shared by tools/health.py) --------------------------

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: Sequence[float], width: int = 60) -> str:
    """ASCII(-ish) sparkline of a series; non-finite points render as
    ``!``. Downsamples to ``width`` by bucket-mean."""
    v = np.asarray(list(values), dtype=np.float64)
    if v.size == 0:
        return ""
    if v.size > width:
        # bucket means (nan-aware: an all-NaN bucket stays NaN)
        edges = np.linspace(0, v.size, width + 1).astype(int)
        with np.errstate(invalid="ignore"):
            v = np.array([np.nanmean(v[a:b]) if np.isfinite(v[a:b]).any()
                          else np.nan
                          for a, b in zip(edges[:-1], edges[1:])])
    finite = v[np.isfinite(v)]
    if finite.size == 0:
        return "!" * v.size
    lo, hi = float(finite.min()), float(finite.max())
    span = (hi - lo) or 1.0
    out = []
    for x in v:
        if not np.isfinite(x):
            out.append("!")
        else:
            out.append(_SPARK[int(round((x - lo) / span * (len(_SPARK) - 1)))])
    return "".join(out)
