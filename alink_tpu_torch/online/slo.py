"""End-to-end SLO contract for the online-learning DAG.

Counterpart: ``alink_tpu/online/slo.py``, copied (the module imports no
JAX). "The Tail at Scale" discipline applied to the WHOLE loop instead
of per stage: one :class:`SloContract` declares the service-level bounds
the ingest -> train -> hot-swap -> serve -> eval program must hold —

* ``serve_p99_s``        — serving p99 latency bound, evaluated live at
  every eval-window close over the server's rolling latency window;
* ``swap_staleness_s``   — model-swap staleness bound: wall time from a
  model snapshot leaving the trainer to the swap being installed in the
  serving tier (the "how stale can the served model be" clause);
* ``final_window_auc``   — quality floor on the LAST closed eval
  window's AUC (the convergence anchor).

Breaches are TYPED (:class:`SloVerdict`), recorded live (metrics
``alink_e2e_slo_breaches_total{slo=}`` + ``alink_slo_breaches_total``
and an ``e2e.slo_breach`` trace instant) and collected on the
:class:`~alink_tpu_torch.online.dag.DagReport`; :meth:`SloContract.final`
renders the end-of-run verdict list. A bound of ``None``/0 disarms its
clause — the contract never invents bounds the operator did not set
(``ALINK_TPU_E2E_DAG=1`` opts into the flag-derived defaults).

The *live* posture on top of the verdicts:

* every ``observe_*`` call exports the clause state as gauges
  (``alink_slo_observed`` / ``alink_slo_bound`` with ``{dag=,slo=}``),
  so ``/metrics`` sees SLO posture WITHOUT parsing the verdict JSON;
* :class:`SloBurnRate` — Google-SRE-style multi-window burn-rate
  alerting over the same observations. Each observation contributes a
  *burn* = observed/bound (bound/observed for the quality-floor
  clause), i.e. the rate at which the clause's error budget is being
  spent (1.0 = exactly at the bound). Two windows per clause:

  - **fast** (``ALINK_TPU_E2E_BURN_FAST_S``, 5 min): the *paging*
    window — the mean burn of the samples inside it. Crosses the
    threshold within one bad window; this is what flips ``/readyz``
    to 503 (a CRITICAL burn) and fires the alert.
  - **slow** (``ALINK_TPU_E2E_BURN_SLOW_S``, 1 h): the *sustained*
    window — the time-integrated budget fraction
    ``sum(burn_i * dt_i) / slow_s`` (``dt`` capped at the fast
    window, so sparse samples cannot claim hours of burn). A short
    burst barely moves it; only a sustained burn crosses it.

  Transitions emit ``alink_slo_alerts_total{slo=,window=}``, the live
  ``alink_slo_burn_rate{slo=,window=}`` gauges, and typed
  ``health.alert`` tracer instants — degradation is visible while the
  run is still going, not in the post-mortem verdict list.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from ..common import postmortem
from ..common.flags import flag_value
from ..common.metrics import get_registry, metrics_enabled
from ..common.tracing import trace_instant

__all__ = ["SloContract", "SloVerdict", "SloBurnRate", "e2e_dag_enabled",
           "slo_p99_s", "slo_staleness_s", "slo_auc_floor",
           "e2e_deadline_s", "burn_fast_s", "burn_slow_s"]


def e2e_dag_enabled() -> bool:
    """``ALINK_TPU_E2E_DAG``: arm flag-derived DAG defaults."""
    return bool(flag_value("ALINK_TPU_E2E_DAG"))


def slo_p99_s() -> Optional[float]:
    """``ALINK_TPU_E2E_SLO_P99_MS`` in seconds (None = clause off)."""
    ms = float(flag_value("ALINK_TPU_E2E_SLO_P99_MS"))
    return ms / 1e3 if ms > 0 else None


def slo_staleness_s() -> Optional[float]:
    """``ALINK_TPU_E2E_SLO_STALENESS_MS`` in seconds (None = off)."""
    ms = float(flag_value("ALINK_TPU_E2E_SLO_STALENESS_MS"))
    return ms / 1e3 if ms > 0 else None


def slo_auc_floor() -> Optional[float]:
    """``ALINK_TPU_E2E_SLO_AUC`` (None = clause off)."""
    v = float(flag_value("ALINK_TPU_E2E_SLO_AUC"))
    return v if v > 0 else None


def e2e_deadline_s() -> Optional[float]:
    """``ALINK_TPU_E2E_DEADLINE_MS`` in seconds (None = no deadline)."""
    ms = float(flag_value("ALINK_TPU_E2E_DEADLINE_MS"))
    return ms / 1e3 if ms > 0 else None


def burn_fast_s() -> float:
    """``ALINK_TPU_E2E_BURN_FAST_S``: fast (paging) window length."""
    return float(flag_value("ALINK_TPU_E2E_BURN_FAST_S"))


def burn_slow_s() -> float:
    """``ALINK_TPU_E2E_BURN_SLOW_S``: slow (sustained) window length."""
    return float(flag_value("ALINK_TPU_E2E_BURN_SLOW_S"))


class SloVerdict(NamedTuple):
    """One typed SLO clause verdict: ``slo`` names the clause
    (``serve_p99`` | ``swap_staleness`` | ``final_window_auc``),
    ``ok`` whether the observation honored the bound, ``observed``/
    ``bound`` the numbers (seconds for the latency clauses), and
    ``detail`` a human sentence naming the phase/window."""
    slo: str
    ok: bool
    observed: Optional[float]
    bound: float
    detail: str

    def to_dict(self) -> dict:
        return {"slo": self.slo, "ok": bool(self.ok),
                "observed": self.observed, "bound": self.bound,
                "detail": self.detail}


class SloContract:
    """Declarative end-to-end SLO bounds + live breach recording.

    Construct explicitly, or :meth:`from_flags` under
    ``ALINK_TPU_E2E_DAG=1``. ``observe_*`` methods are called by the
    DAG at window closes / swaps; every breach lands in
    :attr:`breaches` exactly once per (clause, context) so a sustained
    storm reads as one typed event per window, not a counter melt."""

    def __init__(self, serve_p99_s: Optional[float] = None,
                 swap_staleness_s: Optional[float] = None,
                 final_window_auc: Optional[float] = None,
                 name: str = "online"):
        self.serve_p99_s = serve_p99_s
        self.swap_staleness_s = swap_staleness_s
        self.final_window_auc = final_window_auc
        self.name = name
        self.breaches: List[SloVerdict] = []
        # the live plane — an attached SloBurnRate monitor
        # (fed by every observation) and the last-seen state per clause
        # for /statusz
        self.burn: Optional["SloBurnRate"] = None
        self._last: Dict[str, dict] = {}

    @classmethod
    def from_flags(cls, name: str = "online") -> "SloContract":
        """The ``ALINK_TPU_E2E_SLO_*`` flag-derived contract."""
        return cls(serve_p99_s=slo_p99_s(),
                   swap_staleness_s=slo_staleness_s(),
                   final_window_auc=slo_auc_floor(), name=name)

    def armed(self) -> bool:
        return any(b is not None for b in (self.serve_p99_s,
                                           self.swap_staleness_s,
                                           self.final_window_auc))

    # -- live observation (the DAG calls these) ---------------------------
    def _breach(self, verdict: SloVerdict) -> None:
        self.breaches.append(verdict)
        trace_instant("e2e.slo_breach", cat="e2e",
                      args={"slo": verdict.slo,
                            "observed": verdict.observed,
                            "bound": verdict.bound,
                            "detail": verdict.detail})
        if metrics_enabled():
            reg = get_registry()
            labels = {"dag": self.name, "slo": verdict.slo}
            reg.inc("alink_e2e_slo_breaches_total", 1, labels)
            # the fleet-facing name — /metrics and
            # fleetz consumers key on alink_slo_* for SLO posture
            reg.inc("alink_slo_breaches_total", 1, labels)

    def _clause_state(self, slo: str, observed: float, bound: float,
                      floor: bool = False) -> None:
        """Export one clause observation live (``alink_slo_observed`` /
        ``alink_slo_bound`` gauges), remember it for /statusz, and feed
        the attached burn monitor. ``floor`` marks a quality-floor
        clause (burn = bound/observed instead of observed/bound)."""
        self._last[slo] = {"observed": observed, "bound": bound,
                           "ok": (observed >= bound if floor
                                  else observed <= bound),
                           "floor": floor, "unix": time.time()}
        if metrics_enabled():
            reg = get_registry()
            labels = {"dag": self.name, "slo": slo}
            reg.set_gauge("alink_slo_observed", observed, labels)
            reg.set_gauge("alink_slo_bound", bound, labels)
        if self.burn is not None:
            self.burn.record(slo, observed, bound, floor=floor)

    def clause_states(self) -> Dict[str, dict]:
        """Last-seen live state per armed clause (for /statusz)."""
        return {k: dict(v) for k, v in self._last.items()}

    def observe_p99(self, p99_s: Optional[float],
                    window: int) -> Optional[SloVerdict]:
        """Live p99 check at an eval-window close; returns the typed
        breach (already recorded) or ``None``."""
        if self.serve_p99_s is None or p99_s is None:
            return None
        self._clause_state("serve_p99", float(p99_s),
                           float(self.serve_p99_s))
        if p99_s <= self.serve_p99_s:
            return None
        v = SloVerdict("serve_p99", False, float(p99_s),
                       float(self.serve_p99_s),
                       f"window {window}: serving p99 "
                       f"{p99_s * 1e3:.1f} ms > bound "
                       f"{self.serve_p99_s * 1e3:.1f} ms")
        self._breach(v)
        return v

    def observe_tenant_p99(self, tenant: str, p99_s: Optional[float],
                           window: int) -> Optional[SloVerdict]:
        """Per-tenant p99 clause for the multi-tenant fleet.

        Same bound as the global ``serve_p99`` clause — the fleet's
        promise is that EVERY tenant sees single-model latency, so one
        contract bound fans out to per-tenant clauses named
        ``serve_p99[<tenant>]``. Each tenant gets its own clause state
        (gauges + burn window), so one noisy tenant burning budget is
        attributable on /statusz instead of vanishing into the fleet
        aggregate."""
        if self.serve_p99_s is None or p99_s is None:
            return None
        slo = f"serve_p99[{tenant}]"
        self._clause_state(slo, float(p99_s), float(self.serve_p99_s))
        if p99_s <= self.serve_p99_s:
            return None
        v = SloVerdict(slo, False, float(p99_s),
                       float(self.serve_p99_s),
                       f"window {window}: tenant {tenant!r} serving p99 "
                       f"{p99_s * 1e3:.1f} ms > bound "
                       f"{self.serve_p99_s * 1e3:.1f} ms")
        self._breach(v)
        return v

    def observe_swap(self, staleness_s: float,
                     version: int) -> Optional[SloVerdict]:
        """Per-swap staleness check (emission -> installed)."""
        if self.swap_staleness_s is None:
            return None
        self._clause_state("swap_staleness", float(staleness_s),
                           float(self.swap_staleness_s))
        if staleness_s <= self.swap_staleness_s:
            return None
        v = SloVerdict("swap_staleness", False, float(staleness_s),
                       float(self.swap_staleness_s),
                       f"swap to version {version} took "
                       f"{staleness_s * 1e3:.1f} ms > bound "
                       f"{self.swap_staleness_s * 1e3:.1f} ms")
        self._breach(v)
        return v

    def observe_auc(self, auc: Optional[float], window: int) -> None:
        """Live per-window AUC posture against the quality floor.

        Unlike the latency clauses this never records a BREACH — the
        contract's AUC clause is on the FINAL window only (early
        windows are legitimately below the floor while the model
        converges) — but the live gauges and the burn monitor see
        every window, so a quality regression shows as a rising
        ``window_auc`` burn long before the end-of-run verdict."""
        if self.final_window_auc is None or auc is None:
            return
        self._clause_state("window_auc", float(auc),
                           float(self.final_window_auc), floor=True)

    # -- the end-of-run verdict -------------------------------------------
    def final(self, p99_s: Optional[float],
              max_staleness_s: Optional[float],
              final_auc: Optional[float]) -> List[SloVerdict]:
        """The whole-run verdict list — one typed entry per ARMED
        clause, ``ok`` reflecting the run's worst observation (live
        breaches already recorded separately in :attr:`breaches`)."""
        out: List[SloVerdict] = []
        if self.serve_p99_s is not None:
            ok = p99_s is not None and p99_s <= self.serve_p99_s
            out.append(SloVerdict(
                "serve_p99", ok, p99_s, float(self.serve_p99_s),
                f"run p99 {p99_s * 1e3:.1f} ms vs bound "
                f"{self.serve_p99_s * 1e3:.1f} ms"
                if p99_s is not None else "no latency samples"))
        if self.swap_staleness_s is not None:
            ok = (max_staleness_s is None
                  or max_staleness_s <= self.swap_staleness_s)
            out.append(SloVerdict(
                "swap_staleness", ok, max_staleness_s,
                float(self.swap_staleness_s),
                f"max swap staleness "
                f"{(max_staleness_s or 0.0) * 1e3:.1f} ms vs bound "
                f"{self.swap_staleness_s * 1e3:.1f} ms"))
        if self.final_window_auc is not None:
            ok = final_auc is not None \
                and final_auc >= self.final_window_auc
            out.append(SloVerdict(
                "final_window_auc", ok, final_auc,
                float(self.final_window_auc),
                f"final-window AUC "
                f"{final_auc if final_auc is not None else 'n/a'} vs "
                f"floor {self.final_window_auc}"))
        return out


class SloBurnRate:
    """Multi-window SLO burn-rate alerting over live clause observations
    (window semantics in the module docstring).

    Attach to a contract (``SloBurnRate(contract)`` sets
    ``contract.burn``) and every ``observe_*`` call feeds
    :meth:`record`; or call :meth:`record` directly in tests with a
    scripted ``clock`` (the same injection pattern the circuit
    breaker's deterministic tests use). A clause's *fast*-window alert
    being active is a CRITICAL burn: :meth:`readiness` reports
    unready, which the admin plane surfaces as ``/readyz`` 503 while
    the burn lasts.
    """

    WINDOWS = ("fast", "slow")
    #: burn cap — a collapsed quality floor (observed ~ 0) or a wildly
    #: blown latency bound must read as "very bad", not inf/NaN in a
    #: gauge
    MAX_BURN = 1e6

    def __init__(self, contract: Optional[SloContract] = None,
                 fast_s: Optional[float] = None,
                 slow_s: Optional[float] = None,
                 threshold: float = 1.0,
                 name: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.fast_s = burn_fast_s() if fast_s is None else float(fast_s)
        self.slow_s = burn_slow_s() if slow_s is None else float(slow_s)
        self.fast_s = max(1e-9, self.fast_s)
        self.slow_s = max(self.fast_s, self.slow_s)
        self.threshold = float(threshold)
        self.name = (name if name is not None
                     else (contract.name if contract is not None
                           else "online"))
        self.clock = clock
        self._lock = threading.Lock()
        # per clause: [(t, burn)] pruned to the slow window
        self._samples: Dict[str, List[Tuple[float, float]]] = {}
        self._active: Dict[Tuple[str, str], bool] = {}
        self.alerts: List[dict] = []
        if contract is not None:
            contract.burn = self

    def _burn_of(self, observed: float, bound: float,
                 floor: bool) -> float:
        """One observation's budget-burn rate: 1.0 = exactly at the
        bound, 2.0 = spending budget twice as fast as allowed."""
        if floor:
            if observed <= 0:
                return self.MAX_BURN
            return min(self.MAX_BURN, bound / observed)
        if bound <= 0:
            return 0.0
        return min(self.MAX_BURN, observed / bound)

    def record(self, slo: str, observed: float, bound: float,
               floor: bool = False) -> Dict[str, float]:
        """Feed one clause observation; returns the fresh per-window
        rates (after alert-transition processing)."""
        now = self.clock()
        burn = self._burn_of(float(observed), float(bound), floor)
        with self._lock:
            buf = self._samples.setdefault(slo, [])
            buf.append((now, burn))
            cutoff = now - self.slow_s
            while buf and buf[0][0] < cutoff:
                buf.pop(0)
        return self._evaluate(slo, now)

    # -- window math ------------------------------------------------------
    def _rates(self, slo: str, now: float) -> Dict[str, float]:
        with self._lock:
            buf = list(self._samples.get(slo, ()))
        if not buf:
            return {"fast": 0.0, "slow": 0.0}
        # fast: mean burn of the samples inside the paging window —
        # reacts within one bad window, decays as samples age out
        fast_cut = now - self.fast_s
        fast = [b for t, b in buf if t >= fast_cut]
        fast_rate = sum(fast) / len(fast) if fast else 0.0
        # slow: time-integrated budget fraction. Sample i holds its
        # burn until the next sample (capped at fast_s so sparse
        # observations cannot claim hours of burn); the newest sample
        # integrates up to `now`. A short burst therefore stays small
        # — only a SUSTAINED burn fills the slow window.
        slow_cut = now - self.slow_s
        area = 0.0
        for i, (t, b) in enumerate(buf):
            t_next = buf[i + 1][0] if i + 1 < len(buf) else now
            dt = min(max(0.0, t_next - max(t, slow_cut)), self.fast_s)
            area += b * dt
        return {"fast": fast_rate, "slow": area / self.slow_s}

    # -- alerting ---------------------------------------------------------
    def _evaluate(self, slo: str, now: float) -> Dict[str, float]:
        rates = self._rates(slo, now)
        reg = get_registry() if metrics_enabled() else None
        for window in self.WINDOWS:
            rate = rates[window]
            labels = {"dag": self.name, "slo": slo, "window": window}
            if reg is not None:
                reg.set_gauge("alink_slo_burn_rate", rate, labels)
            key = (slo, window)
            active = rate >= self.threshold
            was = self._active.get(key, False)
            if active == was:
                continue
            self._active[key] = active
            state = "firing" if active else "resolved"
            trace_instant("health.alert", cat="health",
                          args={"slo": slo, "window": window,
                                "state": state,
                                "burn_rate": round(rate, 6),
                                "threshold": self.threshold,
                                "dag": self.name})
            self.alerts.append({"slo": slo, "window": window,
                                "state": state,
                                "burn_rate": rate, "unix": time.time()})
            del self.alerts[:-64]
            if active and reg is not None:
                reg.inc("alink_slo_alerts_total", 1, labels)
            if active and window == "fast":
                # the paging alert IS the incident signal:
                # capture a post-mortem bundle while the request/trace
                # rings still hold the burn's evidence (debounced; off
                # without ALINK_TPU_POSTMORTEM_DIR)
                postmortem.maybe_bundle(
                    "slo_burn",
                    f"{self.name}: {slo} fast-window burn rate "
                    f"{rate:.3f} >= {self.threshold}",
                    extra={"dag": self.name, "slo": slo,
                           "burn_rate": rate,
                           "threshold": self.threshold})
        return rates

    # -- live verdicts (the admin plane reads these) ----------------------
    def critical(self) -> List[str]:
        """Clauses whose FAST-window alert is active right now
        (re-evaluated at call time, so a burn clears by aging out even
        with no new observations)."""
        now = self.clock()
        with self._lock:
            slos = list(self._samples)
        return [slo for slo in slos
                if self._evaluate(slo, now)["fast"] >= self.threshold]

    def readiness(self) -> dict:
        """ReadinessSource for the admin plane: unready (-> /readyz
        503) while any critical burn is active; always healthy — a
        burning SLO is a degraded service, not a dead process."""
        crit = self.critical()
        return {"ready": not crit, "healthy": True,
                "monitor": "slo_burn_rate", "critical_burns": crit,
                "threshold": self.threshold,
                "fast_s": self.fast_s, "slow_s": self.slow_s}

    def state(self) -> dict:
        """The /statusz document: per-clause window rates + the recent
        alert-transition log."""
        now = self.clock()
        with self._lock:
            slos = {slo: len(buf) for slo, buf in self._samples.items()}
        clauses = {}
        for slo, n in sorted(slos.items()):
            rates = self._rates(slo, now)
            clauses[slo] = {
                "fast": rates["fast"], "slow": rates["slow"],
                "fast_active": self._active.get((slo, "fast"), False),
                "slow_active": self._active.get((slo, "slow"), False),
                "samples": n,
            }
        return {"threshold": self.threshold, "fast_s": self.fast_s,
                "slow_s": self.slow_s, "clauses": clauses,
                "alerts": list(self.alerts)}


class SwapStalenessTracker:
    """Measures the emission->installed wall time of every model swap.

    The DAG's feeder callback opens a sample when a snapshot leaves the
    trainer (``mark_emitted``) and closes it when the swap lands
    (``mark_installed``); the max/mean ride the report and the
    ``alink_e2e_swap_staleness_seconds`` gauge."""

    def __init__(self, contract: Optional[SloContract] = None,
                 name: str = "online"):
        self.contract = contract
        self.name = name
        self.samples: List[float] = []
        self._open: Optional[float] = None

    def mark_emitted(self) -> None:
        self._open = time.perf_counter()

    def mark_installed(self, version: int) -> float:
        t0 = self._open if self._open is not None else time.perf_counter()
        dt = time.perf_counter() - t0
        self._open = None
        self.samples.append(dt)
        if metrics_enabled():
            get_registry().set_gauge("alink_e2e_swap_staleness_seconds",
                                     dt, {"dag": self.name})
        if self.contract is not None:
            self.contract.observe_swap(dt, version)
        return dt

    @property
    def max_s(self) -> Optional[float]:
        return max(self.samples) if self.samples else None

    @property
    def mean_s(self) -> Optional[float]:
        return (sum(self.samples) / len(self.samples)
                if self.samples else None)
