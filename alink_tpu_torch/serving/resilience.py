"""Serving-tier resilience: deadlines, load shedding, circuit-broken
degradation, supervised feeders.

Counterpart: ``alink_tpu/serving/resilience.py``, copied. "The Tail at
Scale" (Dean & Barroso, CACM 2013) is the design brief this module
answers:

* **typed rejections** — :class:`DeadlineExceeded`, :class:`
  RequestCancelled`, :class:`ReplicaCrashed`: every submitted request
  resolves to a result OR one of these, never to silence (the
  no-silent-drops invariant the chaos runs gate);
* **:class:`CircuitBreaker`** — the closed -> open -> half-open state
  machine over the device dispatch: consecutive dispatch failures open
  the breaker, open traffic serves through the host mapper, a single
  half-open probe re-tests the device path on a deterministic
  exponential backoff schedule (``ALINK_TPU_SERVE_BREAKER_*``), and a
  probe failure re-opens with the NEXT backoff step (the no-flap
  guarantee). Every transition records ``alink_serve_breaker_state`` +
  a ``serve.breaker`` trace instant. Only an injected fault
  (:func:`counts_toward_breaker`) moves a breaker: any other dispatch
  error — a kernel that fails to build or launch, a wrapper's refusal —
  fails its batch and leaves the breaker as it was, so the host
  fallback never serves around the card. The fallback is counted and
  turns ``/healthz`` unhealthy;
* **feeder supervision** — :func:`classify_feeder_error` +
  :func:`record_feeder_error`: transient swap failures retry with
  bounded backoff, poisoned snapshots (corrupt payload, geometry
  refusal) skip-and-record, and either way the server keeps serving the
  last good model — never a torn or absent one.

Everything here is host-side runtime policy: no kernel, tensor or
launch depends on it. :class:`TenantQuotaExceeded` comes with the file;
the fleet that raises it waits for ROADMAP A9.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..common import postmortem, reqtrace
from ..common.faults import FaultInjected, TransientFault
from ..common.metrics import get_registry, metrics_enabled
from ..common.tracing import trace_instant

__all__ = [
    "CLOSED", "HALF_OPEN", "OPEN", "BREAKER_STATE_CODES",
    "CircuitBreaker", "DeadlineExceeded", "ReplicaCrashed",
    "RequestCancelled", "TenantQuotaExceeded", "classify_feeder_error",
    "counts_toward_breaker", "record_feeder_error", "record_shed",
    "serve_breaker_enabled",
]


# -- typed rejections -------------------------------------------------------

class DeadlineExceeded(RuntimeError):
    """A request shed because its queue wait already exceeded its
    ``deadline_s`` budget BEFORE the dispatch was paid. Delivered
    through the request's future: the submitter gets a typed rejection
    the moment the serving loop inspects the request, and the device
    never sees the row (no wasted device time, no zombie
    request resolving into a later batch)."""

    def __init__(self, waited_s: float, deadline_s: float):
        super().__init__(
            f"request shed: queue wait {waited_s * 1e3:.1f} ms exceeded "
            f"the {deadline_s * 1e3:.1f} ms deadline before dispatch")
        self.waited_s = waited_s
        self.deadline_s = deadline_s


class RequestCancelled(RuntimeError):
    """A request the submitter cancelled (``RequestFuture.cancel()``)
    before the serving loop dispatched it."""


class TenantQuotaExceeded(RuntimeError):
    """A fleet request rejected AT ADMISSION because its tenant already
    has ``ALINK_TPU_FLEET_TENANT_QUOTA`` requests in flight. Quota is
    per-tenant isolation, not backpressure: one tenant's storm fills its
    own slot budget and gets typed rejections, while every other
    tenant's admission path is untouched (their error budget never pays
    for the noisy neighbor). Recorded as shed reason ``"quota"``."""

    def __init__(self, tenant: str, in_flight: int, quota: int):
        super().__init__(
            f"tenant {tenant!r} quota exceeded: {in_flight} requests "
            f"already in flight (ALINK_TPU_FLEET_TENANT_QUOTA={quota})")
        self.tenant = tenant
        self.in_flight = in_flight
        self.quota = quota


class ReplicaCrashed(RuntimeError):
    """A serving-loop replica died with the request in flight; the
    supervisor quarantined the batch (typed failure, never silence) and
    respawned the loop. Retrying is safe — the crash happened before
    any result was delivered."""

    def __init__(self, replica: int, cause: BaseException):
        super().__init__(
            f"serving replica {replica} crashed with this request in "
            f"flight ({type(cause).__name__}: {cause}); the loop was "
            f"respawned — retry is safe")
        self.replica = replica
        self.cause = cause


# -- flag accessors (common/flags.py registry) ------------------------------

def serve_breaker_enabled() -> bool:
    """``ALINK_TPU_SERVE_BREAKER``: circuit-broken degradation of the
    device dispatch path. Default on; 0 restores the plain behavior (a
    failed batch fails its requests, no fallback routing)."""
    from ..common.flags import flag_value
    return bool(flag_value("ALINK_TPU_SERVE_BREAKER", True))


def breaker_threshold() -> int:
    """``ALINK_TPU_SERVE_BREAKER_THRESHOLD``: consecutive device-
    dispatch failures (closed state) that trip the breaker open."""
    from ..common.flags import flag_value
    return int(flag_value("ALINK_TPU_SERVE_BREAKER_THRESHOLD", 3))


def breaker_backoff_s() -> float:
    """``ALINK_TPU_SERVE_BREAKER_BACKOFF_MS`` (first open->half-open
    probe delay) in seconds."""
    from ..common.flags import flag_value
    return float(flag_value("ALINK_TPU_SERVE_BREAKER_BACKOFF_MS", 50.0)) / 1e3


def breaker_factor() -> float:
    """``ALINK_TPU_SERVE_BREAKER_FACTOR``: deterministic exponential
    backoff multiplier applied per re-open (no jitter — recovery
    schedules must be reproducible under test)."""
    from ..common.flags import flag_value
    return float(flag_value("ALINK_TPU_SERVE_BREAKER_FACTOR", 2.0))


def breaker_max_s() -> float:
    """``ALINK_TPU_SERVE_BREAKER_MAX_MS`` (backoff ceiling) in
    seconds."""
    from ..common.flags import flag_value
    return float(flag_value("ALINK_TPU_SERVE_BREAKER_MAX_MS", 5000.0)) / 1e3


def feeder_retries() -> int:
    """``ALINK_TPU_SERVE_FEEDER_RETRIES``: bounded retry budget for a
    TRANSIENT model-swap failure before the feeder gives up on the
    stream (poisoned snapshots never retry — they skip)."""
    from ..common.flags import flag_value
    return int(flag_value("ALINK_TPU_SERVE_FEEDER_RETRIES", 3))


def feeder_backoff_s() -> float:
    """``ALINK_TPU_SERVE_FEEDER_BACKOFF_MS`` (first retry delay,
    doubling per attempt) in seconds."""
    from ..common.flags import flag_value
    return float(flag_value("ALINK_TPU_SERVE_FEEDER_BACKOFF_MS", 20.0)) / 1e3


# -- circuit breaker --------------------------------------------------------

CLOSED, HALF_OPEN, OPEN = "closed", "half-open", "open"
# gauge encoding of alink_serve_breaker_state: reads as "how broken"
BREAKER_STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Per-model-version breaker over the device dispatch path.

    State machine (deterministic — the backoff schedule is exponential
    with NO jitter, and the clock is injectable for tests)::

        closed --[threshold consecutive failures]--> open(step=0)
        open   --[backoff(step) elapsed]-----------> half-open
        half-open --[ONE probe dispatch succeeds]--> closed (reset)
        half-open --[probe fails]------------------> open(step+1)

    The ``step+1`` on probe failure is the **no-flap guarantee**: a
    backend that keeps failing its probes backs off further each time
    (``backoff(step) = min(max_s, base_s * factor**step)``) instead of
    hammering the broken path at the first interval forever.

    Thread contract: ``acquire()`` is called by each serving loop per
    dispatched batch and returns the route — ``"compiled"`` (closed),
    ``"probe"`` (this caller holds the single half-open probe slot) or
    ``"fallback"`` (open, or a probe already in flight). The caller
    MUST pair a ``"compiled"``/``"probe"`` route with ``on_success``,
    ``on_failure`` or, for an error that is not a breaker event,
    ``release``.
    """

    def __init__(self, name: str, version: int,
                 threshold: Optional[int] = None,
                 backoff_s: Optional[float] = None,
                 factor: Optional[float] = None,
                 max_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.version = int(version)
        self.threshold = breaker_threshold() if threshold is None \
            else max(1, int(threshold))
        self.base_s = breaker_backoff_s() if backoff_s is None \
            else float(backoff_s)
        self.factor = breaker_factor() if factor is None \
            else max(1.0, float(factor))
        self.max_s = breaker_max_s() if max_s is None else float(max_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._retired = False
        self._state = CLOSED
        self._fails = 0          # consecutive failures while closed
        self._step = 0           # backoff step of the CURRENT open spell
        self._opened_at: Optional[float] = None
        self._probing = False
        # counters for stats() and the chaos runs' records
        self.opens = 0           # closed -> open trips
        self.reopens = 0         # half-open probe failures (step bumps)
        self.probes = 0
        self.transitions: list = []   # (from, to, step) — bounded by use

    # -- internals (callers hold the lock) ------------------------------
    def backoff_for(self, step: int) -> float:
        return min(self.max_s, self.base_s * (self.factor ** step))

    def _transition(self, to: str) -> None:
        frm, self._state = self._state, to
        if len(self.transitions) < 256:   # chaos storms are short; bound it
            self.transitions.append((frm, to, self._step))
        if metrics_enabled() and not self._retired:
            # labelled by predictor ONLY: a version label would mint a
            # never-deleted gauge series per hot swap (a day-long FTRL
            # feed swaps thousands of versions) — the version rides the
            # trace instant, where it is an event field not a series
            get_registry().set_gauge(
                "alink_serve_breaker_state", BREAKER_STATE_CODES[to],
                {"predictor": self.name})
        trace_instant("serve.breaker", cat="serve",
                      args={"from": frm, "to": to, "step": self._step,
                            "version": self.version})
        # request-scoped causality: every request in flight
        # across this transition gets the breaker event on its timeline
        reqtrace.annotate_inflight(
            "breaker", {"server": self.name, "from": frm, "to": to,
                        "version": self.version})
        if to == OPEN:
            # breaker OPEN is an incident: freeze the evidence while the
            # rings still hold it (debounced; off without
            # ALINK_TPU_POSTMORTEM_DIR)
            postmortem.maybe_bundle(
                "breaker_open",
                f"breaker {self.name} v{self.version} opened at step "
                f"{self._step}",
                extra={"server": self.name, "version": self.version,
                       "step": self._step, "from": frm})

    # -- the serving loop's API -----------------------------------------
    def retire(self) -> None:
        """Freeze this breaker: a hot swap replaced its model version,
        so a STALE in-flight verdict must neither move the (predictor-
        keyed) state gauge nor bump counters the server already
        snapshotted into its run totals — after retire(), on_success /
        on_failure are no-ops."""
        with self._lock:
            self._retired = True
            self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def acquire(self) -> str:
        """Route for one dispatch: ``compiled`` | ``probe`` |
        ``fallback``. At most ONE probe is outstanding at a time (a
        replica fleet must not stampede the recovering path)."""
        with self._lock:
            if self._state == CLOSED:
                return "compiled"
            if self._state == OPEN and self._clock() >= \
                    (self._opened_at or 0.0) + self.backoff_for(self._step):
                self._transition(HALF_OPEN)
            if self._state == HALF_OPEN and not self._probing:
                self._probing = True
                self.probes += 1
                return "probe"
            return "fallback"

    def on_success(self, probe: bool = False) -> None:
        """Only the probe's OWN verdict moves a non-closed breaker: a
        stale non-probe success (a dispatch that started before the
        trip, landing from another replica) must neither release the
        probe slot nor close the breaker — the probe owns the recovery
        decision."""
        with self._lock:
            if self._retired:
                return
            if probe:
                self._probing = False
                self._fails = 0
                if self._state != CLOSED:
                    self._step = 0
                    self._transition(CLOSED)
            elif self._state == CLOSED:
                self._fails = 0

    def on_failure(self, probe: bool = False) -> None:
        """Symmetrically: only a probe failure re-opens (with the NEXT
        backoff step — the no-flap rule); a stale non-probe failure
        landing while open/half-open is pre-trip evidence and is
        ignored instead of stealing the live probe's verdict."""
        with self._lock:
            if self._retired:
                return
            if probe:
                self._probing = False
                self._step += 1
                self.reopens += 1
                self._opened_at = self._clock()
                self._transition(OPEN)
                return
            if self._state == CLOSED:
                self._fails += 1
                if self._fails >= self.threshold:
                    self._step = 0
                    self.opens += 1
                    self._opened_at = self._clock()
                    self._transition(OPEN)

    def release(self, probe: bool = False) -> None:
        """End a dispatch whose error is not a breaker event
        (:func:`counts_toward_breaker` is false): the state and the
        counters stay as they were; a probe frees its slot, so the next
        batch probes again."""
        with self._lock:
            if probe and not self._retired:
                self._probing = False

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state, "opens": self.opens,
                    "reopens": self.reopens, "probes": self.probes,
                    "step": self._step, "version": self.version}


def counts_toward_breaker(err: BaseException) -> bool:
    """Whether a dispatch error moves the breaker: only the injected
    faults (``common/faults.py``: ``error`` raises
    :class:`~alink_tpu_torch.common.faults.TransientFault`, ``kill``
    :class:`~alink_tpu_torch.common.faults.FaultInjected`). Any other
    error is a fault of the serving path itself — a kernel that does not
    build or launch, a wrapper refusing its tensors — and must fail its
    batch loudly, never be served around through the host mapper."""
    return isinstance(err, (TransientFault, FaultInjected))


# -- shed / feeder-error recording ------------------------------------------

def record_shed(server: str, reason: str) -> None:
    """One shed request: ``alink_serve_shed_total{server=,reason=}`` +
    a ``serve.shed`` trace instant. ``reason`` is a small stable enum
    (``deadline`` | ``cancelled``) — it is a metric label."""
    if metrics_enabled():
        get_registry().inc("alink_serve_shed_total", 1,
                           {"server": server, "reason": reason})
    trace_instant("serve.shed", cat="serve",
                  args={"server": server, "reason": reason})


# feeder error kinds (metric label enum): ``poisoned`` = deterministic
# bad snapshot (skip), ``transient`` = retryable swap failure,
# ``fatal`` = retry budget exhausted / the stream itself died.
_POISONED_TYPES = (ValueError, TypeError, KeyError, IndexError)


def classify_feeder_error(err: BaseException) -> str:
    """``poisoned`` for deterministic data errors (corrupt payload JSON,
    geometry refusal — retrying cannot help, skip and keep the last
    good model) vs ``transient`` for everything else (backend blips,
    injected :class:`~alink_tpu_torch.common.faults.TransientFault` —
    retry with backoff)."""
    return "poisoned" if isinstance(err, _POISONED_TYPES) else "transient"


def record_feeder_error(feeder: str, kind: str, err: BaseException) -> None:
    """Make a failing feeder visible AT THE FAILURE, not only at the
    deferred ``join()`` re-raise: ``alink_serve_feeder_errors_total
    {feeder=,kind=}`` on every error, plus ONE RuntimeWarning per
    (feeder, kind) per process — a dying feeder shows mid-run."""
    from ..common.metrics import record_fallback_once
    record_fallback_once(
        "serve-feeder", "alink_serve_feeder_errors_total",
        {"feeder": feeder, "kind": kind},
        f"serving feeder {feeder} hit a {kind} error: "
        f"{type(err).__name__}: {err} (recorded as "
        f"alink_serve_feeder_errors_total{{feeder={feeder!r},"
        f"kind={kind!r}}}; this warning fires once per feeder+kind — "
        f"the error also re-raises at join() unless supervised away)")


def _reset_feeder_warnings() -> None:
    """Test hook: re-arm the once-per-(feeder, kind) warnings."""
    from ..common.metrics import reset_fallback_warnings
    reset_fallback_warnings("serve-feeder")
