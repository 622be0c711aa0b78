"""PredictServer — request micro-batching over the compiled predictor.

Counterpart: ``alink_tpu/serving/server.py``. Concurrent single-row
requests coalesce into bucket-sized device batches:

* requests enter through the bounded channel
  (``operator/stream/prefetch.py::_Channel``); a full queue blocks
  submitters (backpressure) instead of growing latency unboundedly;
* ONE serving-loop thread drains the channel: a batch dispatches as soon
  as the queue drains, or when it reaches the top bucket. With
  ``ALINK_TPU_SERVE_MIN_FILL`` above 1 an under-filled batch waits up to
  ``ALINK_TPU_SERVE_WINDOW_MS`` for stragglers;
* each batch runs through :class:`~alink_tpu_torch.serving.predictor.
  CompiledPredictor` — one encode, one kernel launch per top-bucket
  chunk, one fetch — and the results fan back out through per-request
  futures;
* resilience (``serving/resilience.py``): ``submit(row, deadline_s=)``
  sheds a request whose queue wait already exceeds its budget with a
  typed ``DeadlineExceeded`` BEFORE the dispatch is paid, and a
  cancelled request with ``RequestCancelled``; a per-model-version
  ``CircuitBreaker`` routes batches to the host mapper (``_fallback``)
  after consecutive injected dispatch faults and re-probes the device
  path on a deterministic backoff. Any other dispatch error (a kernel
  that fails to build or launch, a wrapper's refusal) fails its own
  batch and leaves the breaker as it was
  (``resilience.counts_toward_breaker``). The loop runs under a
  supervisor that fails the requests of a crashed batch with
  ``ReplicaCrashed`` and respawns the loop. The fallback is counted
  (``fallback_batches``, ``alink_serve_breaker_fallback_total``) and an
  open breaker turns ``/healthz`` unhealthy;
* hot model swap delegates to the predictor's double-buffered slot flip
  on the caller's thread; the loop picks the new model up at its next
  dispatch. :class:`ModelStreamFeeder` taps a model-snapshot stream
  (``FtrlTrainStreamOp``'s output) and swaps per snapshot;
  :class:`DeviceWeightsFeeder` swaps the FTRL trainer's device weights
  without a host copy. Both are supervised (bounded retry, poisoned
  snapshots skipped, the last good model kept serving).

Observability: ``serve.request`` / ``serve.batch`` / ``serve.swap``
spans and the ``alink_serve_*`` series of the JAX package; with
``ALINK_TPU_ADMIN_PORT`` set, the server answers ``/healthz`` and
``/statusz`` for its lifetime.

Left out: replicas (``replicas`` other than 1 raises, ROADMAP A9) and
AOT admission warming (``warmed_programs`` stays 0, ROADMAP A10(b)).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional, Tuple

import torch

from ..common import reqtrace
from ..common.adminz import acquire_admin, release_admin
from ..common.faults import FaultInjected, TransientFault
from ..common.metrics import get_registry, metrics_enabled
from ..common.mtable import MTable
from ..common.tracing import trace_complete, trace_instant
from ..operator.stream.prefetch import _EMPTY, _SENTINEL, _Channel
from .loadgen import percentile as _percentile
from .predictor import (CompiledPredictor, serve_min_fill,
                        serve_queue_depth, serve_window_s)
from .resilience import (OPEN, CircuitBreaker, DeadlineExceeded,
                         ReplicaCrashed, RequestCancelled,
                         classify_feeder_error, counts_toward_breaker,
                         feeder_backoff_s, feeder_retries,
                         record_feeder_error, record_shed,
                         serve_breaker_enabled)

_P99_RING = 4096        # rolling latency window behind the p99 gauge
_P99_EVERY = 128        # gauge refresh cadence (requests)


class RequestFuture:
    """One in-flight request: the submitter blocks on :meth:`result`;
    the serving loop delivers via :meth:`set_result`/``set_exception``.

    **Cancellation / deadline semantics.** A ``result(timeout=)`` that
    raises ``TimeoutError`` does NOT remove the request — it stays live
    in the queue, is still dispatched, and its answer lands in this
    future. To bound the *server's* work, pass ``deadline_s=`` to
    ``submit()`` (the serving loop sheds the request with a typed
    :class:`~alink_tpu_torch.serving.resilience.DeadlineExceeded` BEFORE
    paying the dispatch once its queue wait exceeds the budget) or call
    :meth:`cancel` (best-effort: the loop sheds a cancelled request it
    has not dispatched yet with :class:`~alink_tpu_torch.serving.
    resilience.RequestCancelled`)."""

    __slots__ = ("row", "_event", "_value", "_error", "submitted_at",
                 "deadline_s", "_cancelled", "ctx")

    def __init__(self, row: Tuple, deadline_s: Optional[float] = None):
        self.row = row
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self.submitted_at = time.perf_counter()
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self._cancelled = False
        # request-scoped timeline — None while the layer is off; every
        # consumer tolerates that
        self.ctx: Optional[reqtrace.RequestContext] = None

    def set_result(self, value) -> None:
        self._value = value
        self._event.set()

    def set_exception(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def cancel(self) -> bool:
        """Best-effort cancel: mark the request so the serving loop
        sheds it before dispatch. Returns ``False`` when the result (or
        a typed rejection) already landed; ``True`` marks it — but a
        dispatch already in flight may still deliver a result."""
        if self._event.is_set():
            return False
        self._cancelled = True
        return True

    def cancelled(self) -> bool:
        return self._cancelled

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                "serving request timed out (the request is STILL live — "
                "pass deadline_s= to submit() or call cancel() to bound "
                "the server's work, not just the wait)")
        if self._error is not None:
            raise self._error
        return self._value


class PredictServer:
    """Micro-batching serving front end over a :class:`CompiledPredictor`.

    ``max_batch`` defaults to the predictor's top bucket; ``window_s``,
    ``queue_depth`` and ``min_fill`` default to their
    ``ALINK_TPU_SERVE_*`` flags. ``replicas`` other than 1 raises
    ``NotImplementedError``: the port serves one loop on one card.
    """

    def __init__(self, predictor: CompiledPredictor,
                 max_batch: Optional[int] = None,
                 window_s: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 min_fill: Optional[int] = None,
                 replicas: Optional[int] = None,
                 name: str = "serve"):
        if replicas not in (None, 1):
            raise NotImplementedError(
                f"replicas={replicas}: the port serves one loop on one "
                f"device; replicas wait for the multi-GPU slice")
        self.predictor = predictor
        self.name = name
        self.replicas = 1
        self.max_batch = int(max_batch) if max_batch \
            else predictor.buckets[-1]
        self.window_s = serve_window_s() if window_s is None \
            else float(window_s)
        self.min_fill = serve_min_fill() if min_fill is None \
            else max(1, int(min_fill))
        depth = serve_queue_depth() if queue_depth is None \
            else int(queue_depth)
        self._ch = _Channel(max(1, depth), gauge_label=name)
        self._closed = threading.Event()
        self._stats_lock = threading.Lock()
        self._requests = 0
        self._failed = 0
        self._batches = 0
        self._occupancy_sum = 0.0
        self._latencies: deque = deque(maxlen=_P99_RING)
        self._shed = 0                 # deadline/cancel rejections
        self._fallback_batches = 0     # breaker-routed host-mapper serves
        self._respawns = 0             # supervised loop restarts
        self._quarantined = 0          # requests typed-failed by a crash
        self._breaker_lock = threading.Lock()
        self._breakers: dict = {}      # model version -> CircuitBreaker
        # cumulative opens/reopens/probes across ALL model versions (a
        # hot-swap storm retires breakers; the run's totals must not)
        self._breaker_totals = {"opens": 0, "reopens": 0, "probes": 0}
        self.warmed_programs = 0       # no AOT cache in the port
        self._thread = threading.Thread(target=self._run_replica,
                                        args=(0,), daemon=True,
                                        name=f"alink-serve-{name}")
        self._thread.start()
        # live operations plane: while ALINK_TPU_ADMIN_PORT is armed,
        # this server's breaker/admission state answers /healthz for
        # its lifetime (an open breaker = unhealthy AND unready)
        self._admin = acquire_admin(name)
        if self._admin is not None:
            self._admin.add_source(f"serve:{name}", self._readiness)
            self._admin.add_status(f"serve:{name}", self.stats)

    # -- submission (any thread) ----------------------------------------
    def submit(self, row: Tuple,
               deadline_s: Optional[float] = None) -> RequestFuture:
        """Enqueue one request row; blocks when the admission queue is
        full (backpressure). Raises after :meth:`close`.

        ``deadline_s`` is an END-TO-END budget stamped at admission: a
        request whose queue wait already exceeds it is SHED by the
        serving loop before the dispatch is paid — the future resolves
        to a typed :class:`~alink_tpu_torch.serving.resilience.
        DeadlineExceeded`, and the device never sees the row (counted
        in ``alink_serve_shed_total{reason="deadline"}``)."""
        if self._closed.is_set():
            raise RuntimeError(f"PredictServer {self.name!r} is closed")
        fut = RequestFuture(tuple(row), deadline_s=deadline_s)
        fut.ctx = reqtrace.admit()
        if not self._ch.put(fut):
            reqtrace.finish(fut.ctx, outcome="rejected_closed")
            raise RuntimeError(f"PredictServer {self.name!r} is closed")
        return fut

    def predict(self, row: Tuple, timeout: Optional[float] = None,
                deadline_s: Optional[float] = None) -> Tuple:
        """Synchronous single-request round trip."""
        return self.submit(row, deadline_s=deadline_s).result(timeout)

    def swap_model(self, model_table: MTable) -> int:
        """Hot-swap the served model (double-buffered; see predictor)."""
        return self.predictor.swap_model(model_table)

    # -- the serving loop (supervised) ------------------------------------
    def _run_replica(self, replica: int) -> None:
        """Supervisor: run the serving loop; when it CRASHES (an escape
        past :meth:`_serve`'s handling — e.g. an injected ``kill`` at
        ``serve.dispatch`` or a ``prefetch.get`` fault), quarantine the
        in-flight batch (every unresolved request fails with a typed
        :class:`~alink_tpu_torch.serving.resilience.ReplicaCrashed` —
        never silence) and RESPAWN the loop. A respawned loop after
        :meth:`close` sees the channel sentinel and exits cleanly."""
        backoff = 0.01
        while True:
            inflight: List[RequestFuture] = []
            try:
                self._loop(inflight)
                return
            except BaseException as e:
                # BaseException for the QUARANTINE (an interrupt must
                # not strand in-flight futures in silence) — but only
                # Exception respawns; KeyboardInterrupt / SystemExit
                # propagate after the quarantine
                quarantined = [f for f in inflight if not f.done()]
                for f in quarantined:
                    f.set_exception(ReplicaCrashed(replica, e))
                    reqtrace.finish(f.ctx, outcome="replica_crashed")
                with self._stats_lock:
                    self._failed += len(quarantined)
                    self._quarantined += len(quarantined)
                    self._respawns += 1
                trace_instant("serve.respawn", cat="serve",
                              args={"server": self.name, "replica": replica,
                                    "quarantined": len(quarantined),
                                    "error": type(e).__name__})
                if metrics_enabled():
                    get_registry().inc("alink_serve_loop_respawns_total", 1,
                                       {"server": self.name})
                if not isinstance(e, Exception):
                    raise
                time.sleep(backoff)
                backoff = min(0.5, backoff * 2)

    def _loop(self, inflight: List[RequestFuture]) -> None:
        while True:
            del inflight[:]
            first = self._ch.get()
            if first is _SENTINEL:
                return
            inflight.append(first)
            if first.ctx is not None:
                first.ctx.mark("dequeue")
            deadline = None
            closing = False
            while len(inflight) < self.max_batch:
                got = self._ch.drain(self.max_batch - len(inflight))
                if got:
                    inflight.extend(got)
                    for f in got:
                        if f.ctx is not None:
                            f.ctx.mark("dequeue")
                    continue
                # queue drained: dispatch NOW unless the batch is under
                # min_fill and latency budget remains
                if len(inflight) >= self.min_fill:
                    break
                if deadline is None:
                    deadline = time.monotonic() + self.window_s
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                nxt = self._ch.get(timeout=remaining)
                if nxt is _EMPTY:
                    break
                if nxt is _SENTINEL:
                    closing = True
                    break
                inflight.append(nxt)
                if nxt.ctx is not None:
                    nxt.ctx.mark("dequeue")
            self._serve(inflight)
            if closing:
                return

    # -- deadline / cancellation shedding ---------------------------------
    def _admit(self, batch: List[RequestFuture],
               now: float) -> List[RequestFuture]:
        """Shed requests whose queue wait already exceeds their deadline
        (or that the submitter cancelled) BEFORE the dispatch is paid:
        the typed rejection lands through the future, the device never
        sees the row."""
        kept: List[RequestFuture] = []
        for fut in batch:
            if fut.cancelled():
                fut.set_exception(RequestCancelled(
                    "request cancelled before dispatch"))
                self._record_shed("cancelled")
                reqtrace.finish(fut.ctx, outcome="shed_cancelled")
                continue
            dl = fut.deadline_s
            if dl is not None:
                waited = now - fut.submitted_at
                if waited > dl:
                    fut.set_exception(DeadlineExceeded(waited, dl))
                    self._record_shed("deadline")
                    reqtrace.finish(fut.ctx, outcome="shed_deadline")
                    continue
            kept.append(fut)
        return kept

    def _record_shed(self, reason: str) -> None:
        with self._stats_lock:
            self._shed += 1
        record_shed(self.name, reason)

    # -- circuit-broken dispatch ------------------------------------------
    def _breaker_for(self, version: int) -> CircuitBreaker:
        """The ACTIVE model version's breaker (a hot swap starts the new
        version closed). Old versions' breakers are retired and their
        counts kept in the run's totals."""
        with self._breaker_lock:
            br = self._breakers.get(version)
            if br is None:
                for old in self._breakers.values():   # retire, keep totals
                    old.retire()    # a stale in-flight verdict must not
                                    # move the gauge or post-snapshot
                                    # counters (frozen from here on)
                    s = old.snapshot()
                    for k in self._breaker_totals:
                        self._breaker_totals[k] += s[k]
                br = CircuitBreaker(self.name, version)
                self._breakers = {version: br}
            return br

    def breaker_stats(self) -> dict:
        """state/step of the ACTIVE version's breaker plus cumulative
        opens/reopens/probes across every version this server served
        (zeros when the breaker never engaged)."""
        with self._breaker_lock:
            brs = list(self._breakers.values())
            totals = dict(self._breaker_totals)
        if not brs:
            return {"state": "closed", "step": 0, "version": None,
                    **totals}
        snap = brs[-1].snapshot()
        for k in totals:
            snap[k] = snap[k] + totals[k]
        return snap

    def _serve(self, batch: List[RequestFuture]) -> None:
        batch = self._admit(batch, time.perf_counter())
        if not batch:
            return
        # the batch is assembled: the window hold / micro-batch
        # coalescing ends here, dispatch work begins
        ctxs = [f.ctx for f in batch if f.ctx is not None]
        for c in ctxs:
            c.mark("coalesce")
        done_t = None
        route, br, settled = "compiled", None, False
        if serve_breaker_enabled():
            br = self._breaker_for(self.predictor.model_version)
            route = br.acquire()

        def _settle_failure(err: BaseException) -> None:
            # an escape (injected kill, kernel or encode error, fan-out
            # error) past the paired on_success/on_failure MUST still
            # end the breaker slot: a leaked half-open probe would wedge
            # the breaker in fallback forever. Only an injected fault
            # counts as a failure; any other error releases the slot
            nonlocal settled
            if br is not None and route != "fallback" and not settled:
                settled = True
                if counts_toward_breaker(err):
                    br.on_failure(probe=(route == "probe"))
                else:
                    br.release(probe=(route == "probe"))
        try:
            data = MTable([f.row for f in batch],
                          self.predictor.data_schema)
            if route == "fallback":
                out = self._fallback(data)
            else:
                try:
                    with reqtrace.batch_scope(ctxs):
                        out = self.predictor.predict_table(data)
                    if br is not None:
                        settled = True
                        br.on_success(probe=(route == "probe"))
                except TransientFault:
                    # the injected transient failure, the one error the
                    # breaker counts (the injected kill escapes to the
                    # loop supervisor, which quarantines and respawns;
                    # every other error fails the batch below)
                    if br is None:
                        raise
                    settled = True
                    br.on_failure(probe=(route == "probe"))
                    if route == "probe":
                        # degraded traffic stays degraded on a failed
                        # probe — the batch serves through the host
                        # mapper instead of paying for the re-test
                        out = self._fallback(data)
                    else:
                        raise   # closed-state failure: the batch fails
                                # its own requests while the breaker
                                # counts
            # fan-out: pull the output columns once, hand each future
            # its row tuple
            cols = [out.col(nm) for nm in out.col_names]
            done_t = time.perf_counter()
            for i, fut in enumerate(batch):
                fut.set_result(tuple(c[i] for c in cols))
        except FaultInjected as e:
            _settle_failure(e)
            raise
        except BaseException as e:
            _settle_failure(e)
            done_t = done_t or time.perf_counter()
            for fut in batch:
                if not fut.done():
                    fut.set_exception(e)
            with self._stats_lock:
                self._failed += len(batch)
        self._account(batch, done_t)

    def _fallback(self, data: MTable) -> MTable:
        """Breaker-open degradation: the batch serves through the HOST
        mapper path (the active model applied off the device) —
        degraded throughput, correct answers, zero dropped requests;
        counted, never silent."""
        out = self.predictor.host_reference(data)
        with self._stats_lock:
            self._fallback_batches += 1
        if metrics_enabled():
            get_registry().inc("alink_serve_breaker_fallback_total", 1,
                               {"server": self.name})
        return out

    def _account(self, batch: List[RequestFuture], done_t: float) -> None:
        n = len(batch)
        occupancy = n / self.predictor.bucket_for(n)
        lats = [done_t - f.submitted_at for f in batch]
        with self._stats_lock:
            self._requests += n
            self._batches += 1
            self._occupancy_sum += occupancy
            self._latencies.extend(lats)
            refresh = self._requests % _P99_EVERY < n
            p99 = _percentile(list(self._latencies), 99.0) if refresh else None
        rec = metrics_enabled()
        reg = get_registry() if rec else None
        lbl = {"server": self.name}
        for fut, dt in zip(batch, lats):
            ctx = fut.ctx
            if ctx is None:
                trace_complete("serve.request", dt, cat="serve",
                               args={"batch_rows": n})
                continue
            # the admission->dispatch queue wait ends at the coalesce
            # mark (batch assembled, dispatch work starting)
            qwait = ctx.phase_end("coalesce")
            outcome = ("ok" if fut._error is None
                       else type(fut._error).__name__)
            reqtrace.finish(ctx, outcome=outcome)
            if rec:
                # the exemplar links the p99 bucket to THIS request's
                # timeline (one bounded slot per bucket)
                ex = {"trace_id": ctx.trace_id}
                if ctx.tenant is not None:
                    ex["tenant"] = ctx.tenant
                reg.observe("alink_serve_request_seconds", dt, lbl,
                            exemplar=ex)
                if qwait is not None:
                    reg.observe("alink_serve_queue_wait_seconds", qwait,
                                lbl, exemplar=ex)
        if rec:
            reg.inc("alink_serve_requests_total", n, lbl)
            reg.set_gauge("alink_serve_queue_depth", self._ch.depth(), lbl)
            if p99 is not None:
                reg.set_gauge("alink_serve_p99_seconds", p99, lbl)
                self.predictor.flush_metrics()

    # -- stats / shutdown -------------------------------------------------
    def _readiness(self) -> dict:
        """ReadinessSource for the admin plane: healthy/ready while the
        server admits requests AND the active model version's breaker
        is not OPEN — an open breaker means requests are answered by the
        host-mapper fallback (or typed-failed), which an operator must
        see as 503 on /healthz while it lasts."""
        admitting = not self._closed.is_set()
        breaker = self.breaker_stats()
        ok = admitting and breaker.get("state") != OPEN
        return {"ready": ok, "healthy": ok,
                "admission_open": admitting,
                "breaker": breaker,
                "queue_depth": self._ch.depth(),
                "model_version": self.predictor.model_version}

    def stats(self) -> dict:
        """A point-in-time snapshot: request/batch counts, mean batch
        occupancy, rolling p50/p99, bucket hit rate, plus the resilience
        counters (shed, breaker fallbacks, loop respawns)."""
        with self._stats_lock:
            lats = list(self._latencies)
            requests, failed = self._requests, self._failed
            batches, occ = self._batches, self._occupancy_sum
            shed, fb = self._shed, self._fallback_batches
            respawns, quarantined = self._respawns, self._quarantined
        cache = self.predictor.cache_stats()
        looked = cache["hits"] + cache["misses"]
        return {
            "requests": requests, "failed": failed, "batches": batches,
            "mean_batch_rows": (requests / batches) if batches else 0.0,
            "mean_occupancy": (occ / batches) if batches else 0.0,
            "p50_s": _percentile(lats, 50.0),
            "p99_s": _percentile(lats, 99.0),
            "bucket_hit_rate": (cache["hits"] / looked) if looked else 0.0,
            "programs": cache["programs"],
            "model_version": self.predictor.model_version,
            "queue_depth": self._ch.depth(),
            "shed": shed, "fallback_batches": fb,
            "loop_respawns": respawns, "quarantined": quarantined,
            "warmed_programs": self.warmed_programs,
            "breaker": self.breaker_stats(),
        }

    def close(self, timeout: float = 10.0) -> None:
        """Stop admitting, drain queued requests, join the loop."""
        if self._closed.is_set():
            return
        self._closed.set()
        if self._admin is not None:
            self._admin.remove_source(f"serve:{self.name}")
            self._admin.remove_status(f"serve:{self.name}")
            self._admin = None
            release_admin()
        self._ch.close()
        self._thread.join(timeout)

    def __enter__(self) -> "PredictServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _FeederSupervision:
    """The shared feeder supervision policy: bounded retry + doubling
    backoff for TRANSIENT swap failures, skip-and-record for POISONED
    snapshots (corrupt payload, geometry refusal — deterministic,
    retrying cannot help), and the last-good-model guarantee — a swap
    that never succeeds never flips the active version, so the server
    keeps serving the previous model, never a torn or absent one. Every
    error is visible AT THE FAILURE (``alink_serve_feeder_errors_total``
    + one RuntimeWarning per feeder+kind), not only at ``join()``.

    It also owns the feeder's thread: a subclass gives the drain body
    (``_drain``) and drives it with :meth:`run` on the caller's thread
    or :meth:`start` / :meth:`join` on its own."""

    #: set by subclasses for metric labels / warnings / the thread name
    feeder_kind = "feeder"
    thread_name = "alink-serve-feeder"

    def __init__(self, server: PredictServer, limit: Optional[int],
                 on_swap: Optional[Callable]):
        self.server = server
        self.limit = limit
        self.on_swap = on_swap
        self.versions: list = []
        self.error: Optional[BaseException] = None
        self.retried = 0         # transient retries spent
        self.skipped = 0         # poisoned snapshots skipped
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=self.thread_name)

    def _drain(self) -> None:
        raise NotImplementedError

    def _run(self) -> None:
        try:
            self._drain()
        except BaseException as e:   # surfaced via join() AND recorded now
            self.error = e
            if not getattr(e, "_alink_feeder_recorded", False):
                record_feeder_error(self.feeder_kind, "fatal", e)

    def start(self):
        self._thread.start()
        return self

    def run(self) -> int:
        """Drain synchronously on the caller's thread; returns the swap
        count (raises the drain's error)."""
        self._run()
        if self.error is not None:
            raise self.error
        return len(self.versions)

    def join(self, timeout: Optional[float] = None) -> int:
        """Wait for the drain to end; returns the swap count. Raises the
        feeder thread's error, if any — and refuses to return a PARTIAL
        count: a feeder still swapping past the timeout would silently
        invalidate any caller that snapshots ``versions``."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(
                f"{self.feeder_kind} still draining after {timeout}s "
                f"({len(self.versions)} swaps so far); the stream has not "
                f"ended — the swap count and version set are incomplete")
        if self.error is not None:
            raise self.error
        return len(self.versions)

    def _supervised_swap(self, swap: Callable[[], int]) -> Optional[int]:
        """Run one swap attempt under supervision; returns the new
        version, or ``None`` when the snapshot was skipped (poisoned)
        — the caller moves on to the next snapshot with the last good
        model still serving. An exhausted retry budget raises."""
        budget = feeder_retries()
        backoff = feeder_backoff_s()
        attempt = 0
        while True:
            try:
                return swap()
            except FaultInjected:
                raise            # the injected process kill passes through
            except Exception as e:
                # Exception, NOT BaseException: a KeyboardInterrupt /
                # SystemExit must propagate immediately
                kind = classify_feeder_error(e)
                record_feeder_error(self.feeder_kind, kind, e)
                if kind == "poisoned":
                    self.skipped += 1
                    return None
                attempt += 1
                if attempt > budget:
                    raise        # the run loop records this as "fatal"
                self.retried += 1
                if metrics_enabled():
                    get_registry().inc(
                        "alink_serve_feeder_retries_total", 1,
                        {"feeder": self.feeder_kind})
                time.sleep(backoff)
                backoff *= 2


class ModelStreamFeeder(_FeederSupervision):
    """Tap a model-snapshot stream into a server's hot-swap path.

    Drains ``stream_op.timed_batches()`` on a background thread and
    calls ``server.swap_model`` per snapshot — the serving-tier end of
    the FTRL trainer's model stream. Keeps every swapped model table
    (``versions``, ``(version, table)`` pairs) so a caller can
    re-validate responses against the exact model set that was ever
    active. Swaps run SUPERVISED (:class:`_FeederSupervision`). A
    stream-side error ends the feeder and is recorded at the failure;
    ``join()`` re-raises it."""

    feeder_kind = "ModelStreamFeeder"

    def __init__(self, server: PredictServer, stream_op,
                 limit: Optional[int] = None,
                 on_swap: Optional[Callable[[int, MTable], None]] = None):
        self.stream_op = stream_op
        super().__init__(server, limit, on_swap)

    def _drain(self) -> None:
        for _t, model_table in self.stream_op.timed_batches():
            version = self._supervised_swap(
                lambda: self.server.swap_model(model_table))
            if version is None:
                continue     # poisoned snapshot skipped; last good
                             # model keeps serving
            self.versions.append((version, model_table))
            trace_instant("serve.model_stream", cat="serve",
                          args={"version": version})
            if self.on_swap is not None:
                self.on_swap(version, model_table)
            if self.limit is not None and len(self.versions) >= self.limit:
                return


class DeviceWeightsFeeder(_FeederSupervision):
    """Device-to-device model swaps off the FTRL trainer's (z, n) state.

    :class:`ModelStreamFeeder` round-trips every snapshot through a host
    model table — the trainer fetches its device weights to the host,
    builds rows, and ``swap_model`` copies them back to the device. This
    feeder removes the round trip: it registers itself as the trainer's
    ``set_device_snapshot_consumer`` hook, receives the LIVE device
    weight vector at each emission boundary, slices and zero-pads it to
    the active serving kernel's geometry WITH DEVICE OPS ONLY (no host
    copy), and installs it through ``CompiledPredictor.swap_weights``.
    The served scores equal the host-table path's — both serve the same
    weight values through the same kernels.

    The trainer must serve the SAME geometry the predictor was built
    with (the warm-start model) and ship the predictor's dtype: a
    layout the feeder cannot map refuses loudly. Drive the drain with
    :meth:`run` or :meth:`start` / :meth:`join` (the hook consumes
    every snapshot, so the stream yields nothing — iterating it IS the
    training loop). ``versions`` holds the swapped version numbers."""

    feeder_kind = "DeviceWeightsFeeder"
    thread_name = "alink-serve-devfeeder"

    def __init__(self, server: PredictServer, ftrl_op,
                 limit: Optional[int] = None,
                 on_swap: Optional[Callable[[int], None]] = None):
        self.ftrl_op = ftrl_op
        super().__init__(server, limit, on_swap)
        ftrl_op.set_device_snapshot_consumer(self._consume)

    # -- the trainer-side hook (runs on the draining thread) -------------
    def _consume(self, w_full: torch.Tensor, info: dict) -> bool:
        if self.limit is not None and len(self.versions) >= self.limit:
            return False           # past the cap: host path resumes
        wf8_len = int(self.server.predictor.model_arrays[0].shape[0])
        dim, fb_S = int(info["dim"]), info.get("fb_S")
        # the trainer's snapshot() layout logic, as device slices
        if info.get("has_intercept"):
            b = w_full[0].clone()
            feats = (w_full[1:dim] if fb_S is None
                     else w_full[fb_S:fb_S + dim - 1])
        else:
            b = torch.zeros((), dtype=w_full.dtype, device=w_full.device)
            feats = w_full[:dim]
        if int(feats.shape[0]) > wf8_len:
            # the documented loud refusal: a trainer wider than the
            # serving kernel's weight slot is a wiring bug, not a
            # per-snapshot poison — recorded once here, then raised
            err = ValueError(
                f"DeviceWeightsFeeder geometry mismatch: trainer emits "
                f"{int(feats.shape[0])} feature weights, the active "
                f"serving kernel holds {wf8_len} — a different geometry "
                f"must go through swap_model")
            record_feeder_error(self.feeder_kind, "fatal", err)
            err._alink_feeder_recorded = True   # _run must not record
            raise err                           # the SAME event twice
        wf8 = torch.zeros(wf8_len, dtype=w_full.dtype, device=w_full.device)
        wf8[:feats.shape[0]] = feats
        version = self._supervised_swap(
            lambda: self.server.predictor.swap_weights((wf8, b)))
        if version is None:
            return True    # poisoned swap skipped (recorded); the last
                           # good model keeps serving
        self.versions.append(version)
        trace_instant("serve.model_stream", cat="serve",
                      args={"version": version, "path": "device"})
        if self.on_swap is not None:
            self.on_swap(version)
        return True

    def _drain(self) -> None:
        # the hook consumes every emission, so this loop only DRIVES
        # training; nothing crosses to the host
        for _ in self.ftrl_op.timed_batches():
            pass
