"""Closed-loop load generator for the serving tier.

Counterpart: ``alink_tpu/serving/loadgen.py``, copied. Drives a
:class:`~alink_tpu_torch.serving.server.PredictServer` with ``clients``
concurrent closed-loop clients — each keeps at most ``pipeline``
requests outstanding and issues the next only when one completes, so
offered load self-regulates to the server's capacity (the closed-loop
contract; an open-loop generator would just measure its own queue).
Reports QPS plus p50/p99 of the full submit->response round trip.

``serial_qps`` is the baseline the micro-batcher is judged against:
single-request serial dispatch — one bucket-1 kernel launch per
request, strictly sequential, the reference's ``LocalPredictor.map``
call pattern.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Sequence, Tuple


def percentile(values: Sequence[float], pct: float) -> float:
    """Nearest-rank percentile (0.0 on an empty sample)."""
    if not values:
        return 0.0
    vals = sorted(values)
    k = max(0, min(len(vals) - 1,
                   int(round(pct / 100.0 * len(vals) + 0.5)) - 1))
    return vals[k]


@dataclass
class LoadReport:
    """One load phase: counts, wall, throughput and latency quantiles.
    ``timeouts`` is the subset of ``failures`` where the future never
    resolved within the reap timeout — the serving tier's SILENT-drop
    signal (a typed rejection resolves and is a non-timeout failure)."""
    requests: int
    failures: int
    wall_s: float
    latencies_s: List[float] = field(repr=False, default_factory=list)
    responses: List[Tuple] = field(repr=False, default_factory=list)
    timeouts: int = 0

    @property
    def qps(self) -> float:
        return self.requests / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def p50_s(self) -> float:
        return percentile(self.latencies_s, 50.0)

    @property
    def p99_s(self) -> float:
        return percentile(self.latencies_s, 99.0)

    def summary(self) -> dict:
        return {"requests": self.requests, "failures": self.failures,
                "qps": round(self.qps, 1),
                "p50_ms": round(self.p50_s * 1e3, 3),
                "p99_ms": round(self.p99_s * 1e3, 3)}


class LoadGenerator:
    """``LoadGenerator(server.submit, rows)(...)`` -> :class:`LoadReport`.

    ``submit`` must return a future with ``result(timeout)`` (the
    :class:`~alink_tpu_torch.serving.server.RequestFuture` contract).
    ``collect_responses`` keeps every response row (a hot-swap run
    validates them against the swapped model set — the torn-model
    detector), bounded only by the request count.
    """

    def __init__(self, submit: Callable, rows: Sequence[Tuple],
                 clients: int = 16, pipeline: int = 1,
                 timeout_s: float = 60.0,
                 collect_responses: bool = False):
        self.submit = submit
        self.rows = list(rows)
        self.clients = max(1, int(clients))
        self.pipeline = max(1, int(pipeline))
        self.timeout_s = float(timeout_s)
        self.collect_responses = collect_responses

    def run(self, requests: int) -> LoadReport:
        """Issue ``requests`` total requests across the closed-loop
        clients; returns when every response landed."""
        per_client = -(-requests // self.clients)
        lock = threading.Lock()
        latencies: List[float] = []
        responses: List[Tuple] = []
        failures = [0]
        timeouts = [0]

        def client(ci: int) -> None:
            from collections import deque
            row_i = ci % len(self.rows)
            pending: deque = deque()
            lat_local: List[float] = []
            resp_local: List[Tuple] = []
            fail_local = 0
            tmo_local = 0

            def reap(entry):
                nonlocal fail_local, tmo_local
                t0, fut = entry
                try:
                    out = fut.result(self.timeout_s)
                    lat_local.append(time.perf_counter() - t0)
                    if self.collect_responses:
                        resp_local.append(out)
                except TimeoutError:
                    # the future never resolved: a SILENT drop, kept
                    # distinct from typed rejections (the chaos runs'
                    # no-silent-drops accounting)
                    fail_local += 1
                    tmo_local += 1
                except BaseException:
                    fail_local += 1

            for _ in range(per_client):
                if len(pending) >= self.pipeline:
                    reap(pending.popleft())
                try:
                    fut = self.submit(self.rows[row_i])
                except BaseException:
                    fail_local += 1
                else:
                    pending.append((time.perf_counter(), fut))
                row_i = (row_i + 1) % len(self.rows)
            for entry in pending:
                reap(entry)
            with lock:
                latencies.extend(lat_local)
                responses.extend(resp_local)
                failures[0] += fail_local
                timeouts[0] += tmo_local

        threads = [threading.Thread(target=client, args=(i,), daemon=True,
                                    name=f"alink-loadgen-{i}")
                   for i in range(self.clients)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        return LoadReport(requests=per_client * self.clients,
                          failures=failures[0], wall_s=wall,
                          latencies_s=latencies, responses=responses,
                          timeouts=timeouts[0])


def serial_qps(predictor, rows: Sequence[Tuple],
               requests: int = 200) -> LoadReport:
    """The single-request serial-dispatch baseline: ``requests``
    strictly sequential ``predict_row`` round trips (one bucket-1
    kernel launch + fetch per request)."""
    rows = list(rows)
    latencies: List[float] = []
    t0 = time.perf_counter()
    for i in range(requests):
        r0 = time.perf_counter()
        predictor.predict_row(rows[i % len(rows)])
        latencies.append(time.perf_counter() - r0)
    wall = time.perf_counter() - t0
    return LoadReport(requests=requests, failures=0, wall_s=wall,
                      latencies_s=latencies)
