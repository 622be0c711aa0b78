"""PredictServer — request micro-batching over the compiled predictor.

Counterpart: ``alink_tpu/serving/server.py`` (its core). Concurrent
single-row requests coalesce into bucket-sized device batches:

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
* hot model swap delegates to the predictor's double-buffered slot flip
  on the caller's thread; the loop picks the new model up at its next
  dispatch.

Left out for later slices: circuit breakers, deadlines and shedding,
the loop supervisor, model feeders, replicas, the admin plane, request
tracing and metrics.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

from ..common.mtable import MTable
from ..operator.stream.prefetch import _EMPTY, _SENTINEL, _Channel
from .predictor import (CompiledPredictor, serve_min_fill,
                        serve_queue_depth, serve_window_s)


class RequestFuture:
    """One in-flight request: the submitter blocks on :meth:`result`;
    the serving loop delivers via :meth:`set_result`/``set_exception``.
    A ``result(timeout=)`` that raises ``TimeoutError`` does not remove
    the request: it is still dispatched and its answer still lands."""

    __slots__ = ("row", "_event", "_value", "_error", "submitted_at")

    def __init__(self, row: Tuple):
        self.row = row
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self.submitted_at = time.perf_counter()

    def set_result(self, value) -> None:
        self._value = value
        self._event.set()

    def set_exception(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("serving request timed out (the request is "
                               "still live)")
        if self._error is not None:
            raise self._error
        return self._value


class PredictServer:
    """Micro-batching serving front end over a :class:`CompiledPredictor`.

    ``max_batch`` defaults to the predictor's top bucket; ``window_s``,
    ``queue_depth`` and ``min_fill`` default to their
    ``ALINK_TPU_SERVE_*`` flags.
    """

    def __init__(self, predictor: CompiledPredictor,
                 max_batch: Optional[int] = None,
                 window_s: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 min_fill: Optional[int] = None,
                 name: str = "serve"):
        self.predictor = predictor
        self.name = name
        self.max_batch = int(max_batch) if max_batch \
            else predictor.buckets[-1]
        self.window_s = serve_window_s() if window_s is None \
            else float(window_s)
        self.min_fill = serve_min_fill() if min_fill is None \
            else max(1, int(min_fill))
        depth = serve_queue_depth() if queue_depth is None \
            else int(queue_depth)
        self._ch = _Channel(max(1, depth))
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"alink-serve-{name}")
        self._thread.start()

    # -- submission (any thread) ----------------------------------------
    def submit(self, row: Tuple) -> RequestFuture:
        """Enqueue one request row; blocks when the admission queue is
        full (backpressure). Raises after :meth:`close`."""
        if self._closed.is_set():
            raise RuntimeError(f"PredictServer {self.name!r} is closed")
        fut = RequestFuture(tuple(row))
        if not self._ch.put(fut):
            raise RuntimeError(f"PredictServer {self.name!r} is closed")
        return fut

    def predict(self, row: Tuple, timeout: Optional[float] = None) -> Tuple:
        """Synchronous single-request round trip."""
        return self.submit(row).result(timeout)

    def swap_model(self, model_table: MTable) -> int:
        """Hot-swap the served model (double-buffered; see predictor)."""
        return self.predictor.swap_model(model_table)

    # -- the serving loop -------------------------------------------------
    def _loop(self) -> None:
        while True:
            first = self._ch.get()
            if first is _SENTINEL:
                return
            batch: List[RequestFuture] = [first]
            deadline = None
            closing = False
            while len(batch) < self.max_batch:
                got = self._ch.drain(self.max_batch - len(batch))
                if got:
                    batch.extend(got)
                    continue
                # queue drained: dispatch NOW unless the batch is under
                # min_fill and latency budget remains
                if len(batch) >= self.min_fill:
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
                batch.append(nxt)
            self._serve(batch)
            if closing:
                return

    def _serve(self, batch: List[RequestFuture]) -> None:
        try:
            data = MTable([f.row for f in batch],
                          self.predictor.data_schema)
            out = self.predictor.predict_table(data)
            # pull the output columns once, hand each future its row
            cols = [out.col(nm) for nm in out.col_names]
            for i, fut in enumerate(batch):
                fut.set_result(tuple(c[i] for c in cols))
        except Exception as e:   # the batch fails its own requests; the
            for fut in batch:    # loop keeps serving the next batch
                if not fut.done():
                    fut.set_exception(e)

    # -- shutdown -----------------------------------------------------------
    def close(self, timeout: float = 10.0) -> None:
        """Stop admitting, drain queued requests, join the loop."""
        if self._closed.is_set():
            return
        self._closed.set()
        self._ch.close()
        self._thread.join(timeout)

    def __enter__(self) -> "PredictServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
