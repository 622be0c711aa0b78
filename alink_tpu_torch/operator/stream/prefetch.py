"""The bounded, stop-aware channel, the one-thread run-ahead and the
ordered worker pool.

Counterpart: ``alink_tpu/operator/stream/prefetch.py``. Ported:
``_Channel`` with its two markers (:class:`~alink_tpu_torch.serving.
server.PredictServer`'s admission queue, and the channel under
:func:`prefetch`), :func:`prefetch`, which ``StreamOperator.execute``
and the FTRL trainer's drain use, and :func:`prefetch_map`, the ordered
pool that the sharded file reads and the native parser's chunks run on.
Left out: ``stream_workers`` (``ALINK_TPU_STREAM_WORKERS``), the width
the JAX package's FTRL drain takes from the environment (the port's
drain does not run on the pool, and its callers pass a width), the
depth knob (the depth is fixed at ``PREFETCH_DEPTH``) and the depth
gauge. ``_Channel.get`` is the ``prefetch.get`` fault site
(``common/faults.py``), as in the JAX package.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Iterable, Iterator, Optional, TypeVar

from ...common.faults import maybe_crash

T = TypeVar("T")
U = TypeVar("U")

_SENTINEL = object()
# timed-get miss marker (serving micro-batcher): distinct from the
# end-of-stream sentinel so "nothing arrived within the latency budget"
# and "the stream is over" stay distinguishable
_EMPTY = object()


class _Channel:
    """Bounded FIFO channel with close-aware blocking.

    ``put`` blocks while the channel is full and wakes when it is
    closed; ``get`` blocks until an item or the sentinel arrives. One
    lock + two conditions; unbounded when ``maxsize <= 0``. With a
    ``gauge_label`` every change of depth sets the
    ``alink_prefetch_depth{consumer=}`` gauge (metrics on)."""

    def __init__(self, maxsize: int, gauge_label: Optional[str] = None):
        self._buf: deque = deque()
        self._maxsize = maxsize
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self._stopped = False
        self._gauge_label = gauge_label

    def _gauge(self, depth: int) -> None:
        if self._gauge_label is None:
            return
        from ...common.metrics import get_registry, metrics_enabled
        if metrics_enabled():
            get_registry().set_gauge("alink_prefetch_depth", depth,
                                     {"consumer": self._gauge_label})

    def put(self, item) -> bool:
        """Enqueue; False when the consumer has stopped or the channel
        is already closed (a producer racing ``close()`` must not
        strand an item no getter will ever see — the serving tier's
        submit-vs-shutdown race)."""
        with self._not_full:
            while not self._closed and not self._stopped \
                    and self._maxsize > 0 \
                    and len(self._buf) >= self._maxsize:
                self._not_full.wait()
            if self._closed or self._stopped:
                return False
            self._buf.append(item)
            self._gauge(len(self._buf))
            self._not_empty.notify()
            return True

    def get(self, timeout: Optional[float] = None):
        """Dequeue one item; blocks until an item, close
        (``_SENTINEL``) or — when ``timeout`` is given — the deadline
        (``_EMPTY``). ``timeout=0`` polls without blocking."""
        # deterministic fault site: every consumer (stream drains and the
        # serving micro-batcher) pulls through here. Unarmed cost: one
        # os.environ probe
        maybe_crash("prefetch.get")
        deadline = None if timeout is None \
            else time.monotonic() + max(0.0, timeout)
        with self._not_empty:
            while not self._buf:
                if self._closed or self._stopped:
                    return _SENTINEL
                if deadline is None:
                    self._not_empty.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return _EMPTY
                self._not_empty.wait(remaining)
            item = self._buf.popleft()
            self._gauge(len(self._buf))
            self._not_full.notify()
            return item

    def depth(self) -> int:
        """Items currently buffered (the admission-control reading the
        serving tier exports as ``alink_serve_queue_depth``)."""
        with self._lock:
            return len(self._buf)

    def drain(self, max_items: int) -> list:
        """Pop up to ``max_items`` buffered items under ONE lock
        acquisition (never blocks; [] when empty) — the micro-batcher's
        bulk path."""
        with self._lock:
            k = min(int(max_items), len(self._buf))
            if k <= 0:
                return []
            items = [self._buf.popleft() for _ in range(k)]
            self._gauge(len(self._buf))
            self._not_full.notify_all()
            return items

    def close(self) -> None:
        """Producer end-of-stream: buffered items still DRAIN to getters;
        once empty, every get() returns the sentinel."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()   # blocked producers must re-check

    def stop(self) -> None:
        """Consumer abandonment: wake every blocked producer and
        consumer at once and discard buffered items."""
        with self._lock:
            self._stopped = True
            self._buf.clear()
            self._gauge(0)
            self._not_full.notify_all()
            self._not_empty.notify_all()


PREFETCH_DEPTH = 2


def prefetch(it: Iterable[T]) -> Iterator[T]:
    """Iterate ``it`` in one background thread, ``PREFETCH_DEPTH`` items
    ahead.

    Order is kept exactly; the bound is the backpressure (the thread
    blocks while the consumer is behind); an exception of the upstream
    iterator re-raises at the consumer where its item would have come.
    A consumer that stops early (or raises) stops the thread, which
    closes the upstream iterator."""
    ch = _Channel(PREFETCH_DEPTH)
    err: list = []

    def worker():
        try:
            for item in it:
                if not ch.put((item,)):
                    break
        except BaseException as e:      # re-raised at the consumer
            err.append(e)
        finally:
            _close_upstream(it, err)
            ch.close()

    th = threading.Thread(target=worker, daemon=True,
                          name="alink-prefetch-0")
    th.start()
    try:
        while True:
            item = ch.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item[0]
    finally:
        ch.stop()
        _warn_stuck([th])


def _close_upstream(it, err: list) -> None:
    """Close the upstream iterator on every exit of its producer (the
    end, an error, the consumer stopping), so an error of its close still
    reaches the consumer."""
    try:
        close = getattr(it, "close", None)
        if close is not None:
            close()
    except BaseException as e:
        err.append(e)


def _warn_stuck(threads, timeout: float = 5.0) -> None:
    """Join ``threads`` against one shared deadline. A thread alive past
    it is blocked inside the upstream iterator or ``fn`` and cannot see
    the stop: log it rather than hang."""
    deadline = time.monotonic() + timeout
    for th in threads:
        th.join(timeout=max(0.0, deadline - time.monotonic()))
    stuck = [th.name for th in threads if th.is_alive()]
    if stuck:
        logging.getLogger(__name__).warning(
            "prefetch worker(s) %s did not exit within %.0f s of the "
            "consumer stopping; the upstream source appears blocked",
            ", ".join(stuck), timeout)


def prefetch_map(it: Iterable[T], fn: Callable[[T], U],
                 workers: int = 1) -> Iterator[U]:
    """Ordered parallel map: ``fn(item)`` for every item of ``it`` on a
    pool of ``workers`` threads (``alink-prefetch-<i>``), yielded in the
    exact input order.

    A dispatcher thread drains the upstream iterator in order; the work
    in ``fn`` (read, parse, encode) is what runs in parallel. A reorder
    buffer holds at most ``workers + PREFETCH_DEPTH`` finished results:
    a worker takes new work only while it has room. ``workers=1`` is
    :func:`prefetch` over the mapped iterator. An exception of
    ``fn(item_k)``, or of the upstream while it produces item k,
    re-raises at the consumer where item k would have come, after every
    earlier item."""
    workers = max(1, int(workers))
    if workers <= 1:
        # a generator, not map(): closing it closes the upstream too
        def _mapped():
            try:
                for item in it:
                    yield fn(item)
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
        yield from prefetch(_mapped())
        return

    in_ch = _Channel(PREFETCH_DEPTH)
    done = threading.Condition(threading.Lock())
    results: dict = {}          # seq -> ("ok", value) | ("err", exc)
    state = {"stop": False, "total": None}  # total: set when upstream ends

    def dispatcher():
        seq = 0
        try:
            for item in it:
                if not in_ch.put((seq, item)):
                    return
                seq += 1
        except BaseException as e:
            # the upstream failed producing item seq: deliver the error
            # at that position, after every earlier item
            with done:
                results[seq] = ("err", e)
                seq += 1
                done.notify_all()
        finally:
            err: list = []
            _close_upstream(it, err)
            with done:
                if err and seq not in results:
                    results[seq] = ("err", err[0])
                    seq += 1
                state["total"] = seq
                done.notify_all()
            in_ch.close()       # queued items still reach the workers

    bound = workers + PREFETCH_DEPTH

    def worker():
        while True:
            with done:
                # admission, not storage: a worker pulls new work only
                # while the buffer has room, but always stores what it
                # finished (gating the store would deadlock when the
                # buffer fills with items after the one the consumer
                # waits for)
                while not state["stop"] and len(results) >= bound:
                    done.wait()
                if state["stop"]:
                    return
            got = in_ch.get()
            if got is _SENTINEL:
                return
            seq, item = got
            try:
                out = ("ok", fn(item))
            except BaseException as e:
                out = ("err", e)
            with done:
                if state["stop"]:
                    return
                results[seq] = out
                done.notify_all()

    threads = [threading.Thread(target=dispatcher, daemon=True,
                                name="alink-prefetch-dispatch")]
    threads += [threading.Thread(target=worker, daemon=True,
                                 name=f"alink-prefetch-{i}")
                for i in range(workers)]
    for th in threads:
        th.start()
    next_seq = 0
    try:
        while True:
            with done:
                while next_seq not in results:
                    if state["total"] is not None \
                            and next_seq >= state["total"]:
                        return
                    done.wait()
                kind, val = results.pop(next_seq)
                done.notify_all()     # workers waiting for room wake
            if kind == "err":
                raise val
            yield val
            next_seq += 1
    finally:
        with done:
            state["stop"] = True
            results.clear()
            done.notify_all()
        in_ch.stop()
        _warn_stuck(threads)
