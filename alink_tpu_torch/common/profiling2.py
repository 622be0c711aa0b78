"""Measured profiling, host half — capture windows and phase marks.

Counterpart: ``alink_tpu/common/profiling2.py``; ported: the
collector's host half, which ``bench.py``'s serving legs use:
:class:`ProfileCollector` with :func:`measured_region`,
:func:`workload`, capture windows (:func:`profile_window` /
:func:`open_window`), windowless phase marks (:func:`mark`) and live
device-memory snapshots (:func:`hbm_snapshot`, whose
:func:`live_hbm_bytes` is ``torch.cuda.memory_allocated`` where the
JAX package walks ``jax.live_arrays()``).

  * **capture windows** — a call site opens a :func:`profile_window`
    around a device-bound region and marks the host-observable phase
    splits into it: ``dispatch`` (time the call held the host thread),
    ``device`` (time a blocking synchronize waited on device work),
    ``transfer`` (host-to-device ship / device-to-host fetch),
    ``collective`` (0 at one worker).
  * **timing-harness attribution** — per (workload, scope, bucket)
    sums of the marks over *measured* regions only; the residual of a
    measured wall not covered by any mark is the ``host`` bucket
    (encode/IO/python).

Left out for ROADMAP A10(b), because they read a JAX trace or JAX
buffer donation: the xprof capture and its parser
(``parse_xprof_trace``), ``measured_bound`` and ``donation_probe``.

Everything here is host-side: nothing changes a tensor or a launch.
Flags (``common/flags.py``): ``ALINK_TPU_PROFILE`` (default off; the
master switch) and ``ALINK_TPU_PROFILE_DIR`` (artifact directory).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .flags import flag_value

__all__ = [
    "PROFILE_ENV", "PROFILE_DIR_ENV", "PROFILE_FORMAT", "BUCKETS",
    "profile_enabled", "profile_dir", "ProfileCollector", "get_profiler",
    "set_profiler", "profile_window", "open_window", "mark",
    "hbm_snapshot", "live_hbm_bytes", "measured_region", "workload",
]

PROFILE_ENV = "ALINK_TPU_PROFILE"
PROFILE_DIR_ENV = "ALINK_TPU_PROFILE_DIR"

PROFILE_FORMAT = "alink_tpu_profile_v1"

# the four measured buckets (host residual is derived, never marked)
BUCKETS = ("dispatch", "transfer", "device", "collective")


def profile_enabled() -> bool:
    """``ALINK_TPU_PROFILE`` switch (default off), read live."""
    return flag_value(PROFILE_ENV, False)


def profile_dir() -> str:
    """``ALINK_TPU_PROFILE_DIR`` — the profile artifact directory."""
    return flag_value(PROFILE_DIR_ENV, "")


def live_hbm_bytes() -> int:
    """Bytes the caching allocator holds in live tensors on the current
    CUDA device right now (``torch.cuda.memory_allocated``); 0 without
    CUDA."""
    import torch
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.memory_allocated())


class _NullWindow:
    """Shared no-op window when profiling is off — the hot-path cost is
    one env read at window creation and attribute no-ops per mark."""

    __slots__ = ()
    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):
        return self

    def dispatch(self, seconds, n=1):
        pass

    def device(self, seconds):
        pass

    def transfer(self, seconds, nbytes=0):
        pass

    def collective(self, seconds, calls=0):
        pass

    def close(self):
        pass


_NULL_WINDOW = _NullWindow()


class _Window:
    """One capture window: phase marks land in the collector keyed by
    the workload/scope captured at open. Usable as a context manager or
    via explicit :meth:`close` (generator drains must not hold a
    ``with`` across ``yield``). Thread-safe: prefetch threads mark into
    the same window object the consumer opened."""

    __slots__ = ("scope", "label", "workload", "_col", "_t0", "_closed")

    @property
    def on(self) -> bool:
        return True

    def __init__(self, collector: "ProfileCollector", scope: str,
                 label: Optional[str]):
        self.scope = scope
        self.label = label
        self._col = collector
        self.workload = collector.current_workload()
        self._t0 = time.perf_counter()
        self._closed = False

    def set(self, **kw):
        if "label" in kw:
            self.label = kw["label"]
        return self

    def dispatch(self, seconds, n=1):
        self._col._mark(self.workload, self.scope, "dispatch", seconds, n=n)

    def device(self, seconds):
        self._col._mark(self.workload, self.scope, "device", seconds)

    def transfer(self, seconds, nbytes=0):
        self._col._mark(self.workload, self.scope, "transfer", seconds,
                        nbytes=nbytes)

    def collective(self, seconds, calls=0):
        self._col._mark(self.workload, self.scope, "collective", seconds,
                        n=calls)

    def close(self):
        if self._closed:
            return
        self._closed = True
        wall = time.perf_counter() - self._t0
        self._col._record_window(self.workload, self.scope, self.label, wall)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ProfileCollector:
    """Thread-safe accumulator for measured-profiling data.

    Aggregates phase marks per (workload, scope, bucket, measured-flag)
    — bounded by the instrumentation-site x workload product, never by
    run length — plus per-(workload, scope) window wall stats, HBM
    snapshots (last/max per scope). ``export(path)`` writes the
    ``alink_tpu_profile_v1`` JSON artifact (the JAX package's format,
    without its capture and donation sections).
    """

    def __init__(self):
        self._lock = threading.Lock()
        # (workload, scope, bucket, measured) -> [seconds, n, nbytes]
        self._marks: Dict[Tuple, List[float]] = {}
        # (workload, scope) -> [windows, wall_s]
        self._windows: Dict[Tuple, List[float]] = {}
        # (workload, scope) -> [count, last_bytes, max_bytes]
        self._hbm: Dict[Tuple, List[float]] = {}
        self._workload: Optional[str] = None
        self._measured_depth = 0
        # workload -> measured-region wall seconds
        self._measured_wall: Dict[Optional[str], float] = {}

    # -- workload / measured-region context ------------------------------
    def current_workload(self) -> Optional[str]:
        return self._workload

    @contextlib.contextmanager
    def workload(self, name: str) -> Iterator[None]:
        """Scope every mark/window/snapshot recorded inside to one named
        workload (a benchmark sets it per row; workloads run
        serially, so one process-wide slot is the right model)."""
        with self._lock:
            prev, self._workload = self._workload, str(name)
        try:
            yield
        finally:
            with self._lock:
                self._workload = prev

    @contextlib.contextmanager
    def measured_region(self) -> Iterator[None]:
        """Tag marks recorded inside as belonging to a *timed* span (the
        benchmark's measured endpoints). Attribution for a workload uses
        measured marks only, so warmup compiles never pollute the
        steady-state fractions. Regions may nest; wall is charged to the
        outermost region only."""
        t0 = time.perf_counter()
        with self._lock:
            self._measured_depth += 1
            outer = self._measured_depth == 1
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._measured_depth -= 1
                if outer:
                    key = self._workload
                    self._measured_wall[key] = \
                        self._measured_wall.get(key, 0.0) + dt

    # -- recording ---------------------------------------------------------
    def _mark(self, workload, scope: str, bucket: str, seconds: float,
              n: int = 1, nbytes: int = 0):
        with self._lock:
            measured = self._measured_depth > 0
            key = (workload, scope, bucket, measured)
            acc = self._marks.get(key)
            if acc is None:
                acc = self._marks[key] = [0.0, 0, 0]
            acc[0] += float(seconds)
            acc[1] += int(n)
            acc[2] += int(nbytes)

    def _record_window(self, workload, scope: str, label, wall_s: float):
        with self._lock:
            key = (workload, scope)
            acc = self._windows.get(key)
            if acc is None:
                acc = self._windows[key] = [0, 0.0]
            acc[0] += 1
            acc[1] += wall_s

    def hbm_snapshot(self, scope: str) -> Optional[int]:
        """Record the live device-buffer bytes under ``scope`` (and the
        ``alink_hbm_live_bytes{scope=}`` gauge). No-op (returns None)
        when profiling is off."""
        if not profile_enabled():
            return None
        nbytes = live_hbm_bytes()
        with self._lock:
            key = (self._workload, scope)
            acc = self._hbm.get(key)
            if acc is None:
                acc = self._hbm[key] = [0, 0, 0]
            acc[0] += 1
            acc[1] = nbytes
            acc[2] = max(acc[2], nbytes)
        from .metrics import get_registry, metrics_enabled
        if metrics_enabled():
            get_registry().set_gauge("alink_hbm_live_bytes", nbytes,
                                     {"scope": scope})
        return nbytes

    def discard_workload(self, name: Optional[str]) -> None:
        """Drop everything recorded for one workload — a benchmark calls
        this before retrying a failed row so the aborted attempt's marks
        and measured wall never double into the published attribution."""
        with self._lock:
            self._marks = {k: v for k, v in self._marks.items()
                           if k[0] != name}
            self._windows = {k: v for k, v in self._windows.items()
                             if k[0] != name}
            self._hbm = {k: v for k, v in self._hbm.items()
                         if k[0] != name}
            self._measured_wall.pop(name, None)

    # -- reading -----------------------------------------------------------
    def workload_attribution(self, name: Optional[str]
                             ) -> Optional[Dict[str, Any]]:
        """Measured attribution for one workload: the four bucket sums
        over *measured* marks, the measured wall, and the derived host
        residual. None when nothing measured was recorded."""
        with self._lock:
            wall = self._measured_wall.get(name, 0.0)
            sums = {b: 0.0 for b in BUCKETS}
            counts = {b: 0 for b in BUCKETS}
            nbytes = 0
            found = False
            device_scopes = set()
            for (wl, scope, bucket, measured), acc in self._marks.items():
                if wl != name or not measured:
                    continue
                found = True
                sums[bucket] += acc[0]
                counts[bucket] += acc[1]
                if bucket == "transfer":
                    nbytes += acc[2]
                if bucket == "device" and acc[0] > 0:
                    device_scopes.add(scope)
        if not found and wall <= 0.0:
            return None
        attributed = sum(sums.values())
        host = max(wall - attributed, 0.0)
        out = {f"{b}_s": round(sums[b], 6) for b in BUCKETS}
        out["host_s"] = round(host, 6)
        out["measured_wall_s"] = round(wall, 6)
        out["dispatch_calls"] = counts["dispatch"]
        out["transfer_bytes"] = nbytes
        # which program legs the device time came from: a per-sample
        # cost model only normalizes honestly against a SINGLE leg's
        # device time (consumers skip the compute/hbm split otherwise)
        out["device_scopes"] = sorted(device_scopes)
        out["source"] = "timing-harness"
        return out

    def summary(self) -> Dict[str, Any]:
        """The full collector state as plain JSON-ready dicts."""
        with self._lock:
            marks = [
                {"workload": wl, "scope": scope, "bucket": bucket,
                 "measured": measured, "seconds": round(acc[0], 6),
                 "n": acc[1], "nbytes": acc[2]}
                for (wl, scope, bucket, measured), acc
                in sorted(self._marks.items(),
                          key=lambda kv: (str(kv[0][0]), kv[0][1],
                                          kv[0][2], kv[0][3]))]
            windows = [
                {"workload": wl, "scope": scope, "count": int(acc[0]),
                 "wall_s": round(acc[1], 6)}
                for (wl, scope), acc in sorted(
                    self._windows.items(),
                    key=lambda kv: (str(kv[0][0]), kv[0][1]))]
            hbm = [
                {"workload": wl, "scope": scope, "count": int(acc[0]),
                 "last_bytes": int(acc[1]), "max_bytes": int(acc[2])}
                for (wl, scope), acc in sorted(
                    self._hbm.items(),
                    key=lambda kv: (str(kv[0][0]), kv[0][1]))]
            names = sorted({str(wl) for wl in self._measured_wall
                            if wl is not None}
                           | {str(k[0]) for k in self._marks
                              if k[0] is not None})
        workloads = {}
        for n in names:
            attr = self.workload_attribution(n)
            if attr is not None:
                workloads[n] = attr
        doc = {"format": PROFILE_FORMAT, "enabled": profile_enabled(),
               "workloads": workloads, "marks": marks, "windows": windows,
               "hbm": hbm}
        return doc

    def export(self, path: str) -> str:
        """Write the profile artifact (atomic publish); returns path."""
        doc = self.summary()
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
        return path

    def reset(self) -> None:
        with self._lock:
            self._marks.clear()
            self._windows.clear()
            self._hbm.clear()
            self._measured_wall.clear()


# -- the process-wide collector ---------------------------------------------

_default_collector: Optional[ProfileCollector] = None
_default_lock = threading.Lock()


def get_profiler() -> ProfileCollector:
    """The collector every instrumented site reports into."""
    global _default_collector
    if _default_collector is None:
        with _default_lock:
            if _default_collector is None:
                _default_collector = ProfileCollector()
    return _default_collector


def set_profiler(collector: ProfileCollector) -> ProfileCollector:
    """Swap the process-wide collector (per-run isolation, tests)."""
    global _default_collector
    with _default_lock:
        prev = _default_collector if _default_collector is not None \
            else ProfileCollector()
        _default_collector = collector
    return prev


# -- instrumentation helpers (the call-site API) ----------------------------

def profile_window(scope: str, label: Optional[str] = None):
    """A capture window on the process collector, or the shared no-op
    when ``ALINK_TPU_PROFILE`` is off. Use as a context manager."""
    if not profile_enabled():
        return _NULL_WINDOW
    return _Window(get_profiler(), scope, label)


def open_window(scope: str, label: Optional[str] = None):
    """Like :func:`profile_window` but for call sites that must close
    explicitly (generator drains — an open ``with`` must not cross a
    ``yield``). Call ``.close()`` in a ``finally``."""
    return profile_window(scope, label=label)


def mark(scope: str, bucket: str, seconds: float, n: int = 1,
         nbytes: int = 0) -> None:
    """A windowless phase mark (e.g. a result fetch outside any engine
    window); no-op when profiling is off."""
    if not profile_enabled():
        return
    if bucket not in BUCKETS:
        raise ValueError(f"unknown profile bucket {bucket!r}; "
                         f"expected one of {BUCKETS}")
    col = get_profiler()
    col._mark(col.current_workload(), scope, bucket, seconds,
              n=n, nbytes=nbytes)


def hbm_snapshot(scope: str) -> Optional[int]:
    """Module-level convenience for
    :meth:`ProfileCollector.hbm_snapshot` (no-op when off)."""
    if not profile_enabled():
        return None
    return get_profiler().hbm_snapshot(scope)


def measured_region():
    """Module-level convenience: the process collector's measured-region
    context (a real no-op context when profiling is off)."""
    if not profile_enabled():
        return contextlib.nullcontext()
    return get_profiler().measured_region()


def workload(name: str):
    """Module-level convenience: scope recording to one workload."""
    if not profile_enabled():
        return contextlib.nullcontext()
    return get_profiler().workload(name)
