"""Deterministic fault injection — kill, error, delay or corrupt a run
at a named site, on purpose.

Counterpart: ``alink_tpu/common/faults.py``, copied with the same
environment variable, spec grammar and site names, so one spec arms
the same sites in both packages. The reference inherits chaos testing
from Flink's checkpointing integration tests (TaskManager kills mid-job,
the job restarts from the last completed checkpoint). Here faults are
injected *in process*: durability hot paths call ``maybe_crash(site,
index)`` at the exact points where a real failure would bite — a
ComQueue superstep boundary, an FTRL micro-batch boundary, a checkpoint
publish, a serving dispatch — and the hook acts once the configured
index window is reached.

Configuration rides in one env var so tests (and operators reproducing a
field failure) need no code changes::

    ALINK_TPU_FAULT_INJECT="comqueue.superstep:9"          # kill (default)
    ALINK_TPU_FAULT_INJECT="ftrl.batch:5;ckpt.save:2"      # several sites
    ALINK_TPU_FAULT_INJECT="serve.dispatch:1-40:error"     # transient storm
    ALINK_TPU_FAULT_INJECT="serve.dispatch:5:delay:250"    # +250 ms latency
    ALINK_TPU_FAULT_INJECT="feeder.snapshot:2-2:corrupt"   # one bad snapshot

Each entry is ``site:index[-end][:mode[:param]]``:

  * ``index`` — the 1-based visit the fault arms at. A bare ``index``
    fires at the FIRST call whose ``index >= configured`` and every call
    after (the historical kill semantics — a dead process stays dead);
    ``index-end`` fires only while ``index <= visit <= end``, which is
    what makes transient storms *clear* deterministically (a breaker
    recovery or a retry success is then a reproducible event, not a
    race against a test's disarm timing).
  * ``mode`` — what happens inside the window:
      - ``kill``   (default) raise :class:`FaultInjected` — the injected
        process kill; generic handlers must NOT catch it;
      - ``error``  raise :class:`TransientFault` — a *catchable*
        ``RuntimeError`` standing in for a transient backend failure
        (the thing retry/breaker policies exist for);
      - ``delay:MS`` sleep ``MS`` milliseconds — latency injection for
        deadline/shed testing;
      - ``corrupt`` make :func:`maybe_crash` return ``True`` — the call
        site owns the corruption (it knows its payload format); sites
        that cannot corrupt ignore the return value.

Sites are plain dotted strings; the port's producers:

  * ``comqueue.superstep``  — superstep boundary (engine/recovery.py),
    index = 1-based superstep number;
  * ``ftrl.batch``          — after an FTRL micro-batch commits
    (operator/stream/onlinelearning/ftrl.py), index = 1-based batch count;
  * ``ckpt.save``           — just before a checkpoint directory is
    published (common/checkpoint.py), auto-indexed per process;
  * ``serve.dispatch``      — before each serving dispatch
    (serving/predictor.py), auto-indexed;
  * ``serve.swap``          — at each hot model/weights swap
    (serving/predictor.py), auto-indexed;
  * ``feeder.snapshot``     — at each FTRL model-snapshot emission
    (the serving feeder's input; ``corrupt`` mangles the emitted model
    table so the consumer's load fails loudly), auto-indexed;
  * ``prefetch.get``        — inside the bounded channel's ``get``
    (operator/stream/prefetch.py — the serving loop and every stream
    drain pull through it), auto-indexed.

The JAX package's ``ingest.batch`` site comes with the online DAG
(ROADMAP A4(c)). A fault that fires records a ``fault.injected`` trace
instant, and a kill a post-mortem bundle (both off unless their flags
are set).

The env var is re-read on every call (monkeypatch-friendly); parsing is
cached per raw string so the hot-path cost is one dict lookup. Tests
that arm auto-indexed sites should call :func:`reset_faults` first (and
in teardown): the per-process visit counters otherwise leak across
tests that arm the same site twice.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, NamedTuple, Optional

__all__ = ["FAULT_ENV", "FAULT_MODES", "FaultInjected", "FaultRule",
           "TransientFault", "fault_spec", "faults_armed", "maybe_crash",
           "reset_faults", "scoped_fault_env"]

FAULT_ENV = "ALINK_TPU_FAULT_INJECT"

FAULT_MODES = ("kill", "error", "delay", "corrupt")


class FaultInjected(RuntimeError):
    """Raised by :func:`maybe_crash` in ``kill`` mode — the injected
    'process kill'.

    Deliberately NOT a subclass of any alink error type: durability code
    must not be able to catch it by accident in a generic handler.
    """

    def __init__(self, site: str, index: int, threshold: int):
        super().__init__(
            f"fault injected at {site}:{index} "
            f"({FAULT_ENV} threshold {threshold})")
        self.site = site
        self.index = index
        self.threshold = threshold


class TransientFault(RuntimeError):
    """Raised by :func:`maybe_crash` in ``error`` mode — a *catchable*
    stand-in for a transient backend failure (device OOM blip, link
    hiccup, preempted core). Retry/backoff and circuit-breaker policies
    are ALLOWED (expected) to catch this; :class:`FaultInjected` they
    are not."""

    def __init__(self, site: str, index: int, threshold: int):
        super().__init__(
            f"transient fault injected at {site}:{index} "
            f"({FAULT_ENV} threshold {threshold})")
        self.site = site
        self.index = index
        self.threshold = threshold


class FaultRule(NamedTuple):
    """One armed site: fire while ``lo <= visit`` (and ``<= hi`` when
    ``hi`` is bounded) with ``mode`` (``param`` = delay milliseconds)."""
    lo: int
    hi: Optional[int]
    mode: str
    param: float

    def active(self, index: int) -> bool:
        return index >= self.lo and (self.hi is None or index <= self.hi)


# parse cache: raw env string -> {site: FaultRule}; the env var is read
# fresh each call but identical strings parse once
_PARSED: Dict[str, Dict[str, FaultRule]] = {}

# per-process visit counters for sites whose callers do not track an
# index themselves (``maybe_crash(site)`` with index=None). Locked: the
# serving sites (serve.dispatch under replicas, prefetch.get from every
# channel consumer) increment concurrently, and a lost/duplicated
# increment would fire a bounded window twice or never — the exactly-
# once determinism the chaos specs are built on
_AUTO_INDEX: Dict[str, int] = {}
_AUTO_LOCK = threading.Lock()


def _next_index(site: str) -> int:
    with _AUTO_LOCK:
        index = _AUTO_INDEX.get(site, 0) + 1
        _AUTO_INDEX[site] = index
    return index


def _malformed(entry: str, why: str) -> ValueError:
    return ValueError(
        f"{FAULT_ENV}: malformed entry {entry!r} ({why}; want "
        f"site:index[-end][:mode[:param]] with integer index/end, "
        f"mode one of {'/'.join(FAULT_MODES)})")


def _parse_entry(entry: str) -> tuple:
    parts = [p.strip() for p in entry.split(":")]
    if len(parts) < 2 or not parts[0]:
        raise _malformed(entry, "want at least site:index")
    site, idx = parts[0], parts[1]
    lo_s, sep, hi_s = idx.partition("-")
    try:
        lo = int(lo_s)
        hi = int(hi_s) if sep else None
    except ValueError:
        # a bare int(idx) traceback names neither the env var nor the
        # site — wrap it in the malformed-entry diagnostic
        raise _malformed(entry, f"non-integer index {idx!r} for site "
                                f"{site!r}") from None
    if hi is not None and hi < lo:
        raise _malformed(entry, f"empty index window {idx!r}")
    mode = parts[2] if len(parts) > 2 and parts[2] else "kill"
    if mode not in FAULT_MODES:
        raise _malformed(entry, f"unknown mode {mode!r}")
    param = 0.0
    if mode == "delay":
        if len(parts) < 4:
            raise _malformed(entry, "delay needs a milliseconds param "
                                    "(site:index:delay:MS)")
        try:
            param = float(parts[3])
        except ValueError:
            raise _malformed(entry, f"non-numeric delay {parts[3]!r}") \
                from None
    elif len(parts) > 3:
        raise _malformed(entry, f"mode {mode!r} takes no param")
    return site, FaultRule(lo, hi, mode, param)


def _parse(raw: str) -> Dict[str, FaultRule]:
    spec = _PARSED.get(raw)
    if spec is None:
        spec = {}
        for entry in raw.replace(",", ";").split(";"):
            entry = entry.strip()
            if not entry:
                continue
            site, rule = _parse_entry(entry)
            if site in spec:
                # last-wins would silently drop the earlier rule — a
                # storm spec that tests nothing; refuse like every
                # other malformed spec
                raise _malformed(
                    entry, f"site {site!r} already has a rule (one "
                           f"entry per site; stage multi-leg storms by "
                           f"re-setting {FAULT_ENV} between legs)")
            spec[site] = rule
        if len(_PARSED) > 64:   # bound the cache; specs are few in practice
            _PARSED.clear()
        _PARSED[raw] = spec
    return spec


def fault_spec() -> Dict[str, FaultRule]:
    """The active {site: rule} map (empty when unset). The raw
    spec string is read through the flag registry (common/flags.py);
    its ``site:index:mode`` grammar stays here with its consumer."""
    from .flags import flag_value
    raw = flag_value(FAULT_ENV)
    return _parse(raw) if raw else {}


def faults_armed() -> bool:
    return bool(fault_spec())


def reset_faults() -> None:
    """Clear the per-process auto-index visit counters (and the parse
    cache). Tests that arm an auto-indexed site (``serve.dispatch``,
    ``ckpt.save``, ...) MUST call this in setup/teardown — the counters
    otherwise leak across tests that arm the same site twice, shifting
    every later threshold."""
    _AUTO_INDEX.clear()
    _PARSED.clear()


@contextlib.contextmanager
def scoped_fault_env(spec: Optional[str]) -> Iterator[None]:
    """Arm ``spec`` in :data:`FAULT_ENV` for the duration of a scenario,
    with the counter hygiene the chaos harnesses need: the per-process
    auto-index visit counters are reset on ENTRY (so the scenario's windows count from zero regardless of what
    ran before) and the previous env value is restored — and the
    counters reset again — on EXIT, **including failure paths** (the
    body raising must not bleed armed faults or shifted visit counters
    into the next scenario). ``spec=None`` runs the body with the fault
    env guaranteed UNSET (a clean scenario between storms).

    One storm leg per ``with`` block; legs that must share one
    uninterrupted visit-counter timeline (the chaos smoke's
    exactly-once corrupt window across an error leg and a delay leg)
    belong inside a SINGLE scope, flipping ``os.environ[FAULT_ENV]``
    directly between them.
    """
    saved = os.environ.get(FAULT_ENV)
    reset_faults()
    if spec:
        os.environ[FAULT_ENV] = spec
    else:
        os.environ.pop(FAULT_ENV, None)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(FAULT_ENV, None)
        else:
            os.environ[FAULT_ENV] = saved
        reset_faults()


def maybe_crash(site: str, index: Optional[int] = None) -> bool:
    """Act on ``site``'s armed fault when ``index`` is inside its window.
    With ``index=None`` a per-process visit counter for the site is used
    (1-based; it only advances while some fault spec is armed).

    ``kill`` raises :class:`FaultInjected`; ``error`` raises
    :class:`TransientFault`; ``delay`` sleeps its parameter (ms) and
    returns ``False``; ``corrupt`` returns ``True`` — the CALLER owns
    the corruption (it knows its payload format). Returns ``False``
    otherwise, so legacy call sites can keep ignoring the result.

    Unarmed fast path: ONE os.environ probe (the flag is registered in
    common/flags.py and this read is semantically ``flag_value``; sites
    like ``prefetch.get`` sit on per-message hot paths, so the unarmed
    cost must stay a dict lookup, not a registry round trip)."""
    if not os.environ.get(FAULT_ENV):
        return False
    spec = fault_spec()
    if not spec:
        return False
    if index is None:
        index = _next_index(site)
    rule = spec.get(site)
    if rule is None or not rule.active(index):
        return False
    # mark the fault in the trace timeline BEFORE acting, so a flight
    # recorder dumped by a crash handler shows exactly where the
    # injected failure hit relative to checkpoint saves / dispatches
    from .tracing import trace_instant
    trace_instant("fault.injected", cat="fault",
                  args={"site": site, "index": int(index),
                        "threshold": rule.lo, "mode": rule.mode})
    if rule.mode == "kill":
        # the injected process kill is the crash class the post-mortem
        # bundle exists for: freeze the evidence BEFORE the raise
        # unwinds the rings' producers (debounced; off without
        # ALINK_TPU_POSTMORTEM_DIR)
        from .postmortem import maybe_bundle
        maybe_bundle("injected_kill", f"fault injected at {site}:{index}",
                     extra={"site": site, "index": int(index),
                            "threshold": rule.lo})
        raise FaultInjected(site, int(index), rule.lo)
    if rule.mode == "error":
        raise TransientFault(site, int(index), rule.lo)
    if rule.mode == "delay":
        time.sleep(rule.param / 1e3)
        return False
    return True       # corrupt: signal the caller
