"""The environment flags the port reads.

Counterpart: ``alink_tpu/common/flags.py``. The entries the port reads
are kept with the JAX package's kinds, parsers, clamps and defaults:
the serving tier (buckets, precision, batching, breakers, feeders, the
swap mode and the compiled stream route), the observability planes
(metrics, tracing, request tracing, post-mortem bundles, the admin
plane, measured profiling) and durability (``ALINK_TPU_FAULT_INJECT``,
``ALINK_TPU_ASYNC_SNAPSHOT``). One parser per kind: a boolean is off
for ``0/false/off/no`` (any case) and on otherwise; other kinds read a
set-but-empty value as unset; a ``tolerant`` flag falls back to its
default on a value it cannot parse.

Left out: the JAX package's cache-key declarations (``folds_into`` /
``key_neutral``) and its generated doc tables. The port compiles no
programs, so there is no cache key for a flag to fold into.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional

__all__ = ["Flag", "FlagRegistry", "FLAGS", "env_flag", "flag_value",
           "flag_raw", "parse_bool"]

_FALSY = frozenset({"", "0", "false", "off", "no"})
_UNSET = object()


def parse_bool(raw: str) -> bool:
    """The one boolean semantics: ``0/false/off/no`` (any case,
    surrounding whitespace ignored) -> False; anything else -> True."""
    return raw.strip().lower() not in _FALSY


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean env flag: unset -> ``default``; otherwise
    :func:`parse_bool`. Works for undeclared names too (tests)."""
    v = os.environ.get(name)
    if v is None:
        return default
    return parse_bool(v)


def _serve_dtype_parse(raw: str) -> str:
    """Normalize ``ALINK_TPU_SERVE_DTYPE``: falsy -> "f32" (the full
    ship precision); bf16/bfloat16 -> "bf16"; int8/i8 -> "int8";
    f32/fp32/float32 -> "f32". Anything else refuses loudly — a typo'd
    precision must not silently serve full-precision scores."""
    v = raw.strip().lower()
    if v in _FALSY or v in ("f32", "fp32", "float32"):
        return "f32"
    if v in ("bf16", "bfloat16"):
        return "bf16"
    if v in ("int8", "i8"):
        return "int8"
    raise ValueError(
        f"ALINK_TPU_SERVE_DTYPE={raw!r}: want f32 | bf16 | int8")


_KIND_PARSERS: Dict[str, Callable[[str], Any]] = {
    "bool": parse_bool,
    "int": lambda raw: int(raw.strip()),
    "float": lambda raw: float(raw.strip()),
    "str": lambda raw: raw,
    "mode": lambda raw: raw,     # overridden per flag with a normalizer
}


@dataclass(frozen=True)
class Flag:
    """One declared environment flag: ``kind`` picks the parser unless
    ``parser`` overrides it, ``clamp`` bounds the value, ``section``
    groups it (``serving`` / ``observability`` / ``durability``), and a
    ``tolerant`` flag returns its default on an unparsable value."""
    name: str
    kind: str
    default: Any
    description: str
    section: str
    parser: Optional[Callable[[str], Any]] = None
    clamp: Optional[Callable[[Any], Any]] = None
    tolerant: bool = False

    def parse(self, raw: str, default: Any = _UNSET) -> Any:
        if self.kind == "bool":
            return parse_bool(raw)
        fn = self.parser or _KIND_PARSERS[self.kind]
        try:
            v = fn(raw)
        except (TypeError, ValueError):
            if self.tolerant:
                return self.default if default is _UNSET else default
            raise
        return self.clamp(v) if self.clamp is not None else v

    def read(self, default: Any = _UNSET) -> Any:
        """The flag's live value: the declared default when unset
        (non-bool kinds also read a set-but-empty value as unset)."""
        dflt = self.default if default is _UNSET else default
        raw = os.environ.get(self.name)
        if raw is None or (raw == "" and self.kind != "bool"):
            return dflt
        return self.parse(raw, dflt)


class FlagRegistry:
    """The declared flags by name."""

    def __init__(self):
        self._flags: Dict[str, Flag] = {}

    def register(self, name: str, kind: str, default: Any,
                 description: str, section: str, **kw) -> Flag:
        if not name.startswith("ALINK_"):
            raise ValueError(f"flag {name!r} must carry the ALINK_ prefix")
        if name in self._flags:
            raise ValueError(f"flag {name!r} registered twice")
        if kind not in _KIND_PARSERS:
            raise ValueError(f"flag {name!r}: unknown kind {kind!r}")
        flag = self._flags[name] = Flag(name, kind, default, description,
                                        section, **kw)
        return flag

    def __contains__(self, name: str) -> bool:
        return name in self._flags

    def __iter__(self) -> Iterator[Flag]:
        return iter(self._flags.values())

    def get(self, name: str) -> Optional[Flag]:
        return self._flags.get(name)

    def names(self) -> List[str]:
        return sorted(self._flags)

    def _require(self, name: str) -> Flag:
        flag = self._flags.get(name)
        if flag is None:
            raise KeyError(f"env flag {name!r} is not declared in "
                           f"alink_tpu_torch/common/flags.py")
        return flag

    def value(self, name: str, default: Any = _UNSET) -> Any:
        """The declared flag's parsed live value (``default=`` overrides
        the registered default)."""
        return self._require(name).read(default)

    def raw(self, name: str) -> Optional[str]:
        """The raw env string of a declared flag (``None`` when unset)."""
        self._require(name)
        return os.environ.get(name)


FLAGS = FlagRegistry()
_reg = FLAGS.register

# -- observability ----------------------------------------------------------
_reg("ALINK_TPU_METRICS", "bool", True,
     "master switch for every MetricsRegistry producer", "observability")
_reg("ALINK_TPU_STEP_LOG", "bool", False,
     "per-superstep log of the JAX package's common/profiling.py; "
     "declared with its default, read by no port module yet",
     "observability")
_reg("ALINK_TPU_TRACE", "bool", False,
     "structured span tracer (flight recorder)", "observability")
_reg("ALINK_TPU_TRACE_BUFFER", "int", 65536,
     "flight-recorder capacity in events", "observability",
     clamp=lambda n: max(1, n), tolerant=True)
_reg("ALINK_TPU_ADMIN_PORT", "int", 0,
     "live operations plane (common/adminz.py): serve /metrics /healthz "
     "/readyz /statusz /tracez /varz /requestz from an in-process HTTP "
     "endpoint on this port (0 = off, -1 = ephemeral OS-assigned port, "
     "discovered via adminz.get_admin().port)", "observability",
     clamp=lambda n: max(-1, n), tolerant=True)
_reg("ALINK_TPU_ADMIN_HOST", "str", "127.0.0.1",
     "bind address of the admin endpoint (loopback by default; the "
     "plane has no auth)", "observability")
_reg("ALINK_TPU_ADMIN_TRACEZ", "int", 512,
     "max flight-recorder events one /tracez response returns",
     "observability", clamp=lambda n: max(1, n), tolerant=True)
_reg("ALINK_TPU_ADMIN_REQUESTZ", "int", 256,
     "max request timelines one /requestz response returns",
     "observability", clamp=lambda n: max(1, n), tolerant=True)
_reg("ALINK_TPU_PROFILE", "bool", False,
     "measured profiling: capture windows, phase marks, live device "
     "memory (common/profiling2.py)", "observability")
_reg("ALINK_TPU_PROFILE_DIR", "str", "",
     "artifact directory of the profile export", "observability")
_reg("ALINK_TPU_REQTRACE", "bool", True,
     "request-scoped tracing (common/reqtrace.py): per-request phase "
     "timelines, tail-latency exemplars and overlap annotations",
     "observability")
_reg("ALINK_TPU_REQTRACE_RING", "int", 1024,
     "finished-request timeline ring capacity", "observability",
     clamp=lambda n: max(1, n), tolerant=True)
_reg("ALINK_TPU_POSTMORTEM_DIR", "str", "",
     "post-mortem bundle directory (common/postmortem.py; empty = "
     "capture off)", "observability")
_reg("ALINK_TPU_POSTMORTEM_KEEP", "int", 8,
     "bounded bundle retention: the newest N bundles survive pruning",
     "observability", clamp=lambda n: max(1, n), tolerant=True)
_reg("ALINK_TPU_POSTMORTEM_DEBOUNCE_S", "float", 60.0,
     "process-wide bundle debounce window in seconds", "observability",
     clamp=lambda v: max(0.0, v), tolerant=True)

# -- serving ----------------------------------------------------------------
_reg("ALINK_TPU_SERVE_COMPILED", "bool", False,
     "route ModelMapStreamOp (stream predict twins) through the "
     "serving path (CompiledPredictor); off = the host mapper path",
     "serving")
_reg("ALINK_TPU_SERVE_BUCKETS", "str", "",
     "serving shape-bucket set, comma-separated batch sizes (unset = "
     "1,8,32,128,512); requests pad to the smallest covering bucket",
     "serving")
_reg("ALINK_TPU_SERVE_WINDOW_MS", "float", 2.0,
     "micro-batcher latency budget: max milliseconds the serving loop "
     "holds a batch below ALINK_TPU_SERVE_MIN_FILL rows", "serving",
     clamp=lambda v: max(0.0, v))
_reg("ALINK_TPU_SERVE_MIN_FILL", "int", 1,
     "micro-batcher fill target in rows (1 = dispatch the moment the "
     "queue drains)", "serving", clamp=lambda n: max(1, n))
_reg("ALINK_TPU_SERVE_QUEUE", "int", 1024,
     "admission-control bound of the serving request channel (a full "
     "queue blocks submitters)", "serving", clamp=lambda n: max(1, n))
_reg("ALINK_TPU_SERVE_DTYPE", "mode", "f32",
     "serving score precision: f32 (full ship precision) | bf16 (bf16 "
     "inputs, f32 terms and sum) | int8 (symmetric per-model weight "
     "quantization with a stored scale, f32 sum)", "serving",
     parser=_serve_dtype_parse)
_reg("ALINK_TPU_SERVE_BREAKER", "bool", True,
     "circuit-broken degradation of the serving dispatch: consecutive "
     "failures open a per-model-version breaker that routes traffic to "
     "the host-mapper fallback and re-probes on a deterministic backoff "
     "schedule; 0 = a failed batch fails its requests", "serving")
_reg("ALINK_TPU_SERVE_BREAKER_THRESHOLD", "int", 3,
     "consecutive dispatch failures (closed state) that trip the "
     "breaker open", "serving", clamp=lambda n: max(1, n))
_reg("ALINK_TPU_SERVE_BREAKER_BACKOFF_MS", "float", 50.0,
     "first open->half-open probe delay of the breaker", "serving",
     clamp=lambda v: max(0.0, v))
_reg("ALINK_TPU_SERVE_BREAKER_FACTOR", "float", 2.0,
     "breaker backoff multiplier applied per re-open", "serving",
     clamp=lambda v: max(1.0, v))
_reg("ALINK_TPU_SERVE_BREAKER_MAX_MS", "float", 5000.0,
     "breaker backoff ceiling", "serving", clamp=lambda v: max(0.0, v))
_reg("ALINK_TPU_SERVE_FEEDER_RETRIES", "int", 3,
     "bounded retry budget of the supervised model feeders for a "
     "transient swap failure (poisoned snapshots skip instead)",
     "serving", clamp=lambda n: max(0, n))
_reg("ALINK_TPU_SERVE_FEEDER_BACKOFF_MS", "float", 20.0,
     "first feeder retry delay, doubling per attempt", "serving",
     clamp=lambda v: max(0.0, v))
_reg("ALINK_TPU_SERVE_SWAP", "mode", "double",
     "hot model-swap mode: double (standby slot prepared off the "
     "serving loop, one-store flip) | sync (the flip also waits until "
     "the standby weights are on the device)", "serving",
     parser=lambda raw: ("sync" if raw.strip().lower() == "sync"
                         else "double"))

# -- durability -------------------------------------------------------------
_reg("ALINK_TPU_ASYNC_SNAPSHOT", "bool", True,
     "write the engine's superstep snapshots from a background writer, "
     "one snapshot in flight (off: write them in line)", "durability")
_reg("ALINK_TPU_FAULT_INJECT", "str", "",
     "armed fault sites, site:index[-end][:mode[:param]] entries "
     "separated by ';' (grammar in common/faults.py)", "durability")
del _reg


def flag_value(name: str, default: Any = _UNSET) -> Any:
    """The declared flag's parsed live value (``default=`` overrides
    the registered default)."""
    return FLAGS.value(name, default)


def flag_raw(name: str) -> Optional[str]:
    """The raw env string of a declared flag (``None`` when unset)."""
    return FLAGS.raw(name)
