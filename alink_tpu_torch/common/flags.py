"""The environment flags the port reads.

Counterpart: ``alink_tpu/common/flags.py``. Only the serving entries of
that registry and the durability ones (``ALINK_TPU_FAULT_INJECT``,
``ALINK_TPU_ASYNC_SNAPSHOT``) are kept, with the same parsers and
defaults. The JAX
package's cache-key declarations (``folds_into`` / ``key_neutral``) are
left out: the port compiles no programs, so there is no cache key for
a flag to fold into.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

_FALSY = frozenset({"", "0", "false", "off", "no"})
_UNSET = object()


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


def _bool_parse(raw: str) -> bool:
    """On unless the value is one of the falsy spellings."""
    return raw.strip().lower() not in _FALSY


@dataclass(frozen=True)
class Flag:
    """One declared environment flag: ``parser`` turns the raw string
    into a value, ``clamp`` bounds it. A set-but-empty value reads as
    unset."""
    name: str
    default: Any
    description: str
    parser: Callable[[str], Any]
    clamp: Optional[Callable[[Any], Any]] = None

    def read(self, default: Any = _UNSET) -> Any:
        raw = os.environ.get(self.name)
        if raw is None or raw == "":
            return self.default if default is _UNSET else default
        v = self.parser(raw)
        return self.clamp(v) if self.clamp is not None else v


FLAGS: Dict[str, Flag] = {f.name: f for f in (
    Flag("ALINK_TPU_SERVE_BUCKETS", "",
         "serving shape-bucket set, comma-separated batch sizes "
         "(unset = 1,8,32,128,512); requests pad to the smallest "
         "covering bucket", parser=str),
    Flag("ALINK_TPU_SERVE_DTYPE", "f32",
         "serving score precision: f32 (full ship precision) | bf16 "
         "(bf16 inputs, f32 terms and sum) | int8 (symmetric per-model "
         "weight quantization with a stored scale, f32 sum)",
         parser=_serve_dtype_parse),
    Flag("ALINK_TPU_SERVE_WINDOW_MS", 2.0,
         "micro-batcher latency budget: max milliseconds the serving "
         "loop holds a batch below ALINK_TPU_SERVE_MIN_FILL rows",
         parser=lambda raw: float(raw.strip()),
         clamp=lambda v: max(0.0, v)),
    Flag("ALINK_TPU_SERVE_MIN_FILL", 1,
         "micro-batcher fill target in rows (1 = dispatch the moment "
         "the queue drains)", parser=lambda raw: int(raw.strip()),
         clamp=lambda n: max(1, n)),
    Flag("ALINK_TPU_SERVE_QUEUE", 1024,
         "admission-control bound of the serving request channel (a "
         "full queue blocks submitters)",
         parser=lambda raw: int(raw.strip()), clamp=lambda n: max(1, n)),
    Flag("ALINK_TPU_FAULT_INJECT", "",
         "armed fault sites, site:index[-end][:mode[:param]] entries "
         "separated by ';' (grammar in common/faults.py)", parser=str),
    Flag("ALINK_TPU_ASYNC_SNAPSHOT", True,
         "write the engine's superstep snapshots from a background "
         "writer, one snapshot in flight (off: write them in line)",
         parser=_bool_parse),
)}


def flag_value(name: str, default: Any = _UNSET) -> Any:
    """The declared flag's parsed live value (``default=`` overrides
    the registered default)."""
    flag = FLAGS.get(name)
    if flag is None:
        raise KeyError(f"env flag {name!r} is not declared in "
                       f"alink_tpu_torch/common/flags.py")
    return flag.read(default)
