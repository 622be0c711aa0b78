"""The fused serving score kernels: CUDA wrappers and their plain versions.

Counterpart: ``alink_tpu/kernels/serve.py``. There two Pallas kernels,
``_fused_dense_call`` and ``_fused_sparse_call``, run encode-gather ->
dot for ``CompiledPredictor``'s linear bucket programs. Here the same
two functions are CUDA kernels written by hand for Hopper
(``csrc/serve_score.cu``), with the bias (and int8 scale) epilogue
fused in. :func:`dense_scores` and :func:`sparse_scores` are the
wrappers; :func:`dense_scores_plain` and :func:`sparse_scores_plain`
are their plain PyTorch versions. A wrapper given CPU tensors runs the
plain version. Given CUDA tensors it launches its kernel or raises.

**The reduction-order contract** (the JAX package's): each row's score
is one ordered chain. Every term is rounded on its own (a multiply,
never an FMA), the terms are added strictly left to right from a zero
accumulator, and the epilogue comes last. So the scores of a row do
not depend on the bucket it was padded to, and the kernels agree with
the plain versions bit for bit.

**Modes** (``ALINK_TPU_SERVE_DTYPE``). The port computes what the JAX
package computes on the CPU, which is not quite what that package's
docstring says (``ROADMAP.md`` Queue C):

* ``f32`` — terms and sum in the ship dtype (float32 or float64);
  epilogue ``acc + b``.
* ``bf16`` — request values and weights rounded to bf16; each term is
  the f32 product of the two bf16 values, which is exact, and is NOT
  rounded back to bf16; f32 sum; epilogue ``acc + b``.
* ``int8`` — symmetric per-model weight quantization with one scale;
  terms ``x * f32(q)`` and the sum in f32; epilogue
  ``acc * scale + b`` rounded ONCE, as the FMA XLA contracts it into.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..serving.sharded import seq_chunk_sum
from . import _build

__all__ = ["SERVE_DTYPE_ENV", "serve_dtype", "quantize_int8",
           "lowp_model_arrays", "dense_scores", "sparse_scores",
           "dense_scores_plain", "sparse_scores_plain", "make_score_fns",
           "launch_counts", "reset_launch_counts"]

SERVE_DTYPE_ENV = "ALINK_TPU_SERVE_DTYPE"
DTYPES = ("f32", "bf16", "int8")

# kernel mode codes of csrc/serve_score.cu: f32 mode splits by ship dtype
_MODE_CODES = {("f32", torch.float32): 0, ("f32", torch.float64): 1,
               ("bf16", torch.bfloat16): 2, ("int8", torch.float32): 3}
_WEIGHT_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}


def serve_dtype() -> str:
    """``ALINK_TPU_SERVE_DTYPE``: the serving score dtype — ``f32``
    (default: full ship precision) | ``bf16`` | ``int8``."""
    from ..common.flags import flag_value
    return str(flag_value(SERVE_DTYPE_ENV))


# ---------------------------------------------------------------------------
# weight quantization and low-precision model arrays
# ---------------------------------------------------------------------------

def quantize_int8(w: np.ndarray):
    """Symmetric per-model weight quantization: ``(w_q int8, scale)``
    with ``scale = max|w| / 127`` (1.0 for an all-zero model) and
    ``w_q = clip(round(w / scale), -127, 127)``."""
    a = float(np.max(np.abs(w))) if w.size else 0.0
    scale = a / 127.0 if a > 0.0 else 1.0
    q = np.clip(np.rint(np.asarray(w, np.float64) / scale),
                -127, 127).astype(np.int8)
    return q, np.float32(scale)


def lowp_model_arrays(w, b, dtype: str) -> Tuple[torch.Tensor, ...]:
    """The model-array tuple of one low-precision linear kernel, as CPU
    tensors: ``bf16`` -> (w_bf16, b_f32); ``int8`` -> (w_q, scale (1,)
    f32, b_f32)."""
    w = torch.as_tensor(np.asarray(w))
    b = torch.tensor(float(np.asarray(b)), dtype=torch.float32)
    if dtype == "bf16":
        return (w.to(torch.bfloat16).contiguous(), b)
    if dtype == "int8":
        q, scale = quantize_int8(w.numpy())
        return (torch.from_numpy(np.ascontiguousarray(q)),
                torch.tensor([float(scale)], dtype=torch.float32), b)
    raise ValueError(f"lowp_model_arrays: dtype {dtype!r} (want bf16/int8)")


def _unpack(model, dtype: str):
    """(w, scale or None, b) of a model-array tuple."""
    if dtype == "int8":
        q, scale, b = model
        return q, scale, b
    w, b = model
    return w, None, b


# ---------------------------------------------------------------------------
# the plain versions: the arithmetic of the kernels, in PyTorch ops
# ---------------------------------------------------------------------------

def _operand(dtype: str, x: torch.Tensor) -> torch.Tensor:
    """The request values in the mode's input type — the ONE cast the
    wrappers and the plain versions share."""
    if dtype == "bf16":
        return x.to(torch.bfloat16)
    if dtype == "int8":
        return x.to(torch.float32)
    return x


def _terms(dtype: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if dtype == "bf16":
        # bf16 x bf16 has at most 16 significant bits: exact in f32
        return x.float() * w.float()
    if dtype == "int8":
        return x * w.float()
    return x * w


def _fma_f32(acc: torch.Tensor, scale: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """``acc * scale + b`` rounded once to float32, as ``__fmaf_rn``
    and XLA's contracted FMA round it. The product is exact in float64
    (24 + 24 bits); the sum is taken in float64 with round-to-odd, and
    rounding that to float32 equals rounding the exact sum once
    (53 >= 24 + 2 bits)."""
    p = acc.double() * scale.double()
    bd = b.double()
    s = p + bd
    bv = s - p                                   # TwoSum: the exact
    err = (p - (s - bv)) + (bd - bv)             # error of s = p + bd
    even = (s.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(err)
    toward = torch.copysign(torch.full_like(s, math.inf), err)
    return torch.where(fix, torch.nextafter(s, toward), s).float()


def _link(dtype: str, acc: torch.Tensor, scale, b) -> torch.Tensor:
    if dtype == "int8":
        return _fma_f32(acc, scale, b)
    return acc + b


def dense_scores_plain(model, X: torch.Tensor, dtype: str) -> torch.Tensor:
    """Plain version of the dense kernel: ``s[i] = link(sum_j X[i,j] *
    w[j])`` with the kernel's term types, order and epilogue."""
    w, scale, b = _unpack(model, dtype)
    terms = _terms(dtype, _operand(dtype, X), w[None, :])
    return _link(dtype, seq_chunk_sum(terms, axis=1), scale, b)


def sparse_scores_plain(model, idx: torch.Tensor, val: torch.Tensor,
                        dtype: str) -> torch.Tensor:
    """Plain version of the sparse kernel: ``s[i] = link(sum_k
    val[i,k] * w[idx[i,k]])``."""
    w, scale, b = _unpack(model, dtype)
    terms = _terms(dtype, _operand(dtype, val), w[idx.long()])
    return _link(dtype, seq_chunk_sum(terms, axis=1), scale, b)


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

# launch counts: kept without a lock, as the FTRL wrappers keep theirs
_counts: Dict[str, int] = {"serve_dense": 0, "serve_sparse": 0}
_lib_lock = threading.Lock()
_fns: Optional[Dict[str, Callable[..., int]]] = None
_sms: Dict[int, int] = {}

_MAX_ROWS = 4               # csrc/serve_score.cu: kMaxRows
_STEP = 32                  # kStep: the terms the walker adds between loads
_MAX_CHUNK_BYTES = 2048     # kMaxChunkBytes
_SPARSE_MAX_WARPS = 4       # kSparseMaxWarps
_SPARSE_MAX_ROWS = 32       # kSparseMaxRows
_SPARSE_MAX_CHUNK = 256     # kSparseMaxChunk
H100_SMS = 132


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(_counts)


def reset_launch_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def _functions() -> Dict[str, Callable[..., int]]:
    """The built ``serve_score`` library's C functions, their signatures
    declared, resolved once."""
    global _fns
    if _fns is not None:
        return _fns
    with _lib_lock:
        if _fns is None:
            from ._build import load_library
            lib = load_library("serve_score")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.alink_serve_dense.argtypes = [i, p, p, p, p, p, i, i, i, i, p]
            lib.alink_serve_dense.restype = i
            lib.alink_serve_sparse.argtypes = [i, p, p, p, p, p, p, i, i, i,
                                               i, i, i, p]
            lib.alink_serve_sparse.restype = i
            lib.alink_cuda_error_string.argtypes = [i]
            lib.alink_cuda_error_string.restype = ctypes.c_char_p
            _fns = {"dense": lib.alink_serve_dense,
                    "sparse": lib.alink_serve_sparse,
                    "error_string": lib.alink_cuda_error_string}
        return _fns


class DensePlan(NamedTuple):
    """The launch shape of one dense-kernel call (``csrc/serve_score.cu``)."""
    rows: int       # rows a block, one warp each
    chunk: int      # columns a stage of the shared-memory ring


@functools.lru_cache(maxsize=256)
def _dense_plan(n: int, dim: int, itemsize: int,
                sms: int = H100_SMS) -> DensePlan:
    """Rows a block and chunk width of the dense kernel for ``n`` rows of
    ``dim`` values of ``itemsize`` bytes on a card of ``sms`` SMs. A row
    is one warp's chain, so the rows are spread to give every SM a block
    where ``n`` allows (``n // sms`` rows a block, 1 to 4); a chunk is a
    whole number of the walker's 32-term steps, at most 2 KB of a row and
    no wider than the row needs. Cached: a server asks for the same few
    bucket shapes again and again."""
    if n <= 0 or dim <= 0 or itemsize not in (2, 4, 8) or sms <= 0:
        raise ValueError(f"dense_scores: no plan for {n} x {dim} values of "
                         f"{itemsize} bytes on {sms} SMs")
    rows = max(1, min(_MAX_ROWS, n // sms))
    chunk = min(_MAX_CHUNK_BYTES // itemsize, -(-dim // _STEP) * _STEP)
    return DensePlan(rows, chunk)


class SparsePlan(NamedTuple):
    """The launch shape of one sparse-kernel call (``csrc/serve_score.cu``)."""
    rows: int       # rows a warp, one walking lane each
    warps: int      # warps a block
    chunk: int      # terms a warp forms between two walks


@functools.lru_cache(maxsize=256)
def _sparse_plan(n: int, width: int, sms: int = H100_SMS) -> SparsePlan:
    """Rows a warp, warps a block and terms a pass of the sparse kernel for
    ``n`` rows of ``width`` slots on a card of ``sms`` SMs. A block takes
    ``n // sms`` rows (at least one), so that every SM gets a block where
    ``n`` allows: up to 4 rows as one warp each, more as 4 warps of up to
    32 rows. A pass forms a warp's rows' terms, up to 256 (a multiple of
    32, no more than the rows need). Cached, as :func:`_dense_plan`."""
    if n <= 0 or width < 0 or sms <= 0:
        raise ValueError(f"sparse_scores: no plan for {n} rows of width "
                         f"{width} on {sms} SMs")
    per_block = max(1, n // sms)
    if per_block <= _SPARSE_MAX_WARPS:
        warps, rows = per_block, 1
    else:
        warps = _SPARSE_MAX_WARPS
        rows = min(_SPARSE_MAX_ROWS, per_block // warps)
    chunk = min(_SPARSE_MAX_CHUNK, max(_STEP, -(-rows * width // _STEP)
                                       * _STEP))
    return SparsePlan(rows, warps, chunk)


def _sm_count(index: int) -> int:
    sms = _sms.get(index)
    if sms is None:
        sms = _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return sms


def _check(name: str, dtype: str, x: torch.Tensor, w: torch.Tensor,
           scale, b: torch.Tensor, extra=()) -> int:
    """Validate what the kernel reads; returns its mode code."""
    if not x.is_cuda:
        raise ValueError(f"{name}: tensors on {x.device}; the kernel takes "
                         f"CUDA tensors and the plain version CPU ones")
    index = x.get_device()
    for t in (x, w, b, scale, *extra):
        if t is not None and (t.get_device() != index
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: every tensor must be contiguous and "
                             f"on {x.device}, got {t.device}")
    mode = _MODE_CODES.get((dtype, x.dtype))
    if mode is None:
        raise ValueError(f"{name}: mode {dtype!r} takes no {x.dtype} "
                         f"request values")
    want_w = _WEIGHT_DTYPES.get(dtype, x.dtype)
    want_b = x.dtype if dtype == "f32" else torch.float32
    if w.dtype != want_w or b.dtype != want_b or b.numel() != 1:
        raise ValueError(f"{name}: mode {dtype!r} wants weights {want_w} "
                         f"and one bias {want_b}, got {w.dtype} and "
                         f"{b.numel()} x {b.dtype}")
    if dtype == "int8" and (scale.dtype != torch.float32
                            or scale.numel() != 1):
        raise ValueError(f"{name}: int8 mode wants one float32 scale")
    if w.dim() != 1 or max(x.shape) >= 2 ** 31 or w.numel() >= 2 ** 31:
        raise ValueError(f"{name}: weights {tuple(w.shape)} and values "
                         f"{tuple(x.shape)} exceed the kernel's int sizes")
    return mode


def _launch(name: str, kind: str, index: int, *args) -> None:
    """Call the library's ``kind`` entry on device ``index``'s current
    stream; count the launch or raise."""
    fns = _functions()
    rc = _build.call(fns[kind], index, *args)
    if rc != 0:
        msg = fns["error_string"](rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    _counts[name] += 1


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _empty_out(dtype: str, x: torch.Tensor, n: int) -> torch.Tensor:
    """The (n,) scores: the ship dtype in f32 mode, else float32."""
    return x.new_empty(n) if dtype == "f32" else \
        x.new_empty(n, dtype=torch.float32)


def dense_scores(model, X: torch.Tensor, dtype: str) -> torch.Tensor:
    """Scores of a dense request block ``X`` (rows, dim8) against the
    model arrays: the fused dense kernel on the card, its plain version
    on the CPU. Replaces ``alink_tpu/kernels/serve.py::
    _fused_dense_call``."""
    if X.device.type == "cpu":
        return dense_scores_plain(model, X, dtype)
    w, scale, b = _unpack(model, dtype)
    x = _operand(dtype, X)
    mode = _check("dense_scores", dtype, x, w, scale, b)
    if x.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"dense_scores: values {tuple(x.shape)} vs "
                         f"weights {tuple(w.shape)}")
    n, dim = x.shape
    out = _empty_out(dtype, x, n)
    if n:
        index = x.get_device()
        plan = _dense_plan(n, dim, x.element_size(), _sm_count(index))
        _launch("serve_dense", "dense", index, mode, _ptr(x), _ptr(w),
                _ptr(scale), _ptr(b), _ptr(out), n, dim, plan.rows,
                plan.chunk)
    return out


def sparse_scores(model, idx: torch.Tensor, val: torch.Tensor,
                  dtype: str) -> torch.Tensor:
    """Scores of a padded-COO request block (``idx``/``val``, rows x
    width) against the model arrays: the fused sparse kernel on the
    card, its plain version on the CPU. Every index must lie in
    ``[0, len(w))``; the encoder checks it on the host. Replaces
    ``alink_tpu/kernels/serve.py::_fused_sparse_call``."""
    if val.device.type == "cpu":
        return sparse_scores_plain(model, idx, val, dtype)
    w, scale, b = _unpack(model, dtype)
    v = _operand(dtype, val)
    mode = _check("sparse_scores", dtype, v, w, scale, b, extra=(idx,))
    if idx.dtype != torch.int32 or idx.shape != v.shape or v.dim() != 2:
        raise ValueError(f"sparse_scores: want int32 indices shaped like "
                         f"the values, got {idx.dtype} {tuple(idx.shape)} "
                         f"and {tuple(v.shape)}")
    n, width = v.shape
    out = _empty_out(dtype, v, n)
    if n:
        index = v.get_device()
        plan = _sparse_plan(n, width, _sm_count(index))
        _launch("serve_sparse", "sparse", index, mode, _ptr(idx), _ptr(v),
                _ptr(w), _ptr(scale), _ptr(b), _ptr(out), n, width,
                w.shape[0], plan.rows, plan.warps, plan.chunk)
    return out


def make_score_fns(dtype: str):
    """The linear family's ``device_fns`` under one serving dtype:
    ``{kind: fn(model_arrays, *encoded)}``."""
    if dtype not in DTYPES:
        raise ValueError(f"serving dtype {dtype!r}: want one of {DTYPES}")
    return {"dense": lambda mdl, X: dense_scores(mdl, X, dtype),
            "sparse": lambda mdl, idx, val: sparse_scores(mdl, idx, val,
                                                          dtype)}
