"""The sparse design products of linear training: the ordered gradient
kernel, its plan and plain version, and the margins.

No TPU kernel is replaced here. The JAX package computes the gradient
``X^T c`` of a padded-COO design with an XLA scatter-add
(``alink_tpu/operator/common/optim/objfunc.py::rmatvec``) and of a
field-blocked one with a one-hot product
(``alink_tpu/ops/fieldblock.py::fb_rmatvec``). On the card PyTorch's
``index_add_`` adds with atomics, so two trainings would not give the
same bits; :func:`linear_grad` is a CUDA kernel written by hand for
Hopper (``csrc/linear_grad.cu``) that adds in a fixed order instead.
:func:`linear_grad_plain` is its plain version. Given CPU tensors the
wrapper runs the plain version; given CUDA tensors it launches the
kernel or raises.

**Contract.** ``grad[s] = sum val[i, k] * c[i]`` over the positions
``(i, k)`` with ``keys[i, k] == s``: each product rounded on its own,
then added in flattened (row, column) order from ``+0.0``. On the CPU
that is what the JAX package's scatter-add computes and what
``index_add_`` computes, which is the plain version (pinned to a Python
loop by ``tests/test_torch_linear_grad.py``). The plain version is
ordered on the CPU only; on the card ``index_add_`` is the library call
the kernel is timed against.

**The plan** (:func:`grad_plan`) is built once a training, as the key
layout does not change between supersteps: the positions stably sorted
by key (``perm``), each slot's run in it (``starts``), and the slots in
the kernel's order (``order``: runs of more than :data:`SHORT_MAX` terms
by length, longest first, then the rest by slot), with the count of
heavy runs (at least :data:`HEAVY_MIN` terms: each walked by a cluster
of two blocks, one walker thread fed by a block of producer warps) and
of medium runs (more than :data:`SHORT_MAX`: a warp each); the short rest
goes one lane a run. It also keeps the design's keys and values for
:func:`sparse_margins`.

:func:`sparse_margins` is the forward product ``eta[i] = sum_k
val[i, k] * w[keys[i, k]]``: the sparse serving score kernel
(``kernels/serve.py::sparse_scores`` in ``f32`` mode, zero bias), each
row's terms added left to right from zero, so training margins equal
served scores.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from . import _build
from .serve import sparse_scores

__all__ = ["GradPlan", "grad_plan", "linear_grad", "linear_grad_plain",
           "sparse_margins", "launch_counts", "reset_launch_counts",
           "HEAVY_MIN", "SHORT_MAX"]

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
HEAVY_MIN = 2048            # a heavy run's least length: two ring slots
SHORT_MAX = 32              # a short run's most length: one lane walks it
_WARPS = 8                  # warps a block (csrc/linear_grad.cu kWarps)
_BLOCKS_PER_SM = 8          # light blocks an SM with no heavy run (2048
#                             threads; registers may allow fewer)


class GradPlan(NamedTuple):
    """The data-constant tensors of one sparse design (one device)."""
    keys: torch.Tensor      # (n, width) int32 slots, contiguous
    val: torch.Tensor       # (n, width) values, contiguous
    perm: torch.Tensor      # (n * width,) int32 positions in slot order
    starts: torch.Tensor    # (dim + 1,) int32: slot s's run is
    #                         perm[starts[s]:starts[s + 1]]
    dim: int
    order: torch.Tensor     # (dim,) int32 slots: the heavy and medium
    #                         runs by length, longest first (ties by slot),
    #                         then the short runs by slot
    n_heavy: int            # runs of at least HEAVY_MIN terms
    n_medium: int           # the other runs of more than SHORT_MAX


def grad_plan(keys: torch.Tensor, dim: int, val: torch.Tensor) -> GradPlan:
    """The plan of a design with ``keys`` (n, width) in ``[0, dim)`` and
    values ``val`` (n, width), on the keys' device: a stable sort of the
    flat keys, the start of each slot's run, and the slots in the
    kernel's order with the heavy and medium counts. A key outside
    ``[0, dim)`` raises ``IndexError``. Two host reads, once a training:
    the keys' range and the two counts."""
    if keys.dim() != 2:
        raise ValueError(f"grad_plan: keys {tuple(keys.shape)}; want (n, w)")
    n, width = keys.shape
    if n * width >= 2 ** 31 or dim >= 2 ** 31:
        raise ValueError(f"grad_plan: {n} x {width} positions over {dim} "
                         f"slots exceed the kernel's int sizes")
    if val.shape != keys.shape:
        raise ValueError(f"grad_plan: values {tuple(val.shape)} vs keys "
                         f"{tuple(keys.shape)}")
    flat = keys.reshape(-1).long()
    if flat.numel():
        lo, hi = torch.stack([flat.min(), flat.max()]).tolist()
        if lo < 0 or hi >= dim:
            raise IndexError(f"grad_plan: keys outside [0, {dim})")
    perm = torch.sort(flat, stable=True).indices.to(torch.int32)
    counts = torch.bincount(flat, minlength=dim)
    starts = torch.zeros(dim + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(counts, 0, out=starts[1:])
    # heavy and medium runs by length, longest first; short runs after them
    # in slot order, so a warp's lanes read neighbouring bounds and runs
    order = torch.sort(torch.where(counts > SHORT_MAX, -counts, 0),
                       stable=True).indices
    n_heavy, n_long = torch.stack([(counts >= HEAVY_MIN).sum(),
                                   (counts > SHORT_MAX).sum()]).tolist()
    return GradPlan(keys.to(torch.int32).contiguous(), val.contiguous(),
                    perm.contiguous(), starts.to(torch.int32), int(dim),
                    order.to(torch.int32), n_heavy, n_long - n_heavy)


def linear_grad_plain(plan: GradPlan, c: torch.Tensor) -> torch.Tensor:
    """``grad[s] = sum val * c`` as ``index_add_`` adds it: on the CPU in
    flattened position order from ``+0.0``, the contract's order."""
    terms = (plan.val * c[:, None]).reshape(-1)
    return torch.zeros(plan.dim, dtype=terms.dtype,
                       device=terms.device).index_add_(
        0, plan.keys.reshape(-1).long(), terms)


# launch counts: kept without a lock, as the other wrappers keep theirs
_counts: Dict[str, int] = {"linear_grad": 0}
_lib_lock = threading.Lock()
_fns: Optional[Dict[str, Callable[..., int]]] = None
_sms: Dict[int, int] = {}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(_counts)


def reset_launch_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def _functions() -> Dict[str, Callable[..., int]]:
    """The built ``linear_grad`` library's C functions, resolved once."""
    global _fns
    if _fns is not None:
        return _fns
    with _lib_lock:
        if _fns is None:
            lib = _build.load_library("linear_grad")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.alink_linear_grad.argtypes = [i, p, p, p, p, p, p, i,
                                              ctypes.c_uint, i, i, i, i, i, p]
            lib.alink_linear_grad.restype = i
            lib.alink_linear_error_string.argtypes = [i]
            lib.alink_linear_error_string.restype = ctypes.c_char_p
            _fns = {"grad": lib.alink_linear_grad,
                    "error_string": lib.alink_linear_error_string}
        return _fns


@functools.lru_cache(maxsize=None)
def div_magic(width: int) -> Tuple[int, int]:
    """``(magic, shift)`` with ``p // width == (p * magic) >> shift`` for
    every ``0 <= p < 2**31``: ``shift = 31 + ceil(log2 width)``, ``magic =
    ceil(2**shift / width) < 2**32`` (Granlund and Montgomery's round-up
    method at 31-bit numerators). The kernel's row of a position."""
    if not 0 < width < 2 ** 31:
        raise ValueError(f"div_magic: width {width}")
    shift = 31 + (width - 1).bit_length()
    return -(-(1 << shift) // width), shift


def launch_grid(sms: int, plan: GradPlan) -> Tuple[int, int]:
    """``(heavy_blocks, light_blocks)`` of the launch on a card of ``sms``
    SMs. A heavy run is walked by a cluster of two blocks, each holding an
    SM alone (the launch asks for all the shared memory), so with heavy
    runs there are at most a quarter of the SMs' clusters of them and the
    light blocks take the other SMs, one each, in an even number; with
    none, the light blocks fill every SM. A light block's 8 warps take a
    medium run each or 32 short runs each, striding over them."""
    n_short = plan.dim - plan.n_heavy - plan.n_medium
    light = -(-(plan.n_medium + -(-n_short // 32)) // _WARPS)
    if plan.n_heavy:
        clusters = min(plan.n_heavy, max(1, sms // 4))
        free = max(2, (sms - 2 * clusters) // 2 * 2)
        return 2 * clusters, min(light + light % 2, free)
    return 0, max(1, min(light, sms * _BLOCKS_PER_SM))


def _grid(index: int, plan: GradPlan) -> Tuple[int, int]:
    sms = _sms.get(index)
    if sms is None:
        sms = _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return launch_grid(sms, plan)


def linear_grad(plan: GradPlan, c: torch.Tensor) -> torch.Tensor:
    """``grad = X^T c`` of the plan's design, ``(dim,)`` in the values'
    dtype: the ordered gradient kernel on the card, its plain version on
    the CPU. ``c`` (n,) must have the values' dtype."""
    if c.device.type == "cpu":
        return linear_grad_plain(plan, c)
    val = plan.val
    code = _DTYPE_CODES.get(val.dtype)
    index = val.get_device()
    if (code is None or c.dtype != val.dtype or c.dim() != 1
            or c.shape[0] != val.shape[0] or not c.is_contiguous()
            or any(t.get_device() != index for t in (c, plan.perm,
                                                     plan.starts,
                                                     plan.order))):
        raise ValueError(f"linear_grad: want c ({val.shape[0]},) of "
                         f"{val.dtype} on {val.device} (float32 or "
                         f"float64), got {c.dtype} {tuple(c.shape)} on "
                         f"{c.device}")
    out = torch.empty(plan.dim, dtype=val.dtype, device=val.device)
    fns = _fns or _functions()
    rc = _build.call(fns["grad"], index, code, plan.perm.data_ptr(),
                     plan.starts.data_ptr(), plan.order.data_ptr(),
                     val.data_ptr(), c.data_ptr(), out.data_ptr(), plan.dim,
                     *div_magic(max(1, val.shape[1])), plan.n_heavy,
                     plan.n_medium, *_grid(index, plan))
    if rc != 0:
        msg = fns["error_string"](rc).decode()
        raise RuntimeError(f"linear_grad: kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    _counts["linear_grad"] += 1
    return out


_zero_bias: Dict[tuple, torch.Tensor] = {}


def sparse_margins(keys: torch.Tensor, val: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """``eta[i] = sum_k val[i, k] * w[keys[i, k]]`` in ``val``'s dtype,
    each row added left to right from zero: the sparse score kernel
    (``f32`` mode) with a zero bias on the card, its plain version on
    the CPU."""
    key = (val.device, val.dtype)
    b = _zero_bias.get(key)
    if b is None:
        b = _zero_bias[key] = torch.zeros(1, dtype=val.dtype,
                                          device=val.device)
    return sparse_scores((w, b), keys, val, "f32")
