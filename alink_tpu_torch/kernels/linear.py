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
by key (``perm``) and each slot's run in it (``starts``). It also keeps
the design's keys and values for :func:`sparse_margins`.

:func:`sparse_margins` is the forward product ``eta[i] = sum_k
val[i, k] * w[keys[i, k]]``: the sparse serving score kernel
(``kernels/serve.py::sparse_scores`` in ``f32`` mode, zero bias), each
row's terms added left to right from zero, so training margins equal
served scores.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Dict, NamedTuple, Optional

import torch

from . import _build
from .serve import sparse_scores

__all__ = ["GradPlan", "grad_plan", "linear_grad", "linear_grad_plain",
           "sparse_margins", "launch_counts", "reset_launch_counts"]

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
_BLOCKS_PER_SM = 8          # resident blocks of 8 warps an SM: the grid


class GradPlan(NamedTuple):
    """The data-constant tensors of one sparse design (one device)."""
    keys: torch.Tensor      # (n, width) int32 slots, contiguous
    val: torch.Tensor       # (n, width) values, contiguous
    perm: torch.Tensor      # (n * width,) int32 positions in slot order
    starts: torch.Tensor    # (dim + 1,) int32: slot s's run is
    #                         perm[starts[s]:starts[s + 1]]
    dim: int


def grad_plan(keys: torch.Tensor, dim: int, val: torch.Tensor) -> GradPlan:
    """The plan of a design with ``keys`` (n, width) in ``[0, dim)`` and
    values ``val`` (n, width), on the keys' device: a stable sort of the
    flat keys and the start of each slot's run. A key outside
    ``[0, dim)`` raises ``IndexError`` (one host read, once a
    training)."""
    if keys.dim() != 2:
        raise ValueError(f"grad_plan: keys {tuple(keys.shape)}; want (n, w)")
    n, width = keys.shape
    if n * width >= 2 ** 31 or dim >= 2 ** 31:
        raise ValueError(f"grad_plan: {n} x {width} positions over {dim} "
                         f"slots exceed the kernel's int sizes")
    flat = keys.reshape(-1).long()
    if flat.numel() and (int(flat.min()) < 0 or int(flat.max()) >= dim):
        raise IndexError(f"grad_plan: keys outside [0, {dim})")
    perm = torch.sort(flat, stable=True).indices.to(torch.int32)
    starts = torch.zeros(dim + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(torch.bincount(flat, minlength=dim), 0, out=starts[1:])
    if val.shape != keys.shape:
        raise ValueError(f"grad_plan: values {tuple(val.shape)} vs keys "
                         f"{tuple(keys.shape)}")
    return GradPlan(keys.to(torch.int32).contiguous(), val.contiguous(),
                    perm.contiguous(), starts.to(torch.int32), int(dim))


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
_grids: Dict[int, int] = {}


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
            lib.alink_linear_grad.argtypes = [i, p, p, p, p, p, i, i, i, p]
            lib.alink_linear_grad.restype = i
            lib.alink_linear_error_string.argtypes = [i]
            lib.alink_linear_error_string.restype = ctypes.c_char_p
            _fns = {"grad": lib.alink_linear_grad,
                    "error_string": lib.alink_linear_error_string}
        return _fns


def _grid(index: int, dim: int) -> int:
    """Blocks of the launch: one warp a slot up to the resident blocks."""
    cap = _grids.get(index)
    if cap is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        cap = _grids[index] = sms * _BLOCKS_PER_SM
    return max(1, min(cap, -(-dim // 8)))


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
                                                     plan.starts))):
        raise ValueError(f"linear_grad: want c ({val.shape[0]},) of "
                         f"{val.dtype} on {val.device} (float32 or "
                         f"float64), got {c.dtype} {tuple(c.shape)} on "
                         f"{c.device}")
    out = torch.empty(plan.dim, dtype=val.dtype, device=val.device)
    fns = _fns or _functions()
    rc = _build.call(fns["grad"], index, code, plan.perm.data_ptr(),
                     plan.starts.data_ptr(), val.data_ptr(), c.data_ptr(),
                     out.data_ptr(), plan.dim, max(1, val.shape[1]),
                     _grid(index, plan.dim))
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
