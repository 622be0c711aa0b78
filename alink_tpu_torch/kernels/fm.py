"""The FM serving score, "P4": CUDA wrapper and plain versions.

No TPU kernel is replaced here. The JAX package scores an FM model in
``FmModelMapper.serving_kernel`` (``alink_tpu/operator/batch/
classification/fm_ops.py``, ``_dense`` and ``_sparse``) with XLA programs
of ``serving/sharded.py::scan_sum``: every feature and factor summed
strictly left to right, so that padding is a bitwise no-op. PyTorch ops
give that order only as a loop over the row's width, a set of launches a
position; :func:`fm_scores` is a CUDA kernel written by hand for Hopper
(``csrc/fm_score.cu``) that keeps it in one launch. :func:`fm_scores_plain`
is its plain version. Given CPU tensors the wrapper runs the plain
version; given CUDA tensors it launches the kernel or raises.

**Contract.** For each row ``margin = (w0 + lin) + 0.5 * sum_f (s_f * s_f
- q_f)``, ``lin = sum_j val_j * w[idx_j]``, ``s_f = sum_j val_j * V[idx_j,
f]``, ``q_f = sum_j (val_j * val_j) * (V[idx_j, f] * V[idx_j, f])``:
every sum left to right from ``+0.0``, every product rounded on its own.
The dense layout (``idx`` None) is the same with ``idx_j = j``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from . import _build

__all__ = ["fm_scores", "fm_scores_plain", "launch_counts",
           "reset_launch_counts"]

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def fm_scores_plain(model: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                    idx: Optional[torch.Tensor],
                    val: torch.Tensor) -> torch.Tensor:
    """The contract with torch ops: one position at a time over the
    row's width, each product and add a rounded op. ``model`` is ``(w0,
    w, V)``: ``w0`` one value, ``w`` (dim,), ``V`` (dim, k); ``val`` (n,
    width) with ``idx`` (n, width) (sparse) or ``None`` (dense, width =
    dim). Returns (n,) margins."""
    w0, w, V = model
    n, width = val.shape
    lin = val.new_zeros(n)
    s = val.new_zeros((n, V.shape[1]))
    q = val.new_zeros((n, V.shape[1]))
    for j in range(width):
        x = val[:, j]
        if idx is None:
            wj, vj = w[j].expand(n), V[j].expand(n, -1)
        else:
            col = idx[:, j].long()
            wj, vj = w[col], V[col]
        lin = lin + x * wj
        s = s + x[:, None] * vj
        q = q + (x * x)[:, None] * (vj * vj)
    t = s * s - q
    acc = val.new_zeros(n)
    for f in range(t.shape[1]):
        acc = acc + t[:, f]
    return (w0.reshape(()) + lin) + 0.5 * acc


# launch counts: kept without a lock, as the other wrappers keep theirs
_counts: Dict[str, int] = {"fm_score": 0}
_lib_lock = threading.Lock()
_fns: Optional[Dict[str, Callable[..., int]]] = None


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(_counts)


def reset_launch_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def _functions() -> Dict[str, Callable[..., int]]:
    """The built ``fm_score`` library's C functions, resolved once."""
    global _fns
    if _fns is not None:
        return _fns
    with _lib_lock:
        if _fns is None:
            lib = _build.load_library("fm_score")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.alink_fm_score.argtypes = [i, p, p, p, p, p, p, i, i, i, i, p]
            lib.alink_fm_score.restype = i
            lib.alink_fm_score_error_string.argtypes = [i]
            lib.alink_fm_score_error_string.restype = ctypes.c_char_p
            _fns = {"score": lib.alink_fm_score,
                    "error_string": lib.alink_fm_score_error_string}
        return _fns


def fm_scores(model: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
              idx: Optional[torch.Tensor], val: torch.Tensor) -> torch.Tensor:
    """The FM margins of ``val``'s rows (sparse with ``idx``, dense
    without), arguments as :func:`fm_scores_plain`: the kernel on the
    card (one launch, a warp a row), the plain version on the CPU. Every
    tensor contiguous, of one dtype (float32 or float64), ``idx`` int32
    in ``[0, dim)``."""
    if val.device.type == "cpu":
        return fm_scores_plain(model, idx, val)
    w0, w, V = model
    code = _DTYPE_CODES.get(val.dtype)
    index = val.get_device()
    tensors = (w0, w, V, val) + (() if idx is None else (idx,))
    n, width = val.shape if val.dim() == 2 else (0, -1)
    dim = w.shape[0] if w.dim() == 1 else 0
    if (code is None or n < 1 or dim < 1 or w0.numel() != 1
            or V.dim() != 2 or V.shape[0] != dim or V.shape[1] < 1
            or any(t.dtype != val.dtype for t in (w0, w, V))
            or (idx is None and width != dim)
            or (idx is not None and (idx.dtype != torch.int32
                                     or idx.shape != val.shape))
            or any(t.get_device() != index or not t.is_contiguous()
                   for t in tensors)
            or val.numel() >= 2 ** 31 or V.numel() >= 2 ** 31):
        raise ValueError(
            f"fm_scores: want contiguous tensors of one float dtype on one "
            f"CUDA device: w0 (1 value), w (dim,), V (dim, k), val (n, "
            f"width) and int32 idx of val's shape (or None and width = "
            f"dim); got {[(t.dtype, tuple(t.shape), str(t.device)) for t in tensors]}")
    out = val.new_empty(n)
    fns = _fns or _functions()
    rc = _build.call(fns["score"], index, code,
                     0 if idx is None else idx.data_ptr(), val.data_ptr(),
                     w0.data_ptr(), w.data_ptr(), V.data_ptr(),
                     out.data_ptr(), n, width, dim, V.shape[1])
    if rc != 0:
        msg = fns["error_string"](rc).decode()
        raise RuntimeError(f"fm_scores: kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    _counts["fm_score"] += 1
    return out
