"""Batched small dense solves.

Counterpart: ``alink_tpu/ops/smallsolve.py::batched_spd_solve``. The
rank-sized SPD normal equations of ALS (the reference's
NormalEquation.java Cholesky) are solved by the JAX package's unrolled
Gauss-Jordan over the augmented ``[A | I]``, without pivoting (valid for
SPD: the running pivot is a Schur complement's diagonal, positive by
definiteness), then one batched product of the inverse with ``b``. The
port keeps that elimination order, and not ``torch.linalg.solve`` or a
Cholesky, whose LU or triangular solves round in another order.

The final product goes through ``torch.einsum`` (a batched matrix
product); a float32 call on the card must not run in TF32, which the
trainer refuses once a training (``objfunc.check_full_float32``).
Accuracy: about 1e-6 relative on ridge-regularized float32 batches, as
the JAX package's docstring pins.
"""

from __future__ import annotations

import torch


def batched_spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` for a batch of small SPD systems.

    ``A``: (..., n, n) SPD, ``b``: (..., n), ``n`` small (the elimination
    unrolls ``n`` steps of a few elementwise ops each). Returns (..., n).
    """
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    M = torch.cat([A, eye], dim=-1)
    for i in range(n):
        piv = M[..., i, :] / M[..., i, i:i + 1]
        M = M - M[..., :, i:i + 1] * piv[..., None, :]
        M[..., i, :] = piv
    return torch.einsum("...ij,...j->...i", M[..., :, n:], b)
