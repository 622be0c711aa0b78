"""Objective functions for linear-model training.

Counterpart: ``alink_tpu/operator/common/optim/objfunc.py`` (the
reference's OptimObjFunc.java and UnaryLossObjFunc.java). An objective
is a function over a **shard** of training data held as tensors on one
device, dense ``{"X"}``, padded-COO ``{"idx", "val"}`` or field-blocked
``{"fb_idx"[, "fb_val"]}``, plus ``{"y", "w"}``, returning unnormalized
sums (grad, loss, weight). Sample weights double as the padding mask.

The design-matrix products:

* dense — ``X @ coef`` and ``X.T @ c``, ``torch.matmul`` in the ship
  dtype (no TF32);
* padded-COO — margins through the sparse score kernel
  (``kernels/linear.py::sparse_margins``: each row left to right from
  zero, where the JAX package's row sum is XLA's), gradient through the
  ordered gradient kernel (``kernels/linear.py::linear_grad``: bitwise
  the JAX package's scatter-add on the CPU);
* field-blocked — ``ops/fieldblock.py``, in float32 whatever the ship
  dtype, as the JAX package computes it.

A shard may carry ``"__design"``, the design's
:class:`~alink_tpu_torch.kernels.linear.GradPlan` (:func:`design_plan`,
built once a training by the optimizers); without it each product builds
what it needs.

Ported: ``UnaryLossFunc``, ``LogLossFunc``, ``OptimObjFunc`` and
``UnaryLossObjFunc`` (gradient and line search). The other eight unary
losses, ``SoftmaxObjFunc``, ``hessian_shard`` and ``densify_shard`` are
not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ....kernels.linear import GradPlan, grad_plan, linear_grad, sparse_margins
from ....ops.fieldblock import fb_flat, fb_matvec, fb_rmatvec, fb_values

DESIGN = "__design"


# ---------------------------------------------------------------------------
# unary losses: loss(eta, y) and d loss / d eta, y in {-1, +1}
# ---------------------------------------------------------------------------

class UnaryLossFunc:
    name = "base"

    def loss(self, eta, y):  # pragma: no cover - interface
        raise NotImplementedError

    def derivative(self, eta, y):  # pragma: no cover - interface
        raise NotImplementedError


class LogLossFunc(UnaryLossFunc):
    """logistic loss (reference unarylossfunc/LogLossFunc.java)."""
    name = "log"

    def loss(self, eta, y):
        # log(1 + exp(-y*eta)), stable
        m = -y * eta
        return torch.logaddexp(torch.zeros_like(m), m)

    def derivative(self, eta, y):
        return -y * torch.sigmoid(-y * eta)


# ---------------------------------------------------------------------------
# design-matrix ops over a data shard
# ---------------------------------------------------------------------------

def _need_meta(fb_meta):
    if fb_meta is None:
        raise ValueError("shard has 'fb_idx' but no FieldBlockMeta was "
                         "provided (pass fb_meta= to the objective)")


def design_plan(data: Dict, dim: int, fb_meta=None) -> Optional[GradPlan]:
    """The data-constant plan of a sparse shard (None for a dense one):
    flat keys, values and the gradient's run plan. Field-blocked values
    are float32, padded-COO ones keep their dtype."""
    if "X" in data:
        return None
    if "fb_idx" in data:
        _need_meta(fb_meta)
        fb_idx = data["fb_idx"]
        return grad_plan(fb_flat(fb_idx, fb_meta), fb_meta.dim,
                         fb_values(fb_idx, data.get("fb_val")))
    return grad_plan(data["idx"].to(torch.int32), dim, data["val"])


def matvec(data: Dict, coef, fb_meta=None):
    """margins = X @ coef for a dense, padded-COO or field-blocked shard."""
    if "X" in data:
        return data["X"] @ coef
    plan = data.get(DESIGN)
    if "fb_idx" in data:
        _need_meta(fb_meta)
        return fb_matvec(data["fb_idx"], coef, fb_meta,
                         val=data.get("fb_val"), plan=plan)
    if plan is not None:
        return sparse_margins(plan.keys, plan.val, coef)
    return sparse_margins(data["idx"].to(torch.int32).contiguous(),
                          data["val"].contiguous(), coef)


def rmatvec(data: Dict, c, dim: int, fb_meta=None):
    """X^T @ c, the gradient accumulation."""
    if "X" in data:
        return data["X"].T @ c
    plan = data.get(DESIGN)
    if "fb_idx" in data:
        _need_meta(fb_meta)
        return fb_rmatvec(data["fb_idx"], c, fb_meta,
                          val=data.get("fb_val"), plan=plan)
    if plan is None:
        plan = design_plan(data, dim)
    return linear_grad(plan, c.contiguous())


class OptimObjFunc:
    """Base objective: per-shard grad/loss + global regularization."""

    def __init__(self, dim: int, l1: float = 0.0, l2: float = 0.0,
                 reg_free_head: int = 0):
        self.dim = int(dim)
        self.l1 = float(l1)
        self.l2 = float(l2)
        # first `reg_free_head` coefficients (the intercept) are unregularized
        self.reg_free_head = int(reg_free_head)
        self._masks: Dict[tuple, torch.Tensor] = {}

    def _reg_mask(self, coef):
        key = (coef.device, coef.dtype)
        m = self._masks.get(key)
        if m is None:
            m = torch.ones(self.dim, dtype=coef.dtype, device=coef.device)
            m[:self.reg_free_head] = 0.0
            self._masks[key] = m
        return m

    def regular_loss(self, coef):
        """The regularization of ``coef`` (dim,), or of each row of a
        ``(k, dim)`` stack of coefficient vectors."""
        cm = coef * self._reg_mask(coef)
        return (0.5 * self.l2 * (cm ** 2).sum(-1)
                + self.l1 * torch.abs(cm).sum(-1))

    def l2_grad(self, coef):
        return self.l2 * coef * self._reg_mask(coef)

    # interface ----------------------------------------------------------
    def calc_grad_shard(self, data, coef):
        """-> (grad_sum, loss_sum, weight_sum) — unnormalized shard sums."""
        raise NotImplementedError

    def calc_grad_eta_shard(self, data, coef):
        """-> (grad, loss, wsum, eta); eta (per-shard margins at coef) may be
        passed back to line_losses_shard to skip recomputing the matvec."""
        grad, loss, wsum = self.calc_grad_shard(data, coef)
        return grad, loss, wsum, None

    def line_losses_shard(self, data, coef, direction, steps, eta0=None):
        """losses at coef - steps[j]*direction -> (num_steps,) shard sums."""
        raise NotImplementedError


class UnaryLossObjFunc(OptimObjFunc):
    """sum_i w_i * loss(x_i . coef, y_i) (reference common/linear/UnaryLossObjFunc.java).

    ``fb_meta`` (ops.fieldblock.FieldBlockMeta) selects the field-blocked
    products when the shard carries ``fb_idx``. Float32 field-blocked
    margins are widened to the ship dtype before the loss, as the JAX
    package's type promotion widens them.
    """

    def __init__(self, unary_loss: UnaryLossFunc, dim: int, l1=0.0, l2=0.0,
                 reg_free_head: int = 0, fb_meta=None):
        super().__init__(dim, l1, l2, reg_free_head)
        self.unary_loss = unary_loss
        if fb_meta is not None and fb_meta.dim != self.dim:
            raise ValueError(f"fb_meta.dim {fb_meta.dim} != objective dim "
                             f"{self.dim} (dim must be num_fields*field_size)")
        self.fb_meta = fb_meta

    def calc_grad_shard(self, data, coef):
        grad, loss, wsum, _ = self.calc_grad_eta_shard(data, coef)
        return grad, loss, wsum

    def calc_grad_eta_shard(self, data, coef):
        """(grad, loss, wsum, eta) — eta is reusable by the same-superstep
        line search (margins at the unmoved coef), saving one matvec pass."""
        eta = matvec(data, coef, self.fb_meta)
        y, w = data["y"], data["w"]
        e = eta.to(torch.promote_types(eta.dtype, y.dtype))
        loss = (w * self.unary_loss.loss(e, y)).sum()
        c = w * self.unary_loss.derivative(e, y)
        grad = rmatvec(data, c, self.dim, self.fb_meta)
        return grad, loss, w.sum(), eta

    def line_losses_shard(self, data, coef, direction, steps, eta0=None):
        if eta0 is None:
            eta0 = matvec(data, coef, self.fb_meta)
        etad = matvec(data, direction, self.fb_meta)
        y, w = data["y"], data["w"]
        dt = torch.promote_types(eta0.dtype, steps.dtype)
        eta = eta0.to(dt)[None, :] - steps[:, None] * etad.to(dt)[None, :]
        return (w[None, :] * self.unary_loss.loss(eta, y[None, :])).sum(-1)
