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
built once a run by the optimizers, on its entry superstep: the init
pass, or the first superstep after a resume, since a snapshot does not
hold it); without it each product builds what it needs.

Softmax runs the same kernels once for each non-pivot class column: its
padded-COO logits are ``k - 1`` sparse-margin launches and its gradient
``k - 1`` ordered-gradient launches over one plan. The dense products,
Newton's Hessians included, are ``torch.matmul`` in the ship dtype;
they need full float32 products on the card, so a training on a float32
design on a CUDA device raises while
``torch.backends.cuda.matmul.allow_tf32`` is on (PyTorch's default is
off; :func:`check_full_float32`, run once a training by the optimizers).

Ported: the nine unary losses, ``OptimObjFunc``, ``UnaryLossObjFunc``
and ``SoftmaxObjFunc`` (gradient, line search and Hessian), and
``densify_shard``.
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

    def second_derivative(self, eta, y):
        raise NotImplementedError(
            f"{self.name} has no curvature (Newton unsupported)")


class LogLossFunc(UnaryLossFunc):
    """logistic loss (reference unarylossfunc/LogLossFunc.java)."""
    name = "log"

    def loss(self, eta, y):
        # log(1 + exp(-y*eta)), stable
        m = -y * eta
        return torch.logaddexp(torch.zeros_like(m), m)

    def derivative(self, eta, y):
        return -y * torch.sigmoid(-y * eta)

    def second_derivative(self, eta, y):
        p = torch.sigmoid(y * eta)
        return p * (1.0 - p)


class HingeLossFunc(UnaryLossFunc):
    name = "hinge"

    def loss(self, eta, y):
        return torch.clamp(1.0 - y * eta, min=0.0)

    def derivative(self, eta, y):
        return torch.where(y * eta < 1.0, -y, 0.0)


class SmoothHingeLossFunc(UnaryLossFunc):
    """quadratically-smoothed hinge (reference SmoothHingeLossFunc.java)."""
    name = "smooth_hinge"

    def __init__(self, gamma: float = 1.0):
        self.gamma = gamma

    def loss(self, eta, y):
        z = y * eta
        g = self.gamma
        return torch.where(z >= 1.0, 0.0,
                           torch.where(z <= 1.0 - g, 1.0 - z - g / 2,
                                       (1.0 - z) ** 2 / (2 * g)))

    def derivative(self, eta, y):
        z = y * eta
        g = self.gamma
        return torch.where(z >= 1.0, 0.0,
                           torch.where(z <= 1.0 - g, -y, -y * (1.0 - z) / g))


class SquareLossFunc(UnaryLossFunc):
    name = "square"

    def loss(self, eta, y):
        return 0.5 * (eta - y) ** 2

    def derivative(self, eta, y):
        return eta - y

    def second_derivative(self, eta, y):
        return torch.ones_like(eta)


class SvrLossFunc(UnaryLossFunc):
    """epsilon-insensitive (reference SvrLossFunc.java)."""
    name = "svr"

    def __init__(self, epsilon: float = 0.1):
        self.epsilon = epsilon

    def loss(self, eta, y):
        return torch.clamp(torch.abs(y - eta) - self.epsilon, min=0.0)

    def derivative(self, eta, y):
        r = eta - y
        return torch.where(torch.abs(r) <= self.epsilon, 0.0, torch.sign(r))


class HuberLossFunc(UnaryLossFunc):
    name = "huber"

    def __init__(self, delta: float = 1.0):
        self.delta = delta

    def loss(self, eta, y):
        r = torch.abs(eta - y)
        d = self.delta
        return torch.where(r <= d, 0.5 * r ** 2, d * (r - 0.5 * d))

    def derivative(self, eta, y):
        d = self.delta
        return torch.clamp(eta - y, -d, d)


class ExponentialLossFunc(UnaryLossFunc):
    name = "exponential"

    def loss(self, eta, y):
        return torch.exp(-y * eta)

    def derivative(self, eta, y):
        return -y * torch.exp(-y * eta)


class PerceptronLossFunc(UnaryLossFunc):
    name = "perceptron"

    def loss(self, eta, y):
        return torch.clamp(-y * eta, min=0.0)

    def derivative(self, eta, y):
        return torch.where(y * eta < 0.0, -y, 0.0)


class ZeroOneLossFunc(UnaryLossFunc):
    name = "zero_one"

    def loss(self, eta, y):
        return (torch.sign(eta) != y).to(eta.dtype)

    def derivative(self, eta, y):
        return torch.zeros_like(eta)


LOSS_REGISTRY = {
    "log": LogLossFunc, "hinge": HingeLossFunc,
    "smooth_hinge": SmoothHingeLossFunc, "square": SquareLossFunc,
    "svr": SvrLossFunc, "huber": HuberLossFunc,
    "exponential": ExponentialLossFunc, "perceptron": PerceptronLossFunc,
    "zero_one": ZeroOneLossFunc,
}


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


def check_full_float32(data: Dict, densified: bool = False) -> None:
    """Refuse TF32 for a training's dense products, once a training: a
    float32 dense design on the card raises while
    ``torch.backends.cuda.matmul.allow_tf32`` is on (TF32 keeps about three
    digits). ``densified``: the products also read the densified design
    of a sparse shard (Newton's Hessian)."""
    if "X" in data:
        t, dt = data["X"], data["X"].dtype
    elif not densified:
        return
    elif "fb_idx" in data:
        v = data.get("fb_val")
        t, dt = data["fb_idx"], torch.float32 if v is None else v.dtype
    else:
        t, dt = data["val"], data["val"].dtype
    if t.is_cuda and dt == torch.float32 \
            and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the port's dense "
            "products need full float32 (TF32 keeps about three digits)")


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


def densify_shard(data: Dict, dim: int, fb_meta=None):
    """(n, dim) dense design matrix from any shard layout, for Newton's
    Hessian, whose memory is O(dim^2) anyway: each row's values added at
    its keys into zeros (a padding entry adds 0 at key 0). The gradient
    paths keep to matvec / rmatvec, which never densify."""
    if "X" in data:
        return data["X"]
    if "fb_idx" in data:
        _need_meta(fb_meta)
        fb_idx = data["fb_idx"]
        offs = torch.arange(fb_meta.num_fields, dtype=fb_idx.dtype,
                            device=fb_idx.device) * fb_meta.field_size
        idx = fb_idx + offs[None, :]
        val = data.get("fb_val")
        if val is None:
            val = torch.ones(idx.shape, dtype=torch.float32,
                             device=idx.device)
    else:
        idx, val = data["idx"], data["val"]
    n = idx.shape[0]
    rows = torch.arange(n, device=idx.device)[:, None].expand(idx.shape)
    return torch.zeros((n, dim), dtype=val.dtype, device=val.device) \
        .index_put_((rows, idx.long()), val, accumulate=True)


class OptimObjFunc:
    """Base objective: per-shard grad/loss/Hessian + global
    regularization. ``design_dim`` is the width of the design the
    products read (``dim`` but for Softmax, whose coefficients are
    ``k - 1`` rows of it)."""

    def __init__(self, dim: int, l1: float = 0.0, l2: float = 0.0,
                 reg_free_head: int = 0):
        self.dim = int(dim)
        self.design_dim = self.dim
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

    def hessian_shard(self, data, coef):
        """-> (H, grad, loss, wsum): the shard's unnormalized Hessian sum
        beside the gradient sums."""
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

    def hessian_shard(self, data, coef):
        grad, loss, wsum, eta = self.calc_grad_eta_shard(data, coef)
        y, w = data["y"], data["w"]
        e = eta.to(torch.promote_types(eta.dtype, y.dtype))
        h = w * self.unary_loss.second_derivative(e, y)
        Xd = densify_shard(data, self.dim, self.fb_meta)
        A = Xd * h[:, None]
        return A.T @ Xd.to(A.dtype), grad, loss, wsum


class SoftmaxObjFunc(OptimObjFunc):
    """Multinomial logistic objective (reference
    common/linear/SoftmaxObjFunc.java).

    coef is the flattened (k-1, d) matrix: class k-1 is the pivot with
    zero logits, the reference's k-1 parameterization. ``data["y"]``
    holds the class indices. A dense design takes ``torch.matmul``; a
    padded-COO one the sparse-margin kernel for each class column's
    logits and the ordered-gradient kernel for each column of the
    gradient, on the design's one plan. No field-blocked layout.
    """

    def __init__(self, k: int, d: int, l1=0.0, l2=0.0,
                 reg_free_cols: int = 0):
        super().__init__((k - 1) * d, l1, l2, reg_free_head=0)
        self.k = int(k)
        self.d = int(d)
        self.design_dim = self.d
        # leading feature columns without regularization (the intercept)
        self.reg_free_cols = int(reg_free_cols)

    def _reg_mask(self, coef):
        key = (coef.device, coef.dtype)
        m = self._masks.get(key)
        if m is None:
            m = torch.ones((self.k - 1, self.d), dtype=coef.dtype,
                           device=coef.device)
            m[:, :self.reg_free_cols] = 0.0
            m = self._masks[key] = m.reshape(-1)
        return m

    def _logits(self, data, W):
        """(n, k) logits of the (k-1, d) coefficient rows ``W``, the
        pivot's zero column last."""
        if "X" in data:
            z = data["X"] @ W.T
        else:
            z = torch.stack([matvec(data, W[c])
                             for c in range(self.k - 1)], 1)
        return torch.cat([z, z.new_zeros((z.shape[0], 1))], 1)

    def _grad_loss_from_logits(self, data, logits):
        """(grad, loss, wsum, softmax probs) at computed logits, shared by
        the gradient and Newton paths."""
        y, w = data["y"].long(), data["w"]
        lse = torch.logsumexp(logits, 1)
        loss = (w * (lse - logits.gather(1, y[:, None])[:, 0])).sum()
        p = torch.softmax(logits, 1)
        onehot = torch.nn.functional.one_hot(y, self.k).to(p.dtype)
        delta = ((p - onehot) * w[:, None])[:, :self.k - 1]
        if "X" in data:
            grad = (delta.T @ data["X"]).reshape(-1)
        else:
            plan = data.get(DESIGN) or design_plan(data, self.d)
            grad = torch.stack([linear_grad(plan, delta[:, c].contiguous())
                                for c in range(self.k - 1)]).reshape(-1)
        return grad, loss, w.sum(), p

    def calc_grad_shard(self, data, coef):
        grad, loss, wsum, _ = self.calc_grad_eta_shard(data, coef)
        return grad, loss, wsum

    def calc_grad_eta_shard(self, data, coef):
        """(grad, loss, wsum, logits): the logits at the unmoved coef
        stand in for the line search's first logits pass."""
        logits = self._logits(data, coef.reshape(self.k - 1, self.d))
        grad, loss, wsum, _ = self._grad_loss_from_logits(data, logits)
        return grad, loss, wsum, logits

    def line_losses_shard(self, data, coef, direction, steps, eta0=None):
        z0 = eta0 if eta0 is not None else \
            self._logits(data, coef.reshape(self.k - 1, self.d))
        zd = self._logits(data, direction.reshape(self.k - 1, self.d))
        y, w = data["y"].long(), data["w"]
        z = z0[None] - steps[:, None, None] * zd[None]      # (S, n, k)
        lse = torch.logsumexp(z, 2)
        picked = z.gather(2, y[None, :, None].expand(z.shape[0], -1, 1))
        return (w[None] * (lse - picked[..., 0])).sum(-1)

    def hessian_shard(self, data, coef):
        """Full (k-1)d x (k-1)d Hessian (reference SoftmaxObjFunc.java
        calcHessian): block (a, b) is sum_i w_i (p_ia [a==b] - p_ia
        p_ib) x_i x_i^T, laid out to match the flattened (k-1, d) coef;
        one (a, b) block at a time, so memory stays O(n d)."""
        logits = self._logits(data, coef.reshape(self.k - 1, self.d))
        grad, loss, wsum, p_full = self._grad_loss_from_logits(data, logits)
        w = data["w"]
        km1 = self.k - 1
        p = p_full[:, :km1]
        Xd = densify_shard(data, self.d)
        blocks = []
        for a in range(km1):
            for b in range(km1):
                same = float(a == b)
                s = w * (p[:, a] * same - p[:, a] * p[:, b])
                blocks.append(Xd.T @ (s[:, None] * Xd))
        H = (torch.stack(blocks).reshape(km1, km1, self.d, self.d)
             .permute(0, 2, 1, 3).reshape(self.dim, self.dim))
        return H, grad, loss, wsum
