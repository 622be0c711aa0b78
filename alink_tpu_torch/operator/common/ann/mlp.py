"""Multilayer perceptron objective.

Counterpart: ``alink_tpu/operator/common/ann/mlp.py`` (the re-design of
the reference's ann/ package: FeedForwardTopology.multiLayerPerceptron,
AffineLayer, SigmoidFunction, SoftmaxLayerWithCrossEntropyLoss, Stacker,
AnnObjFunc). All weights are flattened into one coefficient vector (the
Stacker contract), so the MLP trains on the same L-BFGS as the linear
models (``optim/optimizers.py::optimize``). The JAX package takes its
gradient from ``jax.value_and_grad``; the port takes it from
``torch.autograd`` on a leaf copy of the coefficients, and computes the
line search's losses under ``torch.no_grad()``, one forward a step, so no
graph outlives its superstep. The two sum in different orders: float64
runs agree within a tolerance, not bit for bit.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..optim.objfunc import OptimObjFunc


def stack_sizes(layer_sizes: Sequence[int]) -> int:
    """Total flattened parameter count (reference Stacker)."""
    total = 0
    for a, b in zip(layer_sizes[:-1], layer_sizes[1:]):
        total += a * b + b
    return total


def unstack(coef, layer_sizes: Sequence[int]) -> List[Tuple]:
    """coef -> [(W (in,out), b (out,)), ...]."""
    out = []
    pos = 0
    for a, b in zip(layer_sizes[:-1], layer_sizes[1:]):
        W = coef[pos:pos + a * b].reshape(a, b)
        pos += a * b
        bias = coef[pos:pos + b]
        pos += b
        out.append((W, bias))
    return out


def mlp_forward(coef, X, layer_sizes: Sequence[int]):
    """Logits of the final layer; sigmoid hidden activations (reference
    SigmoidFunction between AffineLayers)."""
    h = X
    layers = unstack(coef, layer_sizes)
    for i, (W, b) in enumerate(layers):
        z = h @ W + b
        h = z if i == len(layers) - 1 else torch.sigmoid(z)
    return h


class MlpObjFunc(OptimObjFunc):
    """Cross-entropy over softmax outputs (reference
    SoftmaxLayerWithCrossEntropyLoss + AnnObjFunc). ``data["y"]`` holds
    the class ids."""

    def __init__(self, layer_sizes: Sequence[int], l2: float = 0.0):
        super().__init__(stack_sizes(layer_sizes), l1=0.0, l2=l2)
        self.layer_sizes = list(layer_sizes)

    def _loss_sum(self, coef, X, y, w):
        logits = mlp_forward(coef, X, self.layer_sizes)
        lse = torch.logsumexp(logits, 1)
        picked = logits.gather(1, y.long()[:, None])[:, 0]
        return (w * (lse - picked)).sum()

    def calc_grad_shard(self, data, coef):
        X, y, w = data["X"], data["y"], data["w"]
        with torch.enable_grad():
            leaf = coef.detach().requires_grad_(True)
            loss = self._loss_sum(leaf, X, y, w)
            grad, = torch.autograd.grad(loss, leaf)
        return grad, loss.detach(), w.sum()

    def line_losses_shard(self, data, coef, direction, steps, eta0=None):
        X, y, w = data["X"], data["y"], data["w"]
        with torch.no_grad():
            return torch.stack([self._loss_sum(coef - s * direction, X, y, w)
                                for s in steps])
