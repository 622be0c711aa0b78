"""The field-blocked sparse format and its two design-matrix products.

Counterpart: ``alink_tpu/ops/fieldblock.py``. A field-blocked design
holds exactly one local index per field and row, ``fb_idx`` of shape
``(n, F)`` with values in ``[0, field_size)``; field ``k``'s block of
the coefficient vector is ``[k * S, (k + 1) * S)``.

The JAX package computes both products as factored one-hot matrix
products, a TPU layout (and precomputes the one-hot factors,
``fb_onehot_parts``, when they fit). The port does not build one-hot
factors: on the card a field-blocked design is its flat indices
(:func:`fb_to_flat_indices`) with one value per field, and the products
are the padded-COO ones, the margins through the sparse score kernel
(``kernels/serve.py``) and the gradient through the ordered gradient
kernel (``kernels/linear.py``).

**Numerics (the JAX package's on the CPU).** Margins and gradient are
float32 whatever the ship dtype: the coefficients, the values and ``c``
are cast to float32, and products and sums are float32. The margins
are each row's fields added left to right from zero, which is bitwise
what the reference's one-hot product gives on the CPU; the gradient
adds each slot's terms in row order, where the reference's order is
XLA's, so the two agree within the float32 summation bound.

:func:`fb_gather` is the JAX package's per-field selection (there a
one-hot product on float32 operands, exact): here the state gather
kernel (``kernels/ftrl.py``) at the flat indices, rounded to float32.
:func:`hash_to_fields` (field-aware hashing, host numpy through the
port's vectorized murmur) is ported too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels.ftrl import gather_pair, gather_rows
from ..kernels.linear import grad_plan, linear_grad, sparse_margins

LO = 16  # lo-part width; field_size must be a multiple of this


@dataclass(frozen=True)
class FieldBlockMeta:
    """Shape metadata for a field-blocked design matrix.

    dim = num_fields * field_size; global index of (field k, local j) is
    ``k * field_size + j`` (field-major), matching the coefficient layout.
    """
    num_fields: int
    field_size: int

    @property
    def dim(self) -> int:
        return self.num_fields * self.field_size

    @property
    def hi_size(self) -> int:
        return self.field_size // LO

    def __post_init__(self):
        if self.field_size % LO:
            raise ValueError(f"field_size must be a multiple of {LO}")


def hash_to_fields(columns, field_size: int, seed: int = 0) -> np.ndarray:
    """Field-aware feature hashing: one column -> one field (host-side).

    The reference hashes all columns into one flat space
    (FeatureHasherMapper over murmur32); here each column owns a
    ``field_size`` sub-range so the result is field-blocked by
    construction. Returns ``fb_idx`` of shape (n, num_columns) int32.
    """
    from ..operator.batch.feature.feature_ops import murmur32_cells
    cols = list(columns)
    n = len(cols[0])
    out = np.empty((n, len(cols)), np.int32)
    for k, col in enumerate(cols):
        tokens = [f"{k}={v}".encode() for v in col]
        out[:, k] = murmur32_cells(tokens, seed=seed, mod=field_size)
    return out


def fb_to_flat_indices(fb_idx: np.ndarray, meta: FieldBlockMeta) -> np.ndarray:
    """(n, F) field-local -> (n, F) global indices into the dim-vector."""
    offs = (np.arange(meta.num_fields, dtype=np.int64) * meta.field_size)
    return (np.asarray(fb_idx, np.int64) + offs[None, :]).astype(np.int32)


def detect_fieldblock(idx: np.ndarray, val: Optional[np.ndarray], dim: int):
    """Recognize the field-blocked layout in a padded-COO design: exactly
    one entry per field per row, field k's indices inside
    ``[k*S, (k+1)*S)``. Returns (fb_idx, fb_val|None, meta), fb_val None
    when all values are 1.0; None when the pattern does not hold."""
    idx = np.asarray(idx)
    # F >= 2: with a single column every width-1 design would "detect"
    if idx.ndim != 2 or idx.shape[1] < 2:
        return None
    F = idx.shape[1]
    if dim % F or (dim // F) % LO or dim // F < LO:
        return None
    meta = FieldBlockMeta(F, dim // F)
    local = flat_to_fb_indices(idx, meta)
    if local is None:
        return None
    if val is None or np.all(val == 1.0):
        return local, None, meta
    return local, np.asarray(val), meta


def flat_to_fb_indices(idx: np.ndarray, meta: FieldBlockMeta) -> Optional[np.ndarray]:
    """(n, F) local indices if every row's k-th entry falls in field k's
    range (the shape field-aware hashing produces), else None."""
    idx = np.asarray(idx)
    if idx.ndim != 2 or idx.shape[1] != meta.num_fields:
        return None
    offs = np.arange(meta.num_fields, dtype=idx.dtype) * meta.field_size
    local = idx - offs[None, :]
    if (local < 0).any() or (local >= meta.field_size).any():
        return None
    return local.astype(np.int32)


def fb_flat(fb_idx, meta: FieldBlockMeta):
    """The flat int32 indices of a field-blocked tensor ``fb_idx`` (on its
    device)."""
    offs = torch.arange(meta.num_fields, dtype=torch.int64,
                        device=fb_idx.device) * meta.field_size
    return (fb_idx.long() + offs[None, :]).to(torch.int32).contiguous()


def fb_values(fb_idx, val=None):
    """The float32 value of each (row, field): ``val`` cast, or ones."""
    if val is None:
        return torch.ones(fb_idx.shape, dtype=torch.float32,
                          device=fb_idx.device)
    return val.to(torch.float32).contiguous()


def fb_gather(fb_idx, vec, meta: FieldBlockMeta, other=None):
    """``out[i, k] = vec[k*S + fb_idx[i, k]]`` in float32, (n, F): the
    state gather kernel at :func:`fb_flat`'s indices, then rounded (a
    selection, so the JAX package's float32 one-hot product gives the same
    bits). With ``other`` (a vector of ``vec``'s dtype and size), both in
    one launch (``gather_pair``): (n, F, 2), ``vec``'s in ``[..., 0]``."""
    flat = fb_flat(fb_idx, meta)
    if other is None:
        out = gather_rows(vec, flat.view(-1)).view(flat.shape)
    else:
        out = gather_pair(vec, other, flat.view(-1)).view(*flat.shape, 2)
    return out.to(torch.float32)


def fb_matvec(fb_idx, coef, meta: FieldBlockMeta, val=None, plan=None):
    """``eta[i] = sum_k val[i,k] * coef[k*S + fb_idx[i,k]]`` in float32,
    each row's fields added left to right from zero (the sparse score
    kernel on the card). ``plan``: the design's
    :class:`~alink_tpu_torch.kernels.linear.GradPlan`, which holds the
    flat indices and float32 values; built here when not given."""
    if plan is None:
        keys, vals = fb_flat(fb_idx, meta), fb_values(fb_idx, val)
    else:
        keys, vals = plan.keys, plan.val
    return sparse_margins(keys, vals, coef.to(vals.dtype).contiguous())


def fb_rmatvec(fb_idx, c, meta: FieldBlockMeta, val=None, plan=None):
    """``grad = X^T c`` in float32: each slot's terms ``val * c`` (float32
    products) added in row order from +0.0 (the ordered gradient kernel
    on the card). ``plan`` as for :func:`fb_matvec`."""
    if plan is None:
        plan = grad_plan(fb_flat(fb_idx, meta), meta.dim,
                         fb_values(fb_idx, val))
    return linear_grad(plan, c.to(torch.float32))
