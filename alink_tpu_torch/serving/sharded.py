"""The serving reduction constants and the canonical strict-order sum.

Counterpart: ``alink_tpu/serving/sharded.py``. Only ``SERVE_CHUNK``,
``LANE_PAD``, :func:`seq_chunk_sum` and :func:`scan_sum` are ported;
the mesh-sharded programs wait for the multi-GPU slice.
"""

from __future__ import annotations

import torch

# The serving reduction granule: feature axes and sparse widths pad to
# multiples of SERVE_CHUNK.
SERVE_CHUNK = 8
# The JAX package's fixed lane count of its mesh-size-invariant
# reduction. Linear models pad their feature axis to LANE_PAD so one
# encode serves every mesh size; the port keeps the same padding so its
# arrays have the JAX package's shapes.
SERVE_LANES = 8
LANE_PAD = SERVE_LANES * SERVE_CHUNK


def seq_chunk_sum(terms: torch.Tensor, axis: int) -> torch.Tensor:
    """Sum ``terms`` over ``axis`` strictly left to right from a zero
    accumulator, one rounded add per term: the order the JAX package's
    chunked scan fixes and the order the CUDA score kernels keep. Unlike
    ``torch.sum``, the rounding cannot depend on the other dimensions'
    sizes, which is what makes serving buckets numerical no-ops."""
    t = terms.movedim(axis, 0)
    acc = torch.zeros(t.shape[1:], dtype=t.dtype, device=t.device)
    for j in range(t.shape[0]):
        acc = acc + t[j]
    return acc


# The strict left-to-right sum that the tree serving kernel reduces its
# trees with (the JAX package's ``lax.scan`` form); in the port it is
# the same loop.
scan_sum = seq_chunk_sum
