"""Device resolution for the port.

No counterpart in ``alink_tpu``: there the device set comes from the
session mesh (``common/mlenv.py``). The port takes an explicit
``device`` at every entry point and resolves it here, once.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` when the caller gives
    none. A CUDA device without CUDA raises ``RuntimeError``; nothing
    falls back to the CPU. Callers that want the CPU (the tests) pass
    ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "alink_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return dev
