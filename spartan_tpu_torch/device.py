"""Device resolution for the port's entry points.

Every entry point takes ``device=``.  ``None`` means the CUDA card; the
CPU is used only when the caller asks for it by name (the tests do).
With no card and no explicit CPU request the entry points raise — they
never quietly run on the CPU.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> cuda:0 (raises without a card); anything else is
    taken literally.  A CUDA device that is not available raises."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "spartan_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev

