"""The port's device rule: entry points run on the CUDA device unless the
caller asks for the CPU. There is no silent fallback — with no CUDA device
and no explicit request, they raise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises if there is none);
    anything else -> ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
