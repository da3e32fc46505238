"""Default-device resolution for the port's entry points.

``device=None`` means the card: the port exists to run on an NVIDIA GPU,
so a missing CUDA runtime is an error, never a silent CPU fallback.  A
caller that wants the CPU (the tests, where every kernel wrapper takes its
plain PyTorch twin) says so with ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if the resolved device is CUDA and no
    card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points default to CUDA, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch twins on the CPU"
        )
    return dev
