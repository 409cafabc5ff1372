"""Device resolution for the port's entry points.

Every entry point runs on the card unless the caller names another device:
with no device given and no card present it raises, never carrying on
silently on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run on the CPU"
        )
    return torch.device("cuda")
