"""Device resolution for the port's entry points.

Every entry point runs on the card unless the caller names another device:
with no device given and no card present it raises, never carrying on
silently on the CPU.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import torch

# One executor call of one engine at a time in the process.  A CUDA graph
# capture must overlap neither another thread's device-wide calls (the
# device synchronize ``torch.cuda.graph`` begins with) nor its launches
# (the capture's launch-count delta would take them in, and every count is
# process-wide), so engines that share a process -- workers of one
# cluster, as ``chip_smoke.py``'s serve-dyn runs them -- take turns at
# dispatching, committing and capturing.  One engine never waits on it.  A
# device trace (``runtime/profiling.py``) takes it around the profiler's
# start, stop and export, so no engine's torch work overlaps them.
DEVICE_TURN = threading.Lock()


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run on the CPU"
        )
    return torch.device("cuda")
