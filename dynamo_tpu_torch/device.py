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


def release_blas_workspaces(device: torch.device) -> None:
    """Free the cuBLAS and cuBLASLt workspaces PyTorch holds on the card.

    PyTorch keeps one workspace (some 32 MiB on Hopper) for every (cuBLAS
    handle, stream) pair that ever ran a matmul, in a process-wide map that
    only this clear empties.  An engine makes new pairs -- its executor
    thread's handle with its streams, its graph captures' streams, the
    workspace then landing in the graph's private pool -- and stopping it
    leaves them allocated, so a process that starts and stops engines
    holds more each time.  Cleared under ``DEVICE_TURN`` once the device is idle, so
    no engine's matmul is being issued meanwhile; a live engine's next
    matmul allocates its workspace again (a freed workspace returns to its
    stream's pool, so stream order keeps in-flight work safe).  A no-op
    off the card."""
    if device.type != "cuda":
        return
    with DEVICE_TURN:
        torch.cuda.synchronize(device)
        torch._C._cuda_clearCublasWorkspaces()
