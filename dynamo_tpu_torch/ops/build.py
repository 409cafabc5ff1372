"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one source under ``dynamo_tpu_torch/csrc/`` with a plain C
entry point.  At its first launch it is compiled by ``nvcc`` for ``sm_90a``
into a shared library under ``dynamo_tpu_torch/csrc/build/`` (named by a
digest of the sources, so an edited source rebuilds) and loaded with
``ctypes``.  Nothing here runs at import: the CPU test machines import every
module and have no ``nvcc``.

A C entry returns ``cudaGetLastError()`` after its launch (or
``cudaErrorInvalidValue`` for a shape it does not take); ``launch`` raises
when that is not 0 and otherwise adds one to the kernel's launch count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
# dtype codes of the C entries (csrc/common.cuh DTYPE_*)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

P = ctypes.c_void_p
I = ctypes.c_int


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a CUDA machine")


class CudaKernel:
    """One hand-written kernel: its source, its lazily built library and its
    launch count (a plain integer the smoke run resets and reads)."""

    def __init__(self, name: str, argtypes: Sequence[type]) -> None:
        self.name = name
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._lock = threading.Lock()

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    def _digest(self) -> str:
        h = hashlib.sha1()
        for path in sorted([self.source, *CSRC.glob("*.cuh")]):
            h.update(path.name.encode())
            h.update(path.read_bytes())
        return h.hexdigest()[:12]

    def library_path(self) -> Path:
        return BUILD_DIR / f"lib{self.name}-{self._digest()}.so"

    def log_path(self) -> Path:
        return self.library_path().with_suffix(".log")

    def start_build(self) -> Optional[Tuple[subprocess.Popen, Path]]:
        """Start ``nvcc`` for this kernel unless its library is built;
        returns the process and its temporary output path."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [
            nvcc_path(),
            "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v",
            "-o", str(tmp), str(self.source),
        ]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        return proc, tmp

    def finish_build(self, proc: subprocess.Popen, tmp: Path) -> None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source}:\n{log}")
        self.log_path().write_text(log)
        os.replace(tmp, self.library_path())

    def build(self) -> None:
        started = self.start_build()
        if started is not None:
            self.finish_build(*started)

    def ptxas_info(self) -> List[str]:
        """The ``-Xptxas -v`` lines (registers, shared memory, spills) of
        the last build of this source."""
        path = self.log_path()
        if not path.exists():
            return []
        keys = ("Compiling entry", "Used", "spill")
        return [
            ln.strip()
            for ln in path.read_text().splitlines()
            if any(k in ln for k in keys)
        ]

    def _load(self):
        with self._lock:
            if self._fn is None:
                self.build()
                lib = ctypes.CDLL(str(self.library_path()))
                fn = getattr(lib, self.name)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn

    def launch(self, *args) -> None:
        rc = self._load()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: launch failed with CUDA error {rc}")
        self.launches += 1


def build_all(kernels: Sequence[CudaKernel]) -> Dict[str, List[str]]:
    """Build every kernel at once (one ``nvcc`` per source, all started
    together); returns each kernel's ptxas lines."""
    started = [(k, k.start_build()) for k in kernels]
    errors = []
    for k, s in started:
        if s is None:
            continue
        try:
            k.finish_build(*s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {k.name: k.ptxas_info() for k in kernels}


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_operand(
    name: str, t: torch.Tensor, device: torch.device, dtype: torch.dtype, ndim: int
) -> None:
    """Refuse what a kernel does not take: wrong device, dtype, rank, a
    non-contiguous layout or a pointer unfit for 16-byte vector loads."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has rank {t.dim()}, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
