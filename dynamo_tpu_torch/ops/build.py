"""Build and bind the port's hand-written CUDA kernels.

Each kernel is a plain C entry point in a source under
``dynamo_tpu_torch/csrc/``; one source may hold several entries.  At the
first launch of one of its entries a source is compiled by ``nvcc`` for
``sm_90a`` into a shared library under ``dynamo_tpu_torch/csrc/build/``
(named by a digest of the sources, so an edited source rebuilds) and loaded
with ``ctypes``.  Nothing here runs at import: the CPU test machines import every
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
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
# dtype codes of the C entries (csrc/common.cuh DTYPE_*)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the head geometries the kernels instantiate: those of the port's configs
SUPPORTED_HEAD_DIMS = (64, 128)
SUPPORTED_GROUPS = (2, 4)  # GQA groups of ModelConfig.tiny and llama3_8b

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


# one build at a time in this process: entries sharing a source share its
# library and its temporary output path
_BUILD_LOCK = threading.Lock()
# every kernel entry defined, in definition order: CUDA graphs read and
# advance their launch counts (a replay calls no wrapper)
KERNELS: List["CudaKernel"] = []


class CudaKernel:
    """One hand-written kernel: its C entry ``name`` in ``csrc/<source>.cu``
    (``source`` defaults to ``name``), its lazily built library and its
    launch count (a plain integer the smoke run resets and reads)."""

    def __init__(
        self, name: str, argtypes: Sequence[type], source: Optional[str] = None
    ) -> None:
        self.name = name
        self.source_name = source or name
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        KERNELS.append(self)

    @property
    def source(self) -> Path:
        return CSRC / f"{self.source_name}.cu"

    def _digest(self) -> str:
        h = hashlib.sha1()
        for path in sorted([self.source, *CSRC.glob("*.cuh")]):
            h.update(path.name.encode())
            h.update(path.read_bytes())
        return h.hexdigest()[:12]

    def library_path(self) -> Path:
        return BUILD_DIR / f"lib{self.source_name}-{self._digest()}.so"

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
            # optimize a source's kernel instantiations on parallel threads
            # (the ragged source has sixteen)
            "--split-compile=0",
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
        with _BUILD_LOCK:
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
    """Build every kernel's source at once (one ``nvcc`` per source, all
    started together); returns each source's ptxas lines."""
    by_source = {k.source_name: k for k in kernels}
    errors = []
    with _BUILD_LOCK:
        started = [(k, k.start_build()) for k in by_source.values()]
        for k, s in started:
            if s is None:
                continue
            try:
                k.finish_build(*s)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: k.ptxas_info() for name, k in by_source.items()}


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_geometry(
    device: Union[str, torch.device], dtype: torch.dtype, Hq: int, Hkv: int, D: int
) -> None:
    """Refuse, on a device other than the CPU, a dtype or head geometry no
    kernel instantiation takes.  The one rule of every wrapper before its
    launch and of ``TorchEngine`` at construction; on the CPU the plain
    versions serve any geometry."""
    if torch.device(device).type == "cpu":
        return
    if dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported dtype {dtype}")
    if D not in SUPPORTED_HEAD_DIMS or Hq % Hkv or Hq // Hkv not in SUPPORTED_GROUPS:
        raise ValueError(f"unsupported head geometry Hq={Hq} Hkv={Hkv} D={D}")


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
