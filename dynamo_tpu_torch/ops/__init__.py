"""Hand-written CUDA kernels of the serving hot path, each beside its plain
PyTorch version (used for CPU tensors and as the kernel's reference)."""

from .paged_attention import paged_decode_attention  # noqa: F401
from .ragged_attention import packed_ragged_attention  # noqa: F401
