"""dynamo-tpu's PyTorch/CUDA port: the serving engine on an NVIDIA card.

A package beside ``dynamo_tpu`` (the JAX reference it is held against).  It
follows that package's module layout and names; its kernels are
hand-written CUDA C++ for Hopper (``csrc/``), built by ``nvcc`` at first
use.  It imports ``torch``, ``numpy`` and the standard library only.
"""

__version__ = "0.1.0"
