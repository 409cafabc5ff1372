"""Multi-GPU serving: the rank grid, the sharding rules, the leader's
dispatch mirror and its followers (the JAX package's ``parallel/``, whose
tp and ep the port serves; dp inside one engine, sp's ring prefill and
pp's pipeline prefill are later work)."""

from .mesh import MeshConfig, ParallelMesh, build_mesh, env_parallel_spec, serving_mesh
from .sharding import kv_pspec, param_pspecs, shard_params

__all__ = [
    "MeshConfig",
    "ParallelMesh",
    "build_mesh",
    "env_parallel_spec",
    "serving_mesh",
    "param_pspecs",
    "kv_pspec",
    "shard_params",
]
