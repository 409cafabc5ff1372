"""Multi-GPU serving: the rank grid, the sharding rules, the leader's
dispatch mirror and its followers, the ring prefill (sp) and the pipeline
prefill (pp) -- the JAX package's ``parallel/``; dp inside one engine, and
sp or pp beside tp or ep, are later work."""

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
