"""Multi-host bootstrap: one engine spanning several hosts, the JAX
package's ``parallel/multihost.py`` over ``torch.distributed``.

Every host runs the same command with its own ``--node-rank`` (or
``DYN_NODE_RANK``); host 0 is the leader and its address (``--leader-addr``
/ ``DYN_LEADER_ADDR``, ``host:port``) hosts the rendezvous.  Each host runs
``local_ranks`` processes, one per card; a process's global rank is its
node rank times the local ranks, plus its local rank, so the tp groups of
the ``ep x tp`` grid (tp innermost) stay inside a host while there are at
least ``tp`` cards per host.  ``initialize_multihost`` joins the world with
``torch.distributed.init_process_group``; ``parallel.mesh.build_mesh``
then builds the grid's groups inside it.  Global rank 0 -- node 0's local
rank 0 -- runs the engine's scheduler and front end; every other rank
follows it.

Single-node configs make ``initialize_multihost`` a no-op.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional

logger = logging.getLogger("dynamo.multihost")


@dataclass
class MultiNodeConfig:
    """The JAX package's ``MultiNodeConfig``: ranks and a leader address."""

    num_nodes: int = 1
    node_rank: int = 0
    # leader host:port of the rendezvous
    leader_addr: str = ""

    @classmethod
    def from_env(cls) -> "MultiNodeConfig":
        return cls(
            num_nodes=int(os.environ.get("DYN_NUM_NODES", "1")),
            node_rank=int(os.environ.get("DYN_NODE_RANK", "0")),
            leader_addr=os.environ.get("DYN_LEADER_ADDR", ""),
        )

    def validate(self) -> None:
        if self.num_nodes < 1:
            raise ValueError(f"num_nodes must be >= 1, got {self.num_nodes}")
        if not (0 <= self.node_rank < self.num_nodes):
            raise ValueError(
                f"node_rank {self.node_rank} out of range for "
                f"{self.num_nodes} nodes"
            )
        if self.num_nodes > 1 and not self.leader_addr:
            raise ValueError("multi-node requires leader_addr (host:port)")

    @property
    def is_multi_node(self) -> bool:
        return self.num_nodes > 1

    @property
    def is_leader(self) -> bool:
        return self.node_rank == 0

    def global_rank(self, local_rank: int, local_ranks: int) -> int:
        return self.node_rank * local_ranks + local_rank


def initialize_multihost(
    cfg: Optional[MultiNodeConfig] = None,
    local_rank: int = 0,
    local_ranks: int = 1,
    backend: str = "gloo",
) -> MultiNodeConfig:
    """Join the multi-host world: ``init_process_group`` at the leader's
    address, world size ``num_nodes * local_ranks``.  No-op for a
    single-node config (the engine's own launcher wires local ranks)."""
    import torch.distributed as dist

    from .mesh import _timeout

    cfg = cfg or MultiNodeConfig.from_env()
    cfg.validate()
    if not cfg.is_multi_node:
        return cfg
    rank = cfg.global_rank(local_rank, local_ranks)
    world = cfg.num_nodes * local_ranks
    logger.info(
        "joining multihost world: rank %d/%d (node %d/%d), leader %s",
        rank, world, cfg.node_rank, cfg.num_nodes, cfg.leader_addr,
    )
    dist.init_process_group(
        backend, init_method=f"tcp://{cfg.leader_addr}", world_size=world, rank=rank,
        timeout=_timeout(),
    )
    return cfg
