"""The rank grid over ``torch.distributed``: the JAX package's
``parallel/mesh.py`` for one process per rank.

Axes are the JAX mesh's (``dp``, ``pp``, ``sp``, ``ep``, ``tp``; ``tp``
innermost, so the ranks of one tensor-parallel group are neighbours).  The
port serves ``tp`` and ``ep``: a :class:`ParallelMesh` is this rank's view
of an ``ep x tp`` grid -- its coordinates and device, the process groups
its collectives run over (the world, its tp row, its ep column, and a CPU
side group the leader's small host descriptors ride), the backend and
whether a CUDA graph can capture its collectives.

The backend follows the device: CPU ranks run gloo; CUDA ranks would run
NCCL, one card each, and are refused by name -- an NCCL engine's stop has
not been shown to return, so the port does not serve it yet.  A mesh that
needs more cards than the host has is refused first, as JAX's
``build_mesh`` refuses ("mesh needs N devices, have M").
``build_mesh(..., backend="gloo")`` on a CUDA device is the one explicit
exception (gloo takes CUDA tensors for its collectives, so two ranks can
share one card): a check of agreement, not a served configuration.  Its
collectives cannot be captured, so an engine over any mesh runs every
dispatch eagerly.  Nothing picks a backend or a device by itself.

Groups.  Inside a world that ``torch.distributed.init_process_group``
already set up (``multihost.initialize_multihost``) the groups come from
``new_group``; otherwise each is built straight from a store
(``file://`` or ``tcp://``), so one process may hold several meshes one
after another (tests build and tear down one per engine).  Every
collective goes through the group objects' own methods and counts itself
in :attr:`ParallelMesh.counts` (``all_reduce``, ``all_gather``,
``broadcast``, ``amax``), the numbers a smoke run reads per rank.
"""

from __future__ import annotations

import collections
import datetime
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

# how long a collective waits for its peers before it raises: a rank that
# died fails its peers' dispatches within this bound (DYN_DIST_TIMEOUT_S)
DEFAULT_TIMEOUT_S = 120.0
# a follower waits this long for the leader's next descriptor: an idle
# leader is not a dead one (a dead leader closes its sockets, which ends
# the wait at once)
IDLE_TIMEOUT_S = 7 * 24 * 3600.0


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.tp * self.pp * self.sp * self.ep

    def axis_names(self) -> List[str]:
        return ["dp", "pp", "sp", "ep", "tp"]


def refuse_unserved_axes(cfg: MeshConfig) -> None:
    """The port serves tp and ep; dp inside one engine, sp's ring prefill
    and pp's pipeline prefill are later work, refused by name."""
    for axis in ("dp", "sp", "pp"):
        if getattr(cfg, axis) != 1:
            raise ValueError(
                f"{axis}={getattr(cfg, axis)}: not served by the PyTorch port yet "
                "(it serves tp and ep)"
            )


NCCL_NOT_SERVED = (
    "tp and ep over NCCL (one card a rank) are not served by the PyTorch port "
    "yet: an NCCL engine's stop has not been shown to return; serve them on "
    "the CPU (--device cpu, gloo)"
)


def refuse_backend(backend: str) -> None:
    if backend != "gloo":
        raise ValueError(NCCL_NOT_SERVED if backend == "nccl" else
                         f"backend {backend!r}: the port's ranks run gloo")


def check_devices(local_ranks: int, backend: str) -> None:
    """JAX's ``build_mesh`` refusal first: NCCL takes one card per rank,
    so the ranks of one host need as many cards.  Then NCCL itself, by
    name (module docstring)."""
    if backend == "nccl":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < local_ranks:
            raise ValueError(f"mesh needs {local_ranks} devices, have {have}")
    refuse_backend(backend)


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _timeout() -> datetime.timedelta:
    raw = os.environ.get("DYN_DIST_TIMEOUT_S", "")
    secs = float(raw) if raw.strip() else DEFAULT_TIMEOUT_S
    return datetime.timedelta(seconds=secs)


def _store_from(init_method: str, rank: int, world: int, timeout) -> Any:
    """A store for ``file://PATH`` or ``tcp://HOST:PORT`` (rank 0 hosts the
    TCP store)."""
    if init_method.startswith("file://"):
        return dist.FileStore(init_method[len("file://"):], world)
    if init_method.startswith("tcp://"):
        host, port = init_method[len("tcp://"):].rsplit(":", 1)
        return dist.TCPStore(host, int(port), world, rank == 0, timeout)
    raise ValueError(f"unsupported init method {init_method!r} (file:// or tcp://)")


class ParallelMesh:
    """This rank's view of the ``ep x tp`` grid (see the module docstring).

    ``coords`` maps each axis to this rank's index on it; ``tp_ranks`` and
    ``ep_ranks`` list the global ranks of this rank's groups.  Global rank
    0 is the leader."""

    def __init__(
        self,
        config: MeshConfig,
        rank: int,
        device: torch.device,
        backend: str,
        init_method: Optional[str] = None,
        timeout: Optional[datetime.timedelta] = None,
    ) -> None:
        refuse_unserved_axes(config)
        refuse_backend(backend)
        self.config = config
        self.rank = rank
        self.world = config.num_devices
        self.device = device
        self.backend = backend
        self.timeout = timeout or _timeout()
        tp, ep = config.tp, config.ep
        self.coords = {"ep": rank // tp, "tp": rank % tp}
        self.tp_ranks = [self.coords["ep"] * tp + j for j in range(tp)]
        self.ep_ranks = [e * tp + self.coords["tp"] for e in range(ep)]
        self.counts: Dict[str, int] = collections.Counter()
        if dist.is_initialized():
            self._groups_from_world()
        else:
            if init_method is None:
                raise ValueError("a mesh outside an initialized world needs init_method")
            store = _store_from(init_method, rank, self.world, self.timeout)
            self._groups_from_store(store)

    # -- groups -------------------------------------------------------------

    def _groups_from_store(self, store) -> None:
        def make(prefix: str, ranks: List[int], timeout) -> Any:
            pstore = dist.PrefixStore(prefix, store)
            return dist.ProcessGroupGloo(pstore, ranks.index(self.rank), len(ranks), timeout)

        side_timeout = self.timeout if self.rank == 0 else datetime.timedelta(
            seconds=IDLE_TIMEOUT_S
        )
        everyone = list(range(self.world))
        self.world_group = make("world", everyone, self.timeout)
        self.side_group = make("side", everyone, side_timeout)
        self.tp_group = make(f"tp{self.coords['ep']}", self.tp_ranks, self.timeout)
        self.ep_group = make(f"ep{self.coords['tp']}", self.ep_ranks, self.timeout)

    def _groups_from_world(self) -> None:
        """``new_group`` for every group, made by every rank in one order
        (the call is collective over the world)."""
        tp, ep = self.config.tp, self.config.ep
        if dist.get_world_size() != self.world:
            raise ValueError(
                f"mesh of {self.world} ranks in a world of {dist.get_world_size()}"
            )
        self.world_group = dist.new_group(list(range(self.world)), timeout=self.timeout)
        side_timeout = self.timeout if self.rank == 0 else datetime.timedelta(
            seconds=IDLE_TIMEOUT_S
        )
        self.side_group = dist.new_group(
            list(range(self.world)), timeout=side_timeout, backend="gloo"
        )
        for e in range(ep):
            g = dist.new_group([e * tp + j for j in range(tp)], timeout=self.timeout)
            if e == self.coords["ep"]:
                self.tp_group = g
        for j in range(tp):
            g = dist.new_group([e * tp + j for e in range(ep)], timeout=self.timeout)
            if j == self.coords["tp"]:
                self.ep_group = g

    # -- identity -----------------------------------------------------------

    @property
    def tp(self) -> int:
        return self.config.tp

    @property
    def ep(self) -> int:
        return self.config.ep

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    @property
    def in_leader_tp_row(self) -> bool:
        """Whether this rank shares the leader's tp group (ep coordinate
        0): the ranks the vocabulary-sharded logits gather over."""
        return self.coords["ep"] == 0

    def describe(self) -> Dict[str, Any]:
        return {
            "tp": self.tp, "ep": self.ep, "world": self.world, "rank": self.rank,
            "backend": self.backend,
            "device": str(self.device),
        }

    # -- collectives ----------------------------------------------------------

    def _group(self, name: str):
        return {"tp": self.tp_group, "ep": self.ep_group, "world": self.world_group,
                "side": self.side_group}[name]

    def size(self, name: str) -> int:
        return {"tp": self.tp, "ep": self.ep, "world": self.world}[name]

    def all_reduce(self, x: torch.Tensor, over: str = "tp", op: str = "sum") -> torch.Tensor:
        """In-place sum (or max) of ``x`` over a group; returns ``x``."""
        if self.size(over) == 1:
            return x
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        self._group(over).allreduce([x], opts).wait()
        self.counts["amax" if op == "max" else "all_reduce"] += 1
        return x

    def all_gather(self, x: torch.Tensor, dim: int = -1, over: str = "tp") -> torch.Tensor:
        """``x`` of every rank of the group, concatenated along ``dim`` in
        group order."""
        n = self.size(over)
        if n == 1:
            return x
        x = x.contiguous()
        outs = [torch.empty_like(x) for _ in range(n)]
        self._group(over).allgather([outs], [x]).wait()
        self.counts["all_gather"] += 1
        return torch.cat(outs, dim=dim)

    def broadcast(self, x: torch.Tensor, over: str = "world") -> torch.Tensor:
        """``x`` from the group's first rank (the leader in the leader's
        groups), in place."""
        if over != "side" and self.size(over) == 1:
            return x
        opts = dist.BroadcastOptions()
        opts.rootRank = 0
        self._group(over).broadcast([x], opts).wait()
        if over != "side":
            self.counts["broadcast"] += 1
        return x

    def gather_objects(self, obj: Any) -> List[Any]:
        """Every rank's picklable ``obj``, in rank order, on every rank
        (over the CPU side group)."""
        import pickle

        data = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
        n = torch.tensor([data.numel()], dtype=torch.int64)
        sizes = [torch.empty_like(n) for _ in range(self.world)]
        self.side_group.allgather([sizes], [n]).wait()
        width = int(max(int(s) for s in sizes))
        buf = torch.zeros(width, dtype=torch.uint8)
        buf[: data.numel()] = data
        outs = [torch.empty_like(buf) for _ in range(self.world)]
        self.side_group.allgather([outs], [buf]).wait()
        return [pickle.loads(bytes(o[: int(s)].numpy())) for o, s in zip(outs, sizes)]

    def broadcast_object(self, obj: Any = None) -> Any:
        """The leader's picklable ``obj`` on every rank (side group)."""
        import pickle

        if self.is_leader:
            data = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
            n = torch.tensor([data.numel()], dtype=torch.int64)
        else:
            n = torch.zeros(1, dtype=torch.int64)
        self.broadcast(n, over="side")
        if not self.is_leader:
            data = torch.empty(int(n), dtype=torch.uint8)
        self.broadcast(data, over="side")
        return obj if self.is_leader else pickle.loads(bytes(data.numpy()))

    def close(self) -> None:
        """Drop the groups (call it with no collective in flight: after the
        leader's last descriptor)."""
        for name in ("world_group", "side_group", "tp_group", "ep_group"):
            setattr(self, name, None)


def build_mesh(
    cfg: MeshConfig,
    rank: int = 0,
    device: Optional[torch.device] = None,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    local_ranks: Optional[int] = None,
) -> ParallelMesh:
    """This rank's :class:`ParallelMesh`.  ``backend`` defaults to the
    device's (NCCL on a card, gloo on the CPU); NCCL needs one card per
    rank of this host (``local_ranks``, default the whole mesh) and is
    refused with fewer, by JAX's message, and with enough by name."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    backend = backend or default_backend(device)
    check_devices(local_ranks or cfg.num_devices, backend)
    return ParallelMesh(cfg, rank, device, backend, init_method)


def serving_mesh(tp: int = 1) -> Optional[MeshConfig]:
    """The engine-startup grid of ``EngineConfig.tp``, or None at tp = 1
    (single-card serving pays no mesh machinery)."""
    tp = max(int(tp), 1)
    return None if tp == 1 else MeshConfig(tp=tp)


def env_parallel_spec() -> dict:
    """``DYN_TP`` / ``DYN_DP`` -> {"tp": n | None, "dp": n | None}, the
    JAX package's override: None means unset (config decides), a set value
    wins outright (``DYN_TP=1`` disarms a config-armed tp), and an
    unparsable value raises rather than silently serve one card."""
    out = {}
    for key, name in (("tp", "DYN_TP"), ("dp", "DYN_DP")):
        raw = os.environ.get(name)
        if raw is None or raw.strip() == "":
            out[key] = None
            continue
        try:
            out[key] = max(int(raw), 1)
        except ValueError:
            raise ValueError(f"{name}={raw!r} is not an integer parallel degree") from None
    return out
