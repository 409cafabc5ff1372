"""The rank grid over ``torch.distributed``: the JAX package's
``parallel/mesh.py`` for one process per rank.

Axes are the JAX mesh's (``dp``, ``pp``, ``sp``, ``ep``, ``tp``; ``tp``
innermost, so the ranks of one tensor-parallel group are neighbours).  The
port serves ``tp`` and ``ep`` together, and ``sp`` (the ring prefill) and
``pp`` (the pipeline prefill) each alone; data parallelism inside one
engine, and sp or pp beside another axis, are refused by name
(:func:`refuse_unserved_axes`).  A :class:`ParallelMesh` is this rank's
view of the grid -- its coordinates and device, the process groups its
collectives run over (the world, one group per axis longer than one, and
a CPU side group the leader's small host descriptors ride), the backend
and whether a CUDA graph can capture its collectives.

The backend follows the device: CPU ranks run gloo, CUDA ranks NCCL, one
card each.  A mesh that needs more cards than the host has is refused, as
JAX's ``build_mesh`` refuses ("mesh needs N devices, have M").
``build_mesh(..., backend="gloo")`` on a CUDA device is the one explicit
exception (gloo takes CUDA tensors for its collectives, so two ranks can
share one card): a check of agreement, not a served configuration.  Gloo's
collectives cannot be captured, so an engine over a gloo mesh runs every
dispatch eagerly; over NCCL the decode graphs are captured and replayed on
every rank (``sharding.DispatchMirror``).  Nothing picks a backend or a
device by itself, and nothing falls back from one backend to another.

Groups.  A mesh outside an initialized world starts one
(``init_process_group`` over a ``file://`` or ``tcp://`` store) and owns
it; inside a world ``multihost.initialize_multihost`` set up it uses that
world.  So a process holds one mesh at a time (one after another is
fine: each tears its world down); a second one is refused at once.  Every group comes from ``new_group``, made by every rank in one
order, and an NCCL group runs one collective at once, so its communicator
exists before any graph capture.  Every collective goes through the
group objects' own methods and counts itself in
:attr:`ParallelMesh.counts` (``all_reduce``, ``all_gather``,
``broadcast``, ``amax``, ``send``, ``recv``), the numbers a smoke run
reads per rank.

Teardown (:meth:`ParallelMesh.close`) runs the same steps on every rank:
the device synchronized, a barrier on the side group, then
``destroy_process_group`` on each group in one order (the world last,
when the mesh owns it).  An NCCL communicator's destruction is collective
in some NCCL versions, so a rank that destroys its groups while a peer is
still inside a collective, or in another order, waits for ever; the
barrier puts every rank past its last collective first.

Point to point.  :class:`RankExchange` sends and receives over one axis
(the ring's rotation is one ``batch_isend_irecv`` a step) and counts the
bytes each rank sends to the leader; :class:`LocalExchange` is its twin
for ranks that are threads of one process, which the tests drive.
"""

from __future__ import annotations

import collections
import datetime
import os
import queue
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# how long a collective waits for its peers before it raises: a rank that
# died fails its peers' dispatches within this bound (DYN_DIST_TIMEOUT_S)
DEFAULT_TIMEOUT_S = 120.0
# a follower waits this long for the leader's next descriptor: an idle
# leader is not a dead one (a dead leader closes its sockets, which ends
# the wait at once)
IDLE_TIMEOUT_S = 7 * 24 * 3600.0
# the grid's axes, outermost first (tp innermost)
AXES = ("dp", "pp", "sp", "ep", "tp")
# the mesh this process holds, until it closes (module docstring)
_held: Optional["ParallelMesh"] = None


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

    @property
    def prefill_axis(self) -> Optional[str]:
        """``"sp"`` or ``"pp"`` for a ring or pipeline mesh, else None."""
        return "sp" if self.sp > 1 else "pp" if self.pp > 1 else None


def refuse_unserved_axes(cfg: MeshConfig) -> None:
    """The port serves tp and ep (together), and sp and pp each alone:
    dp inside one engine, and sp or pp beside any other axis, are later
    work, refused by name."""
    if cfg.dp != 1:
        raise ValueError(
            f"dp={cfg.dp}: data parallelism inside one engine is not served by the "
            "PyTorch port yet"
        )
    axis = cfg.prefill_axis
    if axis is None:
        return
    others = [f"{a}={getattr(cfg, a)}" for a in ("pp", "sp", "ep", "tp")
              if a != axis and getattr(cfg, a) != 1]
    if others:
        raise ValueError(
            f"{axis}={getattr(cfg, axis)} with {', '.join(others)}: not served by the "
            "PyTorch port yet (sp and pp are served alone)"
        )


def _check_backend(backend: str) -> None:
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: the port's ranks run gloo or nccl")


def check_devices(local_ranks: int, backend: str) -> None:
    """JAX's ``build_mesh`` refusal: NCCL takes one card per rank, so the
    ranks of one host need as many cards."""
    _check_backend(backend)
    if backend == "nccl":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < local_ranks:
            raise ValueError(f"mesh needs {local_ranks} devices, have {have}")


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def rank_devices(device: torch.device, world: int) -> List[str]:
    """Each rank's device: one card each from the leader's on (NCCL), or
    the leader's own device for every rank (the CPU)."""
    if device.type != "cuda":
        return [str(device)] * world
    first = device.index if device.index is not None else torch.cuda.current_device()
    count = torch.cuda.device_count()
    return [f"cuda:{(first + r) % count}" for r in range(world)]


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


def grid_coords(config: MeshConfig, rank: int) -> Dict[str, int]:
    """Rank -> its index on ep, tp and every other axis longer than one,
    in axis order (tp innermost)."""
    index: Dict[str, int] = {}
    rest = rank
    for axis in reversed(AXES):
        n = getattr(config, axis)
        index[axis] = rest % n
        rest //= n
    return {a: index[a] for a in AXES if a in ("ep", "tp") or getattr(config, a) > 1}


def grid_rank(config: MeshConfig, coords: Dict[str, int]) -> int:
    rank = 0
    for axis in AXES:
        rank = rank * getattr(config, axis) + coords.get(axis, 0)
    return rank


def axis_ranks(config: MeshConfig, coords: Dict[str, int], axis: str) -> List[int]:
    """The global ranks along ``axis`` through ``coords``, in axis order."""
    return [grid_rank(config, dict(coords, **{axis: i}))
            for i in range(getattr(config, axis))]


class ParallelMesh:
    """This rank's view of the grid (see the module docstring).

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
        _check_backend(backend)
        if _held is not None:
            raise RuntimeError(
                f"this process holds a mesh already ({_held.describe()}): close it first"
            )
        self.config = config
        self.rank = rank
        self.world = config.num_devices
        self.device = device
        self.backend = backend
        self.timeout = timeout or _timeout()
        self.coords = grid_coords(config, rank)
        self.tp_ranks = axis_ranks(config, self.coords, "tp")
        self.ep_ranks = axis_ranks(config, self.coords, "ep")
        self.counts: Dict[str, int] = collections.Counter()
        self.groups: Dict[str, Any] = {}
        self._owns_world = False
        self._closed = False
        if not dist.is_initialized():
            if init_method is None:
                raise ValueError("a mesh outside an initialized world needs init_method")
            store = _store_from(init_method, rank, self.world, self.timeout)
            dist.init_process_group(
                backend, store=dist.PrefixStore("mesh", store), rank=rank,
                world_size=self.world, timeout=self.timeout,
            )
            self._owns_world = True
        try:
            self._make_groups()
        except BaseException:
            if self._owns_world:
                dist.destroy_process_group()
            raise
        _hold(self)

    # -- groups -------------------------------------------------------------

    def _make_groups(self) -> None:
        """``new_group`` for every group, made by every rank in one order
        (the call is collective over the world), then one collective on
        each device group this rank is in, in the same order."""
        if dist.get_world_size() != self.world:
            raise ValueError(
                f"mesh of {self.world} ranks in a world of {dist.get_world_size()}"
            )
        everyone = list(range(self.world))
        self.groups["world"] = dist.new_group(everyone, timeout=self.timeout)
        side_timeout = self.timeout if self.rank == 0 else datetime.timedelta(
            seconds=IDLE_TIMEOUT_S
        )
        self.groups["side"] = dist.new_group(everyone, timeout=side_timeout, backend="gloo")
        cfg = self.config
        for axis in AXES[1:]:
            if getattr(cfg, axis) == 1:
                continue
            # every line of the axis, each made by every rank
            lines = sorted({tuple(axis_ranks(cfg, grid_coords(cfg, r), axis)) for r in everyone})
            for line in lines:
                g = dist.new_group(list(line), timeout=self.timeout)
                if self.rank in line:
                    self.groups[axis] = g
        if self.backend == "nccl":
            torch.cuda.set_device(self.device)
            for name in ("world", *AXES[1:]):
                if name in self.groups:
                    x = torch.zeros(1, device=self.device)
                    self.groups[name].allreduce([x]).wait()
            torch.cuda.synchronize(self.device)

    @property
    def tp_group(self):
        return self.groups.get("tp")

    @property
    def ep_group(self):
        return self.groups.get("ep")

    @property
    def side_group(self):
        return self.groups["side"]

    @property
    def world_group(self):
        return self.groups["world"]

    # -- identity -----------------------------------------------------------

    @property
    def tp(self) -> int:
        return self.config.tp

    @property
    def ep(self) -> int:
        return self.config.ep

    @property
    def sp(self) -> int:
        return self.config.sp

    @property
    def pp(self) -> int:
        return self.config.pp

    @property
    def prefill_axis(self) -> Optional[str]:
        return self.config.prefill_axis

    @property
    def shards_trunk(self) -> bool:
        """Whether every trunk pass runs on every rank (tp or ep); a ring
        or pipeline mesh runs decode on the leader alone."""
        return self.tp * self.ep > 1

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this mesh's collectives."""
        return self.backend == "nccl"

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
            "tp": self.tp, "ep": self.ep, "sp": self.sp, "pp": self.pp,
            "world": self.world, "rank": self.rank, "backend": self.backend,
            "device": str(self.device), "graphs": self.capturable,
        }

    # -- collectives ----------------------------------------------------------

    def _group(self, name: str):
        return self.groups[name]

    def size(self, name: str) -> int:
        return self.world if name == "world" else getattr(self.config, name)

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

    def exchange(self, axis: str) -> "RankExchange":
        """Point-to-point sends and receives along ``axis``."""
        return RankExchange(self, axis)

    # -- teardown -------------------------------------------------------------

    def close(self, lost: bool = False) -> None:
        """The ordered teardown (module docstring): call it with no
        collective in flight (after the leader's last descriptor), on every
        rank.  ``lost``: a peer is gone, so the device is not waited for and
        the barrier is skipped; the groups are aborted, not destroyed."""
        if self._closed:
            return
        self._closed = True
        _hold(None)
        order = [self.groups[n] for n in ("world", "side", *AXES[1:]) if n in self.groups]
        self.groups = {}
        if lost and self.backend == "nccl":
            abort = dist.distributed_c10d._abort_process_group
            for g in [None] if self._owns_world else order:
                abort(g)
            return
        if not lost:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            order[1].barrier().wait()
        if self._owns_world:
            # every group of the world, in the order of their names
            dist.destroy_process_group()
            return
        for g in order:
            dist.destroy_process_group(g)


def _hold(mesh: Optional[ParallelMesh]) -> None:
    global _held
    _held = mesh


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
    refused with fewer, by JAX's message."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    backend = backend or default_backend(device)
    refuse_unserved_axes(cfg)
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


# ---------------------------------------------------------------------------
# point to point
# ---------------------------------------------------------------------------


class RankExchange:
    """Sends and receives between the ranks of one axis of a mesh, by
    axis index.  ``rotate`` is the ring's step: every rank sends to the
    next and receives from the previous in one ``batch_isend_irecv`` (NCCL
    groups the pair, so no rank waits on another's send).  Gloo sends host
    memory only, so a CUDA tensor is staged through the host there.  The
    mesh's ``to_leader_bytes`` counts what ``send`` handed axis index 0
    (the ring's rotations aside)."""

    def __init__(self, mesh: ParallelMesh, axis: str) -> None:
        self.mesh = mesh
        self.group = mesh.groups[axis]
        self.ranks = axis_ranks(mesh.config, mesh.coords, axis)
        self.rank = mesh.coords[axis]
        self.size = len(self.ranks)
        self._host = mesh.backend == "gloo"

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self._host else t.contiguous()

    def send(self, t: torch.Tensor, dst: int) -> None:
        self.mesh.counts["send"] += 1
        if dst == 0:
            self.mesh.counts["to_leader_bytes"] += t.numel() * t.element_size()
        dist.send(self._wire(t), self.ranks[dst], group=self.group)

    def recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if self._host else like.device)
        dist.recv(buf, self.ranks[src], group=self.group)
        self.mesh.counts["recv"] += 1
        return buf.to(like.device)

    def rotate(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor to the next rank of the ring; the previous rank's
        in its place."""
        nxt, prv = (self.rank + 1) % self.size, (self.rank - 1) % self.size
        out = [torch.empty(t.shape, dtype=t.dtype, device="cpu" if self._host else t.device)
               for t in tensors]
        ops = []
        for t, o in zip(tensors, out):
            self.mesh.counts["send"] += 1
            ops.append(dist.P2POp(dist.isend, self._wire(t), self.ranks[nxt], self.group))
            ops.append(dist.P2POp(dist.irecv, o, self.ranks[prv], self.group))
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        self.mesh.counts["recv"] += len(tensors)
        return [o.to(t.device) for o, t in zip(out, tensors)]


class LocalExchange:
    """:class:`RankExchange` for ranks that are threads of one process:
    one FIFO per (source, destination).  ``LocalExchange.group(n)`` gives
    the ``n`` ranks' views; every wait is bounded."""

    WAIT_S = 60.0

    def __init__(self, rank: int, size: int, boxes: Dict[Any, "queue.Queue"]) -> None:
        self.rank = rank
        self.size = size
        self._boxes = boxes
        self.to_leader = 0

    @classmethod
    def group(cls, size: int) -> List["LocalExchange"]:
        boxes = {(s, d): queue.Queue() for s in range(size) for d in range(size)}
        return [cls(r, size, boxes) for r in range(size)]

    def send(self, t: torch.Tensor, dst: int) -> None:
        if dst == 0:
            self.to_leader += t.numel() * t.element_size()
        self._boxes[(self.rank, dst)].put(t.clone())

    def recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        return self._boxes[(src, self.rank)].get(timeout=self.WAIT_S)

    def rotate(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        nxt, prv = (self.rank + 1) % self.size, (self.rank - 1) % self.size
        for t in tensors:
            self._boxes[(self.rank, nxt)].put(t.clone())
        return [self.recv(t, prv) for t in tensors]
