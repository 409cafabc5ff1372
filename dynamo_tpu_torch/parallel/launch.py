"""Follower ranks: their processes, and what each one runs.

A tensor- or expert-parallel engine is one process per rank.  The leader
(global rank 0) runs ``TorchEngine``; :func:`start_local_ranks` starts this
host's other ranks as processes of their own (``python -m
dynamo_tpu_torch.parallel.launch SPEC RANK``) from a grid spec (the grid,
the rendezvous, each rank's device and backend) and :func:`leader_mesh`
builds the leader's mesh while they join, watching them: a rank that
exits first fails the start at once.  A follower then serves one engine
after another on its mesh (:func:`follow`): the leader announces each
engine's spec (the model and pool geometry and where the params come
from: drawn from a seed, read from a checkpoint, or sent by the leader),
the follower builds its params shard and pool, reports ready and runs
:class:`sharding.Follower`'s loop until that engine stops; a ``None``
spec (:func:`dismiss`) ends it, and so does a lost leader.  Every wait
here is bounded.  A follower then tears its groups down in the leader's
order (``ParallelMesh.close``) and exits.

``DYN_STOP_TRACE_S=N`` arms ``faulthandler`` on the leader and on every
follower as a stop begins: a stop that has not returned within N seconds
prints every thread's stack (to stderr), where the teardown waits.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
import faulthandler
import logging
import os
import pickle
import subprocess
import sys
import tempfile
import time
from dataclasses import asdict
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..engine.config import ModelConfig
from .mesh import MeshConfig, ParallelMesh, build_mesh
from .sharding import Follower, build_rank_params, make_pool

logger = logging.getLogger("dynamo.torch_parallel")

# how long the leader waits for a follower to exit after its stop
JOIN_TIMEOUT_S = 30.0


def grid_spec(
    mesh_cfg: MeshConfig,
    devices: List[str],
    backend: str,
    init_method: Optional[str] = None,
    local_ranks: Optional[int] = None,
) -> Dict[str, Any]:
    """What a follower process needs to join the grid: ``devices[r]`` is
    rank r's device."""
    return dict(mesh=asdict(mesh_cfg), devices=list(devices), backend=backend,
                init_method=init_method, local_ranks=local_ranks)


def engine_spec(
    model_cfg: ModelConfig, *, num_pages: int, page_size: int, quantized_pool: bool,
    source: Dict[str, Any],
) -> Dict[str, Any]:
    """What a follower needs to serve one engine: the model and pool
    geometry and where its params come from
    (``sharding.build_rank_params``)."""
    return dict(model=asdict(model_cfg), num_pages=num_pages, page_size=page_size,
                quantized_pool=quantized_pool, source=dict(source))


@contextlib.contextmanager
def stop_watch():
    """Within the block, ``DYN_STOP_TRACE_S=N`` (when set) has every
    thread's stack printed if N seconds pass (module docstring)."""
    raw = os.environ.get("DYN_STOP_TRACE_S", "").strip()
    if raw:
        faulthandler.dump_traceback_later(float(raw), exit=False)
    try:
        yield
    finally:
        if raw:
            faulthandler.cancel_dump_traceback_later()


def announce(mesh: ParallelMesh, spec: Dict[str, Any]) -> None:
    """The leader: the next engine's spec to every follower."""
    mesh.broadcast_object(spec)


def dismiss(mesh: ParallelMesh) -> None:
    """The leader: no further engine; the followers exit."""
    mesh.broadcast_object(None)


def run_follower(
    mesh: ParallelMesh, spec: Dict[str, Any], whole: Optional[Dict[str, Any]] = None
) -> Follower:
    """Build this follower's shard and pool for one engine, report ready
    and serve until that engine stops.  Returns the follower (its
    counters) after the stop."""
    from ..engine.kv_cache import torch_dtype

    cfg = ModelConfig(**spec["model"])
    dtype = torch_dtype(cfg.dtype)
    params = build_rank_params(spec["source"], cfg, mesh, dtype, whole)
    pool = make_pool(cfg, mesh, spec["num_pages"], spec["page_size"], dtype,
                     spec["quantized_pool"])
    mesh.gather_objects({"rank": mesh.rank, "ready": True})
    follower = Follower(mesh, cfg, params, pool)
    follower.serve()
    return follower


def follow(mesh: ParallelMesh) -> int:
    """Serve the engines the leader announces until it dismisses this
    rank.  Returns how many were served."""
    import gc

    served = 0
    while True:
        spec = mesh.broadcast_object()
        if spec is None:
            return served
        run_follower(mesh, spec)
        served += 1
        with stop_watch():
            gc.collect()
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
                torch.cuda.empty_cache()


class LocalRanks:
    """This host's follower processes."""

    def __init__(
        self, procs: Dict[int, subprocess.Popen], tmpdir: Optional[str], spec: Dict[str, Any]
    ) -> None:
        self.procs = procs
        self.spec = spec
        self._tmpdir = tmpdir
        # a leader that exits without stopping its engine still ends them
        atexit.register(self.kill)

    def lost(self) -> List[Tuple[int, int]]:
        """(rank, exit code) of every follower that exited."""
        return [(r, p.returncode) for r, p in self.procs.items() if p.poll() is not None]

    def join(self, timeout: float = JOIN_TIMEOUT_S) -> None:
        """Wait for the followers to exit (after the leader's stop), then
        kill what is left."""
        deadline = time.monotonic() + timeout
        for p in self.procs.values():
            try:
                p.wait(max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                pass
        self.kill()

    def kill(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                try:
                    p.wait(10)
                except subprocess.TimeoutExpired:
                    pass
        if self._tmpdir is not None:
            import shutil

            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None


def start_local_ranks(
    mesh_cfg: MeshConfig,
    spec: Dict[str, Any],
    ranks: Optional[List[int]] = None,
    env: Optional[Dict[str, str]] = None,
) -> LocalRanks:
    """Start followers ``ranks`` (default 1..world-1) of ``spec`` as
    processes; a file:// rendezvous in a temporary directory when the
    spec names none."""
    tmpdir = tempfile.mkdtemp(prefix="dyn-ranks-")
    if spec.get("init_method") is None:
        spec = dict(spec, init_method="file://" + os.path.join(tmpdir, "store"))
    path = os.path.join(tmpdir, "spec.pkl")
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    ranks = list(range(1, mesh_cfg.num_devices)) if ranks is None else ranks
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    penv = dict(os.environ, **(env or {}))
    penv["PYTHONPATH"] = root + os.pathsep + penv.get("PYTHONPATH", "")
    procs = {
        r: subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.parallel.launch", path, str(r)],
            env=penv,
        )
        for r in ranks
    }
    return LocalRanks(procs, tmpdir, spec)


def leader_mesh(
    mesh_cfg: MeshConfig, spec: Dict[str, Any], ranks: LocalRanks
) -> ParallelMesh:
    """Build rank 0's mesh while the followers join, failing as soon as
    one exits (and after the groups' timeout at the latest)."""
    device = torch.device(spec["devices"][0])
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(
            build_mesh, mesh_cfg, 0, device, spec["backend"], ranks.spec["init_method"],
            spec.get("local_ranks"),
        )
        while True:
            try:
                return fut.result(timeout=0.2)
            except concurrent.futures.TimeoutError:
                lost = ranks.lost()
                if lost:
                    ranks.kill()
                    raise RuntimeError(
                        f"follower rank {lost[0][0]} exited with code {lost[0][1]} "
                        "before the mesh formed"
                    ) from None


def main(argv: List[str]) -> int:
    """A follower process: ``SPEC RANK``."""
    logging.basicConfig(
        level=os.environ.get("DYN_LOG", "warning").upper(),
        format=f"%(asctime)s rank{argv[1]} %(name)s %(levelname)s %(message)s",
    )
    with open(argv[0], "rb") as f:
        spec = pickle.load(f)
    rank = int(argv[1])
    device = torch.device(spec["devices"][rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if spec.get("multinode"):
        # a rank of a multi-host world: join it first (its rank is global)
        from .multihost import MultiNodeConfig, initialize_multihost

        local = spec["local_ranks"]
        mn = MultiNodeConfig(**spec["multinode"])
        initialize_multihost(mn, rank - mn.global_rank(0, local), local, spec["backend"])
    mesh = build_mesh(
        MeshConfig(**spec["mesh"]), rank, device, spec["backend"], spec["init_method"],
        spec.get("local_ranks"),
    )
    try:
        follow(mesh)
    except Exception as e:  # the leader is gone, or this rank failed
        logger.warning("follower rank %d stops: %s", rank, e)
        mesh.close(lost=True)
        return 1
    with stop_watch():
        mesh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
