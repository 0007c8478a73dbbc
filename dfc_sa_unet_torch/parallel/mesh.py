"""The port's "mesh": one process per card (counterpart of
dfc_sa_unet_tpu/parallel/mesh.py).

JAX drives every device of a host from one process over a 1-D ``'data'``
mesh and lets XLA place the collectives.  PyTorch's idiom is one process
per card, so the port's mesh is a small record of this process's place in
the group: world size, rank, local rank, its device and the process group
(``torch.distributed``'s default group while joined, None for a single
process).
The data-parallel arithmetic that XLA inserts in JAX is explicit in the
port: ``parallel/spmd.py`` (the global loss and metrics),
``nn/layers.py::BatchNorm`` (cross-replica statistics) and
``train/trainer.py`` (one flat gradient all-reduce a step).

A group is formed from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) or from
an explicit ``coordinator`` ("host:port"), ``num_processes`` and
``process_id`` (JAX's ``multihost.initialize``).  With neither, the mesh
is a single process: no group, no collective.  The backend is NCCL for a
CUDA device and Gloo on the CPU unless the caller names one (two ranks on
one card need Gloo: NCCL refuses a duplicate GPU).
"""

import datetime
import os
import socket
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from dfc_sa_unet_torch.utils.device import resolve_device

ROW_SHARDING = "row (spatial) sharding is not ported to dfc_sa_unet_torch yet (ROADMAP.md, Queue A 4: row sharding)"


@dataclass
class ProcessMesh:
    world_size: int
    rank: int
    local_rank: int
    device: torch.device
    backend: Optional[str] = None
    joined: bool = False  # this process formed or joined the default group

    @property
    def group(self):
        """The default process group while joined, else None.  Looked up, never held: a reference
        kept past ``destroy_process_group`` keeps Gloo's threads alive until the interpreter exits,
        which can then abort."""
        return dist.group.WORLD if self.joined and dist.is_initialized() else None

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def close(self):
        """Leave the group (a no-op for a single process)."""
        if self.joined and dist.is_initialized():
            dist.destroy_process_group()
        self.joined = False


def local_coordinator() -> str:
    """"localhost:PORT" with a port that was free a moment ago: a coordinator for a group whose
    processes all run on this host (a group of one, or the tests' Gloo groups)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return f"localhost:{sock.getsockname()[1]}"


def _rank_device(device, local_rank: int) -> torch.device:
    """An explicit device wins; ``None`` or an unindexed "cuda" means ``cuda:LOCAL_RANK``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return resolve_device(dev)
    resolve_device(dev)
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK {local_rank} has no card: {torch.cuda.device_count()} visible")
    return torch.device("cuda", local_rank)


def data_parallel_mesh(device=None, backend: Optional[str] = None, coordinator: Optional[str] = None,
                       num_processes: Optional[int] = None, process_id: Optional[int] = None,
                       timeout_s: float = 1800.0) -> ProcessMesh:
    """This process's place in the data-parallel group, forming the group where one is asked for.

    Explicit ``coordinator`` / ``num_processes`` / ``process_id`` win over torchrun's environment.
    A group already formed (by an earlier call) is joined as it is.  ``device`` None or "cuda"
    means ``cuda:LOCAL_RANK``; ``backend`` None means NCCL on CUDA and Gloo on the CPU."""
    env = os.environ
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        local_rank = int(env.get("LOCAL_RANK", 0))
        return ProcessMesh(world, rank, local_rank, _rank_device(device, local_rank), dist.get_backend(), True)
    if coordinator is not None or num_processes is not None:
        world = int(num_processes or 1)
        rank = int(process_id or 0)
        local_rank = int(env.get("LOCAL_RANK", 0))
        addr = f"tcp://{coordinator}" if coordinator else None
    elif "WORLD_SIZE" in env:
        world, rank = int(env["WORLD_SIZE"]), int(env.get("RANK", 0))
        local_rank = int(env.get("LOCAL_RANK", 0))
        addr = "env://"
    else:
        return ProcessMesh(1, 0, 0, resolve_device(device))
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} out of range for {world} processes")
    dev = _rank_device(device, local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if addr is None:
        raise ValueError("num_processes without a coordinator: pass coordinator='host:port' as well")
    dist.init_process_group(backend, init_method=addr, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return ProcessMesh(world, rank, local_rank, dev, backend, True)


def mesh_from_flags(args, backend: Optional[str] = None) -> ProcessMesh:
    """The CLIs' mesh from their flags (``--data_parallel``, ``--multihost``, ``--coordinator``,
    ``--num_processes``, ``--process_id``, ``--device``): a group when the process was started by
    torchrun with ``--data_parallel`` or ``--multihost``, or is given a coordinator; otherwise one
    process on one card."""
    launched = "WORLD_SIZE" in os.environ
    if args.coordinator or ((args.data_parallel or args.multihost) and launched):
        return data_parallel_mesh(args.device, backend, args.coordinator, args.num_processes, args.process_id)
    if launched and int(os.environ["WORLD_SIZE"]) > 1:
        raise SystemExit(f"started as one of {os.environ['WORLD_SIZE']} processes without --data_parallel or "
                         f"--multihost: every process would do the same work alone")
    if args.data_parallel:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print("(--data_parallel: only one device visible; running single-chip)" if visible <= 1 else
              f"(--data_parallel: one process drives one card; start one process per card with "
              f"torchrun --nproc_per_node {visible}; running single-chip)")
    return ProcessMesh(1, 0, 0, resolve_device(args.device))


def add_parallel_flags(parser, what: str):
    """The JAX CLIs' parallel flags (train.py:54-85, inference.py:547-572); ``what`` names the work
    that a process does."""
    parser.add_argument("--data_parallel", action="store_true", default=None,
                        help=f"{what}; start one process per card with torchrun --nproc_per_node N")
    parser.add_argument("--no_data_parallel", action="store_false", dest="data_parallel",
                        help="override a config-enabled data_parallel")
    parser.add_argument("--spatial_parallel", type=int, default=None,
                        help="row (spatial) sharding; accepted, and above 1 it raises: not ported yet")
    parser.add_argument("--multihost", action="store_true", default=None,
                        help="join a multi-process group (torchrun's environment, or --coordinator, "
                             "--num_processes and --process_id)")
    parser.add_argument("--no_multihost", action="store_false", dest="multihost",
                        help="override a config-enabled multihost")
    parser.add_argument("--coordinator", type=str, default=None, help="rank 0's host:port for explicit groups")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)


def serving_mesh(spatial: int = 1, **kw) -> ProcessMesh:
    """The serving mesh: ``spatial`` 1 is :func:`data_parallel_mesh`; row sharding raises."""
    if spatial > 1:
        raise NotImplementedError(f"serving_mesh(spatial={spatial}): {ROW_SHARDING}")
    return data_parallel_mesh(**kw)
