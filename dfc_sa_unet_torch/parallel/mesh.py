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

Row (spatial) sharding (``serving_mesh(spatial=S)``, the CLIs' ``--spatial_parallel S``) lays the
processes out as JAX's ``('data', 'spatial')`` mesh: rank r = d * S + s, the spatial index s
fastest; the S ranks of a data index d form a spatial group, each holding a band of every image's
rows (parallel/rows.py), and the ranks of one spatial index form a data group.  Every process
forms every subgroup, in the same order.

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

from dfc_sa_unet_torch.parallel import rows
from dfc_sa_unet_torch.utils.device import resolve_device

# this process's subgroups of a 2-D mesh: "spatial" and "data" -> the group; cleared by close()
_SUBGROUPS: dict = {}


@dataclass
class ProcessMesh:
    world_size: int
    rank: int
    local_rank: int
    device: torch.device
    backend: Optional[str] = None
    joined: bool = False  # this process formed or joined the default group
    spatial: int = 1  # ranks of a spatial group (row sharding above 1)

    @property
    def data_size(self) -> int:
        return self.world_size // self.spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    @property
    def spatial_group(self):
        """The ranks of this data index (row sharding), looked up as :attr:`group` is."""
        return _SUBGROUPS.get("spatial") if self.group is not None else None

    @property
    def data_group(self):
        """The ranks of this spatial index, looked up as :attr:`group` is."""
        return _SUBGROUPS.get("data") if self.group is not None else None

    def band(self, height: int) -> "rows.Band":
        """This process's band of an image of ``height`` rows (``rows.divides`` must hold)."""
        return rows.band_of(self.rank, self.spatial, height, self.spatial_group, self.backend)

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
        _SUBGROUPS.clear()
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
    """The CLIs' mesh from their flags (``--data_parallel``, ``--spatial_parallel``, ``--multihost``,
    ``--coordinator``, ``--num_processes``, ``--process_id``, ``--device``): a group when the process
    was started by torchrun with ``--data_parallel``, ``--spatial_parallel`` above 1 or
    ``--multihost``, or is given a coordinator; otherwise one process on one card.  With
    ``--spatial_parallel S`` that divides the group the mesh is JAX's 2-D one (rows shard over S
    processes); otherwise it falls back, as the JAX CLIs do, to data parallelism."""
    launched = "WORLD_SIZE" in os.environ
    spatial = int(getattr(args, "spatial_parallel", 1) or 1)
    if args.coordinator or ((args.data_parallel or args.multihost or spatial > 1) and launched):
        mesh = data_parallel_mesh(args.device, backend, args.coordinator, args.num_processes, args.process_id)
        if spatial > 1:
            if mesh.world_size % spatial == 0 and mesh.world_size > 1:
                spatial_subgroups(mesh, spatial)
                if mesh.is_primary:
                    print(f"2-D mesh: data={mesh.data_size} x spatial={spatial} over {mesh.world_size} processes "
                          f"(image rows shard too: halo exchanges between neighbouring bands)")
            elif mesh.is_primary:
                print(f"(--spatial_parallel {spatial}: needs a multiple of {spatial} processes, have "
                      f"{mesh.world_size}; falling back to data parallelism)")
        return mesh
    if launched and int(os.environ["WORLD_SIZE"]) > 1:
        raise SystemExit(f"started as one of {os.environ['WORLD_SIZE']} processes without --data_parallel or "
                         f"--multihost: every process would do the same work alone")
    if spatial > 1:
        print(f"(--spatial_parallel {spatial}: needs a multiple of {spatial} processes, have 1; running "
              f"single-chip; start one process per card with torchrun --nproc_per_node N)")
    elif args.data_parallel:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print("(--data_parallel: only one device visible; running single-chip)" if visible <= 1 else
              f"(--data_parallel: one process drives one card; start one process per card with "
              f"torchrun --nproc_per_node {visible}; running single-chip)")
    return ProcessMesh(1, 0, 0, resolve_device(args.device))


def spatial_subgroups(mesh: ProcessMesh, spatial: int) -> ProcessMesh:
    """Lay ``mesh``'s processes out as data x ``spatial`` (rank d * spatial + s) and form the
    subgroups: every process forms every spatial group, then every data group, in the same order,
    and keeps its own two."""
    n = mesh.world_size
    if n % spatial:
        raise ValueError(f"spatial={spatial} must divide the device count {n} (one process a card)")
    if spatial > 1:
        for d in range(n // spatial):
            g = dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
            if d == mesh.rank // spatial:
                _SUBGROUPS["spatial"] = g
        for s in range(spatial):
            g = dist.new_group(list(range(s, n, spatial)))
            if s == mesh.rank % spatial:
                _SUBGROUPS["data"] = g
    mesh.spatial = spatial
    return mesh


def add_parallel_flags(parser, what: str):
    """The JAX CLIs' parallel flags (train.py:54-85, inference.py:547-572); ``what`` names the work
    that a process does."""
    parser.add_argument("--data_parallel", action="store_true", default=None,
                        help=f"{what}; start one process per card with torchrun --nproc_per_node N")
    parser.add_argument("--no_data_parallel", action="store_false", dest="data_parallel",
                        help="override a config-enabled data_parallel")
    parser.add_argument("--spatial_parallel", type=int, default=None,
                        help="row (spatial) sharding of the DFC family: under torchrun --nproc_per_node N, "
                             "N / S data groups of S processes, each holding a band of every image's rows "
                             "(the height must be a multiple of 16 S, else the batch shards on the data axis "
                             "only); serves one large image exactly across cards (best with --no_slide_window)")
    parser.add_argument("--multihost", action="store_true", default=None,
                        help="join a multi-process group (torchrun's environment, or --coordinator, "
                             "--num_processes and --process_id)")
    parser.add_argument("--no_multihost", action="store_false", dest="multihost",
                        help="override a config-enabled multihost")
    parser.add_argument("--coordinator", type=str, default=None, help="rank 0's host:port for explicit groups")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)


def serving_mesh(spatial: int = 1, **kw) -> ProcessMesh:
    """JAX's 2-D ``('data', 'spatial')`` serving mesh over the processes of
    :func:`data_parallel_mesh` (``**kw``): ``spatial`` ranks a spatial group, each holding a band of
    every image's rows.  ``spatial`` must divide the process count (ValueError, as JAX's)."""
    if spatial < 1:
        raise ValueError(f"spatial={spatial} must be at least 1")
    mesh = data_parallel_mesh(**kw)
    if spatial > 1 and mesh.group is None:
        raise ValueError(f"spatial={spatial} must divide the device count 1 (one process a card)")
    return spatial_subgroups(mesh, spatial)
