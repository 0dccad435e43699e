"""Process groups and meshes for multi-GPU detection (torch.distributed).

The port of pigo_tpu/parallel/mesh.py. The JAX package spans its chips
with one controller per host and a `jax.sharding.Mesh` of devices; here
every card has a process of its own, as `torchrun --nproc-per-node N`
starts them, and a mesh is a process group of the first n ranks with this
rank's device. The scale-out axes are the JAX package's:
  - "batch": the frames of a batch split over the ranks (frame data
    parallelism),
  - "window": one frame's pyramid windows split over the ranks (the
    reference serializes about 2e5 windows; the ranks split them).
Collectives run over NCCL between cards, and over gloo on the CPU or
where two ranks share one card (NCCL refuses that). The cascade (234 KB
to 1.2 MB) is replicated on every rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from pigo_tpu_torch.utils.device import resolve_device

# torchrun's environment: with all four present, an argument-less
# init_distributed joins the group it describes
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# How long a rank waits at the rendezvous and in a collective for the
# others: enough for a rank that builds the kernels on arrival
JOIN_TIMEOUT = datetime.timedelta(seconds=300)

# This process's device in the process group, set by init_distributed
# (the group itself is torch.distributed's process-wide state).
_rank_device: torch.device | None = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The first `size` ranks of the process group along one axis.

    `rank` is this process's place in the mesh (-1 for a process outside
    it), `device` the card its work runs on, `group` the process group of
    the mesh's collectives and `backend` that group's ("nccl" or "gloo").
    A mesh without a group is this process alone and runs no collective."""

    axis_name: str
    size: int
    rank: int
    device: torch.device
    group: object = None
    backend: str | None = None


def make_mesh(n_devices: int | None = None, axis_name: str = "window", *,
              device=None) -> Mesh:
    """A mesh of the first n ranks (default: all of them). Every rank of
    the group must call it (a mesh smaller than the group is a new
    subgroup); ranks from n up get a mesh with rank -1, which they cannot
    run. Without a process group, n = 1 gives a mesh of this process on
    `device` (None: the card, see utils/device.resolve_device). `device`
    overrides the one init_distributed chose. Raises ValueError when n
    exceeds the ranks there are."""
    if not dist.is_initialized():
        n = 1 if n_devices is None else int(n_devices)
        if n != 1:
            raise ValueError(f"requested {n} devices, have 1")
        return Mesh(axis_name, 1, 0, resolve_device(device))
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"requested {n} devices, have {world}")
    group = (dist.group.WORLD if n == world
             else dist.new_group(list(range(n))))
    rank = dist.get_rank()
    return Mesh(axis_name, n, rank if rank < n else -1,
                resolve_device(device if device is not None
                               else _rank_device),
                group, dist.get_backend())


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *, device=None,
                     backend: str | None = None) -> int:
    """Join the process group and return the global device count (the
    world size). Call once per process, before make_mesh.

    With an explicit `coordinator` ("host:port", with `num_processes` and
    `process_id`) any failure to join raises: a caller asking for a
    specific group must not run alone. Without arguments it joins the group
    that torchrun's environment describes (TORCHRUN_ENV), and outside one
    it is a no-op that returns 1 (or the size of a group already joined).

    The rank's device is `device`, or cuda:LOCAL_RANK (LOCAL_RANK from the
    environment, else the process id), named explicitly, never the current
    device; `device="cpu"` runs the plain versions. The backend is NCCL for
    a card and gloo for the CPU; `backend="gloo"` on a card lets two ranks
    share it. NCCL without a card or without NCCL in this torch raises
    RuntimeError, as does a card index the machine does not have. Build
    the kernels before joining: the first launch builds them, and a rank
    that builds while the others wait can outlast JOIN_TIMEOUT."""
    global _rank_device
    explicit = coordinator is not None
    if not explicit:
        if dist.is_initialized():
            return dist.get_world_size()
        if not all(k in os.environ for k in TORCHRUN_ENV):
            return 1
    elif num_processes is None or process_id is None:
        raise ValueError("an explicit coordinator needs num_processes and "
                         "process_id")
    rank = int(process_id) if explicit else int(os.environ["RANK"])
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} requested, the machine has "
                           f"{torch.cuda.device_count()} card(s)")
    backend = backend or ("gloo" if dev.type == "cpu" else "nccl")
    if backend == "nccl" and (dev.type != "cuda"
                              or not dist.is_nccl_available()):
        raise RuntimeError(f"NCCL needs a card and a torch built with NCCL; "
                           f"device {dev}, NCCL available: "
                           f"{dist.is_nccl_available()}")
    kw = dict(backend=backend, timeout=JOIN_TIMEOUT)
    if backend == "nccl":
        kw["device_id"] = dev  # bind the communicator to this rank's card
    if explicit:
        dist.init_process_group(init_method=f"tcp://{coordinator}",
                                world_size=int(num_processes), rank=rank,
                                **kw)
    else:
        dist.init_process_group(init_method="env://", **kw)
    _rank_device = dev
    return dist.get_world_size()
