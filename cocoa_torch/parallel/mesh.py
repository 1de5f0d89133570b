"""The data-parallel mesh (counterpart of the dp half of
cocoa_tpu/parallel/mesh.py).

In the JAX package the dp mesh is a set of devices, possibly of one
process.  Here it is the process group: one rank per device, rank r
holding the m = K/P consecutive logical shards [r*m, (r+1)*m) and running
them as the single-process path runs all K; w is replicated on every
rank, and the round's dw is summed across ranks by one all-reduce
(parallel/fanout.py).  A single process with no ``--master`` has no mesh
(None), which is the JAX package's ``--mesh=1`` path.
"""

from __future__ import annotations

from typing import Optional

import torch

from cocoa_torch.parallel import distributed


class Mesh:
    """The gang as the solvers see it: this process's ``rank`` of
    ``size``, its ``device``, the ``backend`` of its device group (nccl
    or gloo), and ``device_group``, the group of the round's all-reduce
    (None: the default world group, gloo, which also carries the host
    traffic)."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 backend: str, device_group=None):
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        self.device_group = device_group

    @property
    def capturable(self) -> bool:
        """Whether the device group's collectives can sit inside a
        captured CUDA graph: NCCL can be captured, gloo cannot."""
        return self.device.type == "cuda" and self.backend == "nccl"

    def describe(self) -> str:
        return (f"rank {self.rank} of {self.size} on {self.device}, device "
                f"group {self.backend}")


def make_mesh(k: Optional[int] = None, device="cuda") -> Mesh:
    """The (dp,) mesh over the gang that :func:`distributed.maybe_initialize`
    joined: ``k`` positions (default: every rank), one per rank, each on
    ``cuda:(rank % cards)`` unless ``device`` is the CPU.  The ranks
    post their (host, card) pairs over the host group and pick the device
    group's backend from them (:func:`distributed.device_backend`); an
    NCCL group is set up and used once here, so a failure raises now."""
    if not distributed.initialized():
        raise ValueError("a dp mesh needs the gang: --master=host:port with "
                         "--processId and --numProcesses")
    world = torch.distributed.get_world_size()
    if k is None:
        k = world
    if k != world:
        raise ValueError(f"mesh ({k} dp x 1 fp) needs {k} devices, have "
                         f"{world}")
    rank = torch.distributed.get_rank()
    dev = distributed.rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = distributed.device_backend(distributed.post_device(dev),
                                         dev.type == "cuda")
    group = None
    if backend == "nccl":
        group = torch.distributed.new_group(backend="nccl")
        probe = torch.ones(1, device=dev)
        torch.distributed.all_reduce(probe, group=group)
        if int(probe.item()) != world:
            raise RuntimeError(f"the NCCL device group's first all-reduce "
                               f"gave {probe.item()}, expected {world}")
    return Mesh(rank, world, dev, backend, device_group=group)


def dp_local_shards(mesh: Mesh, k: int) -> list:
    """``[(device, shard_lo, shard_hi)]`` for THIS process's dp position:
    the m = K/D consecutive logical shards [r*m, (r+1)*m) of rank r, the
    multiplexing contract :func:`cocoa_torch.parallel.fanout.
    shards_per_device` runs the solvers under."""
    d = mesh.size
    if k % d != 0:
        raise ValueError(
            f"{k} shards cannot multiplex evenly onto the {d}-device dp "
            f"axis; K must be a multiple of the mesh size (the elastic "
            f"supervisor's shrink path only ever reforms gangs whose "
            f"device count divides K — elastic.shrink_gang_size)"
        )
    m = k // d
    return [(mesh.device, mesh.rank * m, (mesh.rank + 1) * m)]


def local_part(mesh: Optional[Mesh]) -> Optional[tuple]:
    """(rank, world size) for the shard builders' ``part``, None without a
    mesh."""
    return None if mesh is None else (mesh.rank, mesh.size)
