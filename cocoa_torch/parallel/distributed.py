"""Multi-process runtime (counterpart of cocoa_tpu/parallel/distributed.py).

The reference's ``--master`` selects the Spark cluster manager
(hingeDriver.scala:23: ``local[4]`` or a ``spark://host:port`` URL).  The
JAX package connects its processes through ``jax.distributed``; here the
processes form a ``torch.distributed`` gang over TCP: every rank runs the
same program, ``--master=host:port`` names the rendezvous, and rank r of
P holds the K/P consecutive shards [r*m, (r+1)*m) (parallel/mesh.py).

Two groups carry the gang's traffic:

- the **host group**, gloo over the whole world: host bytes and CPU
  tensors (the backend probe, :func:`host_allgather_bytes`, the
  checkpoint's alpha gather);
- the **device group**: the round's all-reduce of dw and the eval's
  sums (parallel/fanout.py).  NCCL when every rank has a card of its own
  (:func:`device_backend`), else the host group itself; on the CPU
  always gloo.  A failed NCCL set-up raises: the rule is not a quiet
  fallback.

``--master=local[...]`` / ``local`` / empty keeps the single-process
path, as the reference's local mode.  Anything of the form ``host:port``
(or ``spark://host:port``, accepted for drop-in compatibility) is the
rendezvous address.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
from typing import Optional

import torch

# how long a rank waits for its peers at the rendezvous and in each
# collective before it raises
TIMEOUT_S = 600.0


def parse_master(master: Optional[str]) -> Optional[str]:
    """Coordinator address from a reference-style --master value, or None
    for local mode."""
    if not master:
        return None
    m = master.strip()
    if m == "local" or m.startswith("local["):
        return None
    for prefix in ("spark://", "jax://", "grpc://"):
        if m.startswith(prefix):
            m = m[len(prefix):]
            if ":" not in m:
                # an explicit scheme unambiguously requests cluster mode —
                # silently degrading to local would train K independent
                # copies, one per host
                raise ValueError(
                    f"--master={master!r} requests cluster mode but has no "
                    f"port; use {prefix}host:port"
                )
            return m
    return m if ":" in m else None


def maybe_initialize(
    master: Optional[str],
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
    timeout_s: float = TIMEOUT_S,
) -> bool:
    """Join this process to the gang if --master names a coordinator:
    ``torch.distributed`` with the gloo world group, rendezvous at
    ``tcp://<coordinator>``.  Returns True iff distributed mode was
    initialized.

    ``process_id`` / ``num_processes`` fall back to COCOA_PROCESS_ID /
    COCOA_NUM_PROCESSES.  Unlike a TPU pod, nothing on a GPU host tells a
    process its rank, so a rank or world size that is still missing
    raises."""
    coordinator = parse_master(master)
    if coordinator is None:
        return False
    if process_id is None and os.environ.get("COCOA_PROCESS_ID"):
        process_id = int(os.environ["COCOA_PROCESS_ID"])
    if num_processes is None and os.environ.get("COCOA_NUM_PROCESSES"):
        num_processes = int(os.environ["COCOA_NUM_PROCESSES"])
    if process_id is None or num_processes is None:
        raise ValueError(
            f"--master={master} needs --processId and --numProcesses (or "
            f"COCOA_PROCESS_ID and COCOA_NUM_PROCESSES): a GPU host has no "
            f"metadata server to tell a process its rank")
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(
            f"--processId={process_id} must lie in [0, --numProcesses="
            f"{num_processes})")
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", rank=process_id,
        world_size=num_processes,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def initialized() -> bool:
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized())


def rank_device(rank: int, device) -> torch.device:
    """Rank r's device: ``cuda:(r % cards)`` on CUDA, the CPU when the
    caller asks for it."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def device_backend(posts, cuda: bool) -> str:
    """The device group's backend from every rank's posted (host name,
    device index) pair: ``nccl`` when the ranks are on CUDA and no two
    share a card, else ``gloo`` (NCCL cannot put two ranks on one card;
    on the CPU the device group is the host group)."""
    posts = [tuple(p) for p in posts]
    if cuda and len(set(posts)) == len(posts):
        return "nccl"
    return "gloo"


def host_allgather_bytes(payload: bytes, group=None) -> list:
    """All-gather one bytes payload per rank over the host group; returns
    the payloads in rank order (every rank sees the same list).
    Single-process: ``[payload]``."""
    if not initialized():
        return [bytes(payload)]
    out = [None] * torch.distributed.get_world_size(group)
    torch.distributed.all_gather_object(out, bytes(payload), group=group)
    return out


def host_gather_shards(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Every rank's block of shards, concatenated in rank order along
    ``axis`` (the shard axis), on the host: the checkpoint's whole alpha
    from each rank's (m, n_shard), over the gloo host group (gloo gathers
    host tensors only).  Single-process: ``x`` on the host."""
    x = x.detach().cpu().contiguous()
    if not initialized():
        return x
    parts = [torch.empty_like(x)
             for _ in range(torch.distributed.get_world_size())]
    torch.distributed.all_gather(parts, x)
    return torch.cat(parts, dim=axis)


def post_device(device: torch.device) -> list:
    """Every rank's (host name, device index) pair, in rank order, over
    the host group: what :func:`device_backend` decides from."""
    mine = (socket.gethostname(), -1 if device.type != "cuda"
            else device.index)
    return [pickle.loads(b) for b in
            host_allgather_bytes(pickle.dumps(mine))]


def shutdown() -> None:
    """Leave the gang: destroy every process group (a no-op when none
    was set up)."""
    if initialized():
        torch.distributed.destroy_process_group()
