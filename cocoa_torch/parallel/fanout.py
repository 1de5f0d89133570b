"""The port's one place that reduces across ranks, and the fleet's lane
fan-out (counterpart of cocoa_tpu/parallel/fanout.py).

The JAX package's ``fanout`` runs a per-shard function over the K shards
and sums its first output: over the m = K/D shards of a device in the
device, then ONE ``psum`` over the dp axis.  The port's solvers run
their local shards batched, as before, and sum them in the device; then
:func:`all_reduce_sum` sums across the gang's ranks.  Without a mesh
(one process, no ``--master``) nothing crosses a process and it returns
its input.  Each reducer counts its calls, as the kernel wrappers count
their launches (cocoa_torch/kernels.py ``count_launches``), so a call
inside a captured CUDA graph counts at each replay; the counts are the
port's form of tests/test_comm_contract.py (one all-reduce a round, one
an eval).  With a mesh of one rank the call is still made on the group.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from cocoa_torch import kernels

LANE_EXECS = ("vmap", "map")


def shards_per_device(mesh, k: int) -> int:
    """m = logical shards per mesh position (Spark multiplexes K partitions
    onto fewer executors via ``coalesce``, OptUtils.scala:14; a rank of
    the gang runs its m = K/D shards batched).  1:1 when mesh is None
    (the local path IS the all-shards-on-one-device case)."""
    if mesh is None:
        return 1
    d = mesh.size
    if k % d != 0:
        raise ValueError(
            f"{k} shards cannot multiplex evenly onto the {d}-device dp "
            f"axis; K must be a multiple of the mesh size"
        )
    return k // d


def _all_reduce(x: torch.Tensor, mesh, op) -> torch.Tensor:
    out = x.clone()
    torch.distributed.all_reduce(out, op=op, group=mesh.device_group)
    return out


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the gang's ranks (a new tensor, on x's device),
    or ``x`` itself without a mesh."""
    if mesh is None:
        return x
    all_reduce_sum.calls += 1
    return _all_reduce(x, mesh, torch.distributed.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x``'s elementwise maximum over the gang's ranks, or ``x`` itself
    without a mesh: the lasso certificate's max |a_j.r| over the column
    shards (cocoa_tpu/solvers/prox_cocoa.py:78)."""
    if mesh is None:
        return x
    all_reduce_max.calls += 1
    return _all_reduce(x, mesh, torch.distributed.ReduceOp.MAX)


kernels.count_launches(all_reduce_sum, "calls")
kernels.count_launches(all_reduce_max, "calls")


def lane_fanout(per_lane: Callable, lane_exec: str = "vmap",
                batched: Optional[Callable] = None) -> Callable:
    """The fleet's chunk over every lane, ``fn(state, tables, *extra) ->
    state`` on the stacked (T, ...) state.  ``lane_exec``:

    - ``"vmap"``: ``batched(state, tables, *extra)``, one batched step
      over the T*K flattened shard rows, each row with its tenant's
      lambda*n and sigma' (the throughput mode; its batched reductions
      may round a few ulps away from a solo run at T > 1, bit for bit at
      T = 1);
    - ``"map"``: a loop over the lanes, ``per_lane(t, state_t, tables,
      *extra) -> state_t`` on lane t's slices, which runs the solo
      round's own code, so that every lane is its solo run bit for bit
      at any T.

    JAX vectorises one per-lane function with ``jax.vmap``; here the
    batched step is written out, since the inner loops scatter in place."""
    if lane_exec not in LANE_EXECS:
        raise ValueError(f"lane_exec must be vmap|map, got {lane_exec!r}")
    if lane_exec == "vmap":
        if batched is None:
            raise ValueError("lane_exec='vmap' needs the batched step")
        return batched

    def mapped(state, tables, *extra):
        lanes = [per_lane(t, tuple(x[t] for x in state), tables, *extra)
                 for t in range(state[0].shape[0])]
        return tuple(torch.stack(parts) for parts in zip(*lanes))

    return mapped
