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

On a (dp, fp) mesh (``--fp``) the two reducers run over the dp group, the
ranks of one fp slice, so that each shard's sum counts once, and
:func:`fp_sum` sums a d-contraction's partial dots over the fp group, the
F ranks that hold one dp position's column blocks; with F = 1 the dp
group is the whole world and there is no fp sum.
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
    d = mesh.dp_size
    if k % d != 0:
        raise ValueError(
            f"{k} shards cannot multiplex evenly onto the {d}-device dp "
            f"axis; K must be a multiple of the mesh size"
        )
    return k // d


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    out = x.clone()
    torch.distributed.all_reduce(out, op=op, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the gang's dp positions (a new tensor, on x's
    device), or ``x`` itself without a mesh."""
    if mesh is None:
        return x
    all_reduce_sum.calls += 1
    return _all_reduce(x, torch.distributed.ReduceOp.SUM, mesh.dp_group)


def all_reduce_max(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x``'s elementwise maximum over the gang's dp positions, or ``x`` itself
    without a mesh: the lasso certificate's max |a_j.r| over the column
    shards (cocoa_tpu/solvers/prox_cocoa.py:78)."""
    if mesh is None:
        return x
    all_reduce_max.calls += 1
    return _all_reduce(x, torch.distributed.ReduceOp.MAX, mesh.dp_group)


def fp_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x``, a d-contraction over this rank's column block, summed over
    its fp peers (a new tensor): the whole contraction, the same on the
    F ranks.  ``x`` itself without an fp axis."""
    if mesh is None or mesh.fp == 1:
        return x
    fp_sum.calls += 1
    return _all_reduce(x, torch.distributed.ReduceOp.SUM, mesh.fp_group)


def fp_reducer(mesh) -> Optional[Callable]:
    """The ops' ``fp_sum`` hook for ``mesh``: :func:`fp_sum` bound to it
    on an fp mesh, None (nothing to reduce) otherwise."""
    if mesh is None or mesh.fp == 1:
        return None
    return lambda x: fp_sum(x, mesh)


def fp_gather(w: torch.Tensor, mesh) -> torch.Tensor:
    """The whole w (d_pad,) from every rank's column block, on the host,
    in fp-slice order: gathered over the host group (gloo gathers host
    tensors only), the blocks of dp position 0.  ``w`` on the host
    without an fp axis."""
    w = w.detach().cpu().contiguous()
    if mesh is None or mesh.fp == 1:
        return w
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    torch.distributed.all_gather(parts, w)
    return torch.cat(parts[:mesh.fp])


kernels.count_launches(all_reduce_sum, "calls")
kernels.count_launches(all_reduce_max, "calls")
kernels.count_launches(fp_sum, "calls")


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
