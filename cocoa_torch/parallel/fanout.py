"""Fan a fleet's per-tenant step out over its lanes (counterpart of
cocoa_tpu/parallel/fanout.py ``lane_fanout``; the mesh parts of that
module are not ported yet)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

LANE_EXECS = ("vmap", "map")


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
