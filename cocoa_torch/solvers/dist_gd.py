"""Distributed (sub)gradient descent (counterpart of
cocoa_tpu/solvers/dist_gd.py; reference DistGD.scala).

Per round every worker takes one full pass over its shard
(ops/subgradient.py), and the driver takes the direction-normalised step
w += dw*(eta/|dw|) with eta = 1/(beta*t) (DistGD.scala:35,40-41).  No
draws and no dual state: the trajectory has the primal objective and
test error only.
"""

from __future__ import annotations

from typing import Optional

import torch

from cocoa_torch.config import DebugParams, Params
from cocoa_torch.data.sharding import ShardedDataset
from cocoa_torch.evals import objectives
from cocoa_torch.ops.rows import nonzero_slots
from cocoa_torch.ops.subgradient import subgradient_pass
from cocoa_torch.parallel.fanout import all_reduce_sum, fp_reducer
from cocoa_torch.solvers import base


def run_dist_gd(ds: ShardedDataset, params: Params, debug: DebugParams,
                test_ds: Optional[ShardedDataset] = None, w_init=None,
                start_round: int = 1, quiet: bool = False,
                scan_chunk: Optional[int] = None,
                capture: Optional[bool] = None, device_loop: bool = False):
    """Train from w = 0, or from ``w_init`` at round ``start_round`` (a
    resumed run); returns (w, Trajectory).  ``scan_chunk``,
    ``capture`` and ``device_loop`` as in
    :func:`cocoa_torch.solvers.cocoa.run_sdca_family` (no draws, so no
    ``sampling``); eta(t) reads the round from the device counter."""
    base.check_shards(ds)
    k = ds.k
    shards = ds.shard_arrays()
    # the sparse pass scatters only the nonzero slots, in slot order
    slots = nonzero_slots(shards)
    fp_sum = fp_reducer(ds.mesh)
    fp_kw = {} if fp_sum is None else dict(fp_sum=fp_sum)
    if not quiet:
        print(f"\nRunning DistGD on {params.n} data examples, "
              f"distributed over {k} workers")

    def round_fn(state, idxs_kh, t):
        (w,) = state
        # the ordered scatter within the rank (C4), then the gang's sum
        dw_sum = all_reduce_sum(
            subgradient_pass(w, shards, params.lam, loss=params.loss,
                             smoothing=params.smoothing,
                             slots=slots, **fp_kw).sum(0), ds.mesh)
        t_c = t.to(w.dtype)
        eta = 1.0 / (params.beta * t_c)
        if fp_sum is None:
            norm = torch.linalg.vector_norm(dw_sum)
        else:
            # |dw| over the whole d: the column blocks' squares summed
            norm = torch.sqrt(fp_sum(dw_sum @ dw_sum))
        return (w + dw_sum * (eta / norm),)

    test = None if test_ds is None else test_ds.shard_arrays()

    def metrics(state):
        # no dual: the gap is NaN
        return objectives.eval_metrics(
            state[0], None, shards, params.lam, ds.n, test_shard_arrays=test,
            test_n=0 if test_ds is None else test_ds.n, loss=params.loss,
            smoothing=params.smoothing, mesh=ds.mesh)

    w = (torch.zeros(ds.w_len, dtype=ds.dtype, device=ds.device)
         if w_init is None else base.restore_w(w_init, ds))
    (w,), traj = base.drive("Dist SGD", params, debug, (w,),
                            base.per_round(round_fn), metrics, None,
                            ds.device, base.chunk_rounds(debug, k, 1,
                                                         scan_chunk),
                            quiet=quiet, start_round=start_round,
                            capture=capture, device_loop=device_loop,
                            mesh=ds.mesh)
    return w, traj
