"""Distributed SGD, local and mini-batch (counterpart of
cocoa_tpu/solvers/sgd.py; reference SGD.scala).

- local (Local SGD): each worker runs H Pegasos steps on a private w; the
  driver adds the mean dw, scaled by beta/K (SGD.scala:34-37,55-56).
- mini-batch (Mini-batch SGD): the driver pre-scales w by (1 - eta*lam)
  with eta = 1/(lam*t) (SGD.scala:44-50), the workers sum raw
  subgradients at the pre-scaled w, and the driver adds the sum times
  eta*beta/(K*H) (SGD.scala:38,57-59).

No dual state, so the trajectory has the primal objective and test error
only, no gap (SGD.scala:62-66).
"""

from __future__ import annotations

from typing import Optional

import torch

from cocoa_torch.config import DebugParams, Params
from cocoa_torch.data.sharding import ShardedDataset
from cocoa_torch.evals import objectives
from cocoa_torch.ops.local_sgd import local_sgd
from cocoa_torch.parallel.fanout import all_reduce_sum, fp_reducer
from cocoa_torch.solvers import base


def run_sgd(ds: ShardedDataset, params: Params, debug: DebugParams,
            local: bool, test_ds: Optional[ShardedDataset] = None,
            rng: str = "reference", w_init=None, start_round: int = 1,
            quiet: bool = False,
            scan_chunk: Optional[int] = None, sampling: str = "auto",
            capture: Optional[bool] = None, device_loop: bool = False):
    """Train from w = 0, or from ``w_init`` at round ``start_round`` (a
    resumed run); returns (w, Trajectory).  ``scan_chunk``,
    ``sampling``, ``capture`` and ``device_loop`` as in
    :func:`cocoa_torch.solvers.cocoa.run_sdca_family`; eta(t) reads the
    round number from the device counter that the chunk (and the device
    loop) advances from ``start_round``, so a captured chunk replays it."""
    base.check_shards(ds)
    k, h, lam = ds.k, params.local_iters, params.lam
    scaling = params.beta / k if local else params.beta / (k * h)
    shards = ds.shard_arrays()
    fp_sum = fp_reducer(ds.mesh)
    fp_kw = {} if fp_sum is None else dict(fp_sum=fp_sum)
    if not quiet:
        print(f"\nRunning SGD (with local updates = {local}) on {params.n} "
              f"data examples, distributed over {k} workers")

    def round_fn(state, idxs_kh, t):
        (w,) = state
        t_c = t.to(w.dtype)
        eta = 1.0 / (lam * t_c)
        if not local:
            w = w * (1.0 - eta * lam)
        dw = local_sgd(w, shards, idxs_kh, lam, (t_c - 1.0) * h * k, local,
                       loss=params.loss, smoothing=params.smoothing, **fp_kw)
        step = scaling if local else eta * scaling
        return (w + all_reduce_sum(dw.sum(0), ds.mesh) * step,)

    test = None if test_ds is None else test_ds.shard_arrays()

    def metrics(state):
        # no dual: the gap is NaN
        return objectives.eval_metrics(
            state[0], None, shards, lam, ds.n, test_shard_arrays=test,
            test_n=0 if test_ds is None else test_ds.n, loss=params.loss,
            smoothing=params.smoothing, mesh=ds.mesh)

    w = (torch.zeros(ds.w_len, dtype=ds.dtype, device=ds.device)
         if w_init is None else base.restore_w(w_init, ds))
    sampler = base.make_sampler(rng, debug.seed, h, ds.counts, sampling,
                                params.num_rounds, lane0=ds.shard_lo)
    (w,), traj = base.drive(
        "Local SGD" if local else "Mini-batch SGD", params, debug, (w,),
        base.per_round(round_fn), metrics, sampler, ds.device,
        base.chunk_rounds(debug, k, h, scan_chunk), quiet=quiet,
        start_round=start_round, capture=capture, device_loop=device_loop,
        mesh=ds.mesh)
    return w, traj
