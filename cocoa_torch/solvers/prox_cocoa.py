"""ProxCoCoA+, L1-regularised regression (lasso and elastic net), the
counterpart of cocoa_tpu/solvers/prox_cocoa.py.

    min_x  0.5*|Ax - b|^2 + lam*|x|_1 (+ l2/2*|x|^2, elastic net)

A's columns are sharded (data/columns.py): worker k owns x_[k] and A_[k];
the replicated state is the residual r = Ax - b, the analogue of w, and
x the analogue of alpha.  A round runs H prox coordinate steps per shard
against the frozen r0 with sigma'-scaled reads of the shard's
dv = A_[k].dx_[k] (CoCoA+'s subproblem, mode ``prox`` with the ``lasso``
rule), then r += gamma*sum dv: the SDCA family's driver, so the sequential
kernels (dense and sparse) run it on the card, and with ``block_size``
the block round's kernels (fused or split on dense columns, the sparse
Gram on padded-CSC ones).

The certificate is exact in both cases:
- lasso (l2 = 0): gap = P(x) - D(s*r), with the dual-feasible scaling
  s = min(1, lam/|A^T r|_inf) and D(u) = -0.5*|u|^2 - u.b;
- elastic net (l2 > 0): the l2 term smooths the conjugate of the
  penalty, h*(s) = ([|s| - lam]_+)^2/(2*l2), so r itself is feasible and
  gap = P(x) - D(r), D(u) = -0.5*|u|^2 - u.b - sum_j ([|a_j.u| - lam]_+)^2
  /(2*l2).
Weak duality makes the gap >= 0 at every iterate.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cocoa_torch.config import DebugParams, Params
from cocoa_torch.data.sharding import ShardedDataset
from cocoa_torch.ops.rows import shard_margins
from cocoa_torch.parallel.fanout import all_reduce_max, all_reduce_sum
from cocoa_torch.solvers.cocoa import run_sdca_family


def lasso_metrics(r, x, shards: dict, b, l1: float,
                  l2: float, mesh=None) -> torch.Tensor:
    """(primal, gap, NaN) of the elastic-net objective as one (3,) tensor
    on r's device, with no host sync: the eval of the chunked loop (one
    fetch) and of the device loop (inside its captured chunk).  In a gang
    (``mesh``) the column shards' sums cross the ranks in one
    all-reduce, and the lasso's max |a_j.r| in one more (a maximum);
    r.r and r.b are of the replicated residual, this rank's own."""
    m = shards["mask"]
    corr = shard_margins(r, shards).abs() * m
    excess = torch.clamp(corr - l1, min=0.0)
    rr = r @ r
    sums = [(x.abs() * m).sum(), (x * x * m).sum()]
    if l2 != 0.0:
        sums.append((excess * excess).sum())
    if mesh is not None:
        sums = list(all_reduce_sum(torch.stack(sums), mesh))
    primal = 0.5 * rr + l1 * sums[0] + 0.5 * l2 * sums[1]
    if l2 == 0.0:
        corr_max = all_reduce_max(corr.max(), mesh)
        s = torch.clamp(l1 / torch.clamp(corr_max, min=1e-30), max=1.0)
        u = s * r
        dual = -0.5 * (u @ u) - u @ b
    else:
        dual = -0.5 * rr - r @ b - sums[2] / (2.0 * l2)
    return torch.stack([primal, primal - dual,
                        torch.full_like(primal, float("nan"))])


def run_prox_cocoa(ds: ShardedDataset, b: torch.Tensor, params: Params,
                   debug: DebugParams, rng: str = "reference",
                   x_init=None, r_init=None, start_round: int = 1,
                   quiet: bool = False, math: str = "fast",
                   block_size: int = 0,
                   block_pipeline: Optional[bool] = None,
                   gap_target: Optional[float] = None,
                   divergence_guard: str = "auto",
                   scan_chunk: Optional[int] = None, sampling: str = "auto",
                   capture: Optional[bool] = None, device_loop: bool = False):
    """Train; returns (x (K, d_shard) the sharded coordinates, r = Ax - b
    the residual, Trajectory).  ``ds`` and ``b`` come from
    :func:`cocoa_torch.data.columns.shard_columns`; ``params.lam`` is the
    L1 weight, ``params.smoothing`` the elastic-net l2 weight (0: lasso),
    ``params.gamma`` the aggregation (sigma' = K*gamma) and
    ``params.local_iters`` the coordinate steps per round.  The run
    starts from x = 0, r = -b unless ``x_init``/``r_init`` (tensors or
    arrays, as a checkpoint holds them) are given, at round
    ``start_round``.
    ``block_size`` > 0 (``--blockSize``, needs ``math="fast"``) runs each
    round as the block-coordinate round on the column shards, with the
    lasso rule in the block kernels (solvers/cocoa.py ``block_route``),
    its column tiles pipelined per ``block_pipeline`` (as in
    ``run_sdca_family``).
    ``gap_target`` stops at the first eval whose (absolute) gap is at or
    below it; ``divergence_guard`` as in ``run_sdca_family`` (``auto``
    does not arm at the safe sigma' = K*gamma); ``scan_chunk``,
    ``sampling``, ``capture`` and ``device_loop`` as there too.  Each
    eval fetches (primal, gap) from the device once; the device loop
    fetches a super-block's evals at once."""
    l1, l2 = float(params.lam), float(params.smoothing)
    # mode prox has no lam*n factor: n = 1 makes lam_n the L1 weight
    parts = dataclasses.replace(params, n=1, loss="lasso")
    alg = ("prox", params.gamma, ds.k * params.gamma)
    b = b.to(device=ds.device, dtype=ds.dtype)
    shards = ds.shard_arrays()

    def metrics(state):
        return lasso_metrics(state[0], state[1], shards, b, l1, l2,
                             ds.mesh)

    r, x, traj = run_sdca_family(
        ds, parts, debug, "ProxCoCoA+", alg, rng=rng, math=math, quiet=quiet,
        block_size=block_size, block_pipeline=block_pipeline,
        w_init=-b if r_init is None else r_init,
        alpha_init=x_init, start_round=start_round, metrics=metrics,
        gap_target=gap_target, divergence_guard=divergence_guard,
        scan_chunk=scan_chunk,
        sampling=sampling, capture=capture, device_loop=device_loop)
    return x, r, traj
