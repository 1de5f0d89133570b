"""CoCoA / CoCoA+ outer driver (counterpart of cocoa_tpu/solvers/cocoa.py;
reference CoCoA.scala:22-66).

One outer round: H local SDCA steps on each of the K shards (batched on
one device), the K dw summed, and the scaling law applied -- gamma for
CoCoA+ (adding) or beta/K for CoCoA (averaging), with sigma' = K*gamma.
"""

from __future__ import annotations

from typing import Optional

import torch

from cocoa_torch.config import DebugParams, Params
from cocoa_torch.data.sharding import ShardedDataset
from cocoa_torch.evals import objectives
from cocoa_torch.ops.local_sdca import local_sdca, local_sdca_fast
from cocoa_torch.ops.rows import shard_margins
from cocoa_torch.ops.sparse_sdca import check_dtype, row_lengths, \
    sparse_sdca_round
from cocoa_torch.solvers import base


def _alg_config(params: Params, k: int, plus: bool):
    """(mode, scaling, sigma'): CoCoA+ is ("plus", gamma, K*gamma), CoCoA
    ("cocoa", beta/K, K*gamma) (CoCoA.scala:37,45); ``params.sigma``
    overrides sigma'."""
    sig = k * params.gamma if params.sigma is None else float(params.sigma)
    if plus:
        return "plus", params.gamma, sig
    return "cocoa", params.beta / k, sig


def fast_round_route(layout: str, device, dtype: torch.dtype) -> str:
    """Which inner loop runs a ``--math=fast`` round (the rule that stands
    in for the TPU auto-select at cocoa_tpu/solvers/cocoa.py:540-589):

    - a CPU tensor: ``"plain"``, the vectorised PyTorch loop;
    - sparse layout on CUDA: ``"kernel"``, the CUDA sparse SDCA kernel;
    - dense layout on CUDA: not ported yet (ROADMAP Queue B2), raises.

    2-byte dtypes raise on every device, as the TPU kernels refuse them.
    """
    check_dtype(dtype)
    if torch.device(device).type == "cpu":
        return "plain"
    if layout == "sparse":
        return "kernel"
    raise NotImplementedError(
        "--math=fast on the dense layout needs the dense SDCA kernel "
        "(pallas_sdca_round, ROADMAP Queue B2), which is not ported to "
        "CUDA yet; use --layout=sparse or --math=exact")


def _sdca_round_parts(params: Params, mode: str, scaling: float,
                      sigma: float, math: str, ds: ShardedDataset):
    """The round function ``(state, idxs_kh) -> state`` over
    ``state = (w, alpha)`` for one algorithm and math mode."""
    if math not in ("exact", "fast"):
        raise ValueError(f"math must be 'exact' or 'fast', got {math!r}")
    shards = ds.shard_arrays()
    common = dict(mode=mode, sigma=sigma, loss=params.loss,
                  smoothing=params.smoothing)

    if math == "exact":
        def round_fn(state, idxs_kh):
            w, alpha = state
            da, dw = local_sdca(w, alpha, shards, idxs_kh, params.lam,
                                params.n, **common)
            # CoCoA.scala:47-48,101
            return w + scaling * dw.sum(0), alpha + scaling * da
        return round_fn

    route = fast_round_route(ds.layout, ds.device, ds.dtype)
    if ds.layout == "sparse":
        # per-row nnz bounds the kernel's loops; once per run, not per round
        row_len = row_lengths(ds.sp_values) if route == "kernel" else None

        def inner(w, alpha, idxs_kh):
            return sparse_sdca_round(
                w, alpha, ds.sp_indices, ds.sp_values, ds.labels,
                ds.sq_norms, idxs_kh, params.lam, params.n, row_len=row_len,
                **common)
    else:
        def inner(w, alpha, idxs_kh):
            dw0 = torch.zeros(ds.k, w.shape[0], dtype=w.dtype,
                              device=w.device)
            da, dw = local_sdca_fast(shard_margins(w, shards), alpha, shards,
                                     idxs_kh, params.lam, params.n, dw0,
                                     **common)
            return dw, alpha + da

    def round_fn(state, idxs_kh):
        w, alpha = state
        dw, a_inner = inner(w, alpha, idxs_kh)
        return (w + scaling * dw.sum(0),
                alpha + scaling * (a_inner - alpha))
    return round_fn


def run_sdca_family(ds: ShardedDataset, params: Params, debug: DebugParams,
                    alg_name: str, alg, test_ds: Optional[ShardedDataset] = None,
                    rng: str = "reference", math: str = "exact",
                    quiet: bool = False):
    """Train from w = 0, alpha = 0; returns (w, alpha, Trajectory)."""
    base.check_shards(ds)
    k = ds.k
    round_fn = _sdca_round_parts(params, *alg, math=math, ds=ds)
    if not quiet:
        print(f"\nRunning {alg_name} on {ds.n} data examples, "
              f"distributed over {k} workers")
    w = torch.zeros(ds.num_features, dtype=ds.dtype, device=ds.device)
    alpha = torch.zeros(k, ds.n_shard, dtype=ds.dtype, device=ds.device)
    sampler = base.IndexSampler(rng, debug.seed, params.local_iters,
                                ds.counts)

    def eval_fn(state):
        return objectives.evaluate(ds, state[0], state[1], params.lam,
                                   test_ds=test_ds, loss=params.loss,
                                   smoothing=params.smoothing)

    # a chunk ends at each eval; capped so one chunk's (C, K, H) table
    # stays modest when debugIter is large
    cap = max(1, 32_000_000 // max(1, k * params.local_iters))
    chunk = min(debug.debug_iter if debug.debug_iter > 0 else 50, cap)
    (w, alpha), traj = base.drive(alg_name, params, debug, (w, alpha),
                                  round_fn, eval_fn, sampler, ds.device,
                                  chunk, quiet=quiet)
    return w, alpha, traj


def run_cocoa(ds: ShardedDataset, params: Params, debug: DebugParams,
              plus: bool, **kw):
    """CoCoA (plus=False) or CoCoA+ (plus=True); see
    :func:`run_sdca_family` for the keyword options."""
    return run_sdca_family(ds, params, debug, "CoCoA+" if plus else "CoCoA",
                           _alg_config(params, ds.k, plus), **kw)
