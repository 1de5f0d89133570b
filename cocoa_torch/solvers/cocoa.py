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
from cocoa_torch.ops.block_chain import CHAIN_MAX_B, fused_fits
from cocoa_torch.ops.local_sdca import local_sdca, local_sdca_block_batched, \
    local_sdca_fast
from cocoa_torch.ops.rows import row_lengths, shard_margins
from cocoa_torch.ops.sparse_sdca import check_dtype, sparse_sdca_round
from cocoa_torch.solvers import base

# ``--blockSize=auto`` at float32: the block size the JAX package ranks
# first on a TPU v5e (cocoa_tpu/ops/pallas_chain.py BLOCK_SIZE_PREFERENCE).
# Not yet measured on the card; ranking block sizes there is an open
# measurement (ROADMAP).
AUTO_BLOCK = 128


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


def block_route(layout: str, b: int, dtype: torch.dtype) -> str:
    """Which branch runs a ``--blockSize=b`` round (the card's rule, in
    place of the TPU's VMEM fit gates at cocoa_tpu/ops/local_sdca.py:510-521
    and pallas_chain.py ``fused_fits``):

    - sparse layout: ``"sparse_gram"``, the Gram and margins from the rows'
      slots and a sparse apply (no (K, B, d) densify);
    - dense layout: ``"fused"`` when the fused kernel's per-shard
      shared-memory working set (the (B, B) Gram: 64 KB at B=128 in
      float32) fits the 227 KB a block may use, else ``"split"``.

    The route depends on shapes only: a CPU tensor takes the same branch
    with the kernels' plain versions.  2-byte dtypes raise."""
    check_dtype(dtype)
    if b < 1 or b > CHAIN_MAX_B:
        raise ValueError(f"--blockSize must be in 1..{CHAIN_MAX_B} on this "
                         f"port, got {b}")
    if layout == "sparse":
        return "sparse_gram"
    return "fused" if fused_fits(b, dtype.itemsize) else "split"


def auto_block_size(ds: ShardedDataset, dtype: torch.dtype) -> int:
    """``--blockSize=auto`` (counterpart of cocoa_tpu/solvers/cocoa.py
    ``auto_block_size``): float32 takes :data:`AUTO_BLOCK` on every
    layout, and any other dtype gives 0, the sequential path, as the JAX
    package gives for itemsize != 4.  Every branch of the port serves
    B=128 at any K and row width; the JAX package's dependence on them
    came from the TPU's VMEM and SMEM budgets."""
    if dtype != torch.float32:
        return 0
    block_route(ds.layout, AUTO_BLOCK, dtype)
    return AUTO_BLOCK


def _sdca_round_parts(params: Params, mode: str, scaling: float,
                      sigma: float, math: str, ds: ShardedDataset,
                      block_size: int = 0):
    """The round function ``(state, idxs_kh) -> state`` over
    ``state = (w, alpha)`` for one algorithm and math mode; ``block_size``
    > 0 runs the fast round as the block-coordinate round."""
    if math not in ("exact", "fast"):
        raise ValueError(f"math must be 'exact' or 'fast', got {math!r}")
    if block_size < 0:
        raise ValueError(f"block_size must be >= 0, got {block_size}")
    if block_size and math == "exact":
        raise ValueError("block > 0 requires math='fast' (the block kernel "
                         "is a margins-decomposition variant)")
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

    if block_size:
        route = block_route(ds.layout, block_size, ds.dtype)
        if route == "sparse_gram":
            # per-row nnz bounds the kernels' loops; once per run
            shards = {**shards, "sp_row_len": row_lengths(ds.sp_values)}

        def round_fn(state, idxs_kh):
            w, alpha = state
            da, dw = local_sdca_block_batched(
                w, alpha, shards, idxs_kh, params.lam, params.n,
                block=block_size, route=route, **common)
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
                    quiet: bool = False, block_size: int = 0):
    """Train from w = 0, alpha = 0; returns (w, alpha, Trajectory).
    ``block_size`` > 0 (``--blockSize``, needs ``math="fast"``) runs each
    round as the block-coordinate round (see :func:`block_route`)."""
    base.check_shards(ds)
    k = ds.k
    round_fn = _sdca_round_parts(params, *alg, math=math, ds=ds,
                                 block_size=block_size)
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
