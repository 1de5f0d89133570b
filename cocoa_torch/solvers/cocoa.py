"""CoCoA / CoCoA+ outer driver and the SDCA family's shared driver
(counterpart of cocoa_tpu/solvers/cocoa.py; reference CoCoA.scala:22-66).

One outer round: H local SDCA steps on each of the K shards (batched on
one device), the K dw summed, and the scaling law applied -- gamma for
CoCoA+ (adding) or beta/K for CoCoA (averaging), with sigma' = K*gamma;
beta/(K*H) for mini-batch CD (solvers/minibatch_cd.py).  ProxCoCoA+
(solvers/prox_cocoa.py) runs through the same driver in mode ``prox``.
"""

from __future__ import annotations

from typing import Optional

import torch

from cocoa_torch import kernels
from cocoa_torch.config import DebugParams, Params
from cocoa_torch.data.sharding import ShardedDataset
from cocoa_torch.evals import objectives
from cocoa_torch.ops.block_chain import CHAIN_MAX_B, fused_fits
from cocoa_torch.ops.dense_sdca import dense_sdca_round, \
    dense_sdca_round_plain
from cocoa_torch.ops.local_sdca import local_sdca, local_sdca_block_batched
from cocoa_torch.ops.rows import row_lengths
from cocoa_torch.ops.sparse_sdca import sparse_sdca_round, \
    sparse_sdca_round_plain
from cocoa_torch.solvers import base

# ``--blockSize=auto`` at float32: the block size the JAX package ranks
# first on a TPU v5e (cocoa_tpu/ops/pallas_chain.py BLOCK_SIZE_PREFERENCE).
# On the card (chip_smoke.py phase 6, an H100 80GB HBM3 at 700 W, three
# runs each in turns, in two calls) epsilon-like data puts fused B=128,
# split B=256 and split B=512 within 4 % of one another by their medians
# (9.505 / 9.777 / 9.924 ms a round in one call, 10.001 / 9.910 / 10.013
# in the other), the order changing between calls while single runs
# strayed to 14.7 and 20.1 ms: no size wins, and 128 stays.  The
# sparse-Gram branch on rcv1-like data is not ranked across sizes.
AUTO_BLOCK = 128


def _alg_config(params: Params, k: int, plus: Optional[bool], mode=None):
    """(mode, scaling, sigma'): CoCoA+ is ("plus", gamma, K*gamma), CoCoA
    ("cocoa", beta/K, K*gamma) (CoCoA.scala:37,45); ``params.sigma``
    overrides sigma'.  ``mode="frozen"`` is mini-batch CD: scaling
    beta/(K*H) (MinibatchCD.scala:32), and sigma' unused, since the
    frozen subproblem reads only the frozen w."""
    if mode == "frozen":
        return "frozen", params.beta / (k * params.local_iters), 1.0
    sig = k * params.gamma if params.sigma is None else float(params.sigma)
    if plus:
        return "plus", params.gamma, sig
    return "cocoa", params.beta / k, sig


def fast_round_route(layout: str, device, dtype: torch.dtype) -> str:
    """Which inner loop runs a ``--math=fast`` round (the rule that stands
    in for the TPU auto-select at cocoa_tpu/solvers/cocoa.py:540-589):
    the wrappers' own device rule, :func:`cocoa_torch.kernels.runs_plain`,
    for a dtype that a round kernel takes.

    - a CPU tensor, or a 2-byte dtype on any device: ``"plain"``, the
      vectorised PyTorch loop (the JAX auto-select keeps 2-byte dtypes
      off its kernels, ``itemsize == 4``, and runs them all the same);
    - otherwise ``"kernel"``, the CUDA sparse SDCA kernel on the sparse
      layout and the CUDA dense SDCA kernel on the dense one.

    The dtype alone decides, before any launch: the kernels themselves
    refuse 2-byte dtypes.
    """
    if layout not in ("dense", "sparse"):
        raise ValueError(f"layout must be dense or sparse, got {layout!r}")
    if kernels.runs_plain(device) or not kernels.takes_dtype(dtype):
        return "plain"
    return "kernel"


def block_route(layout: str, b: int, dtype: torch.dtype) -> str:
    """Which branch runs a ``--blockSize=b`` round (the card's rule, in
    place of the TPU's VMEM fit gates at cocoa_tpu/ops/local_sdca.py:510-521
    and pallas_chain.py ``fused_fits``):

    - sparse layout: ``"sparse_gram"``, the Gram and margins from the rows'
      slots and a sparse apply (no (K, B, d) densify), at any row width
      (ops/sparse_block.py ``gram_plan``);
    - dense layout: ``"fused"`` when the fused kernel's per-shard
      shared-memory working set (the (B, B) Gram: 64 KB at B=128 in
      float32) fits the 227 KB a block may use, else ``"split"``.

    ProxCoCoA+'s column shards take the same rule: a "row" is then a
    column of A, n entries long (dense) or its nonzeros (padded CSC).
    The route depends on shapes only: a CPU tensor, and a 2-byte dtype
    on any device, takes the same branch with the kernels' plain versions
    (``local_sdca_block_batched(plain=True)`` for the dtype)."""
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
    B=128 at any K and row width, on row and column shards alike; the
    JAX package's dependence on them came from the TPU's VMEM and SMEM
    budgets."""
    if dtype != torch.float32:
        return 0
    block_route(ds.layout, AUTO_BLOCK, dtype)
    return AUTO_BLOCK


def _sdca_round_parts(params: Params, mode: str, scaling: float,
                      sigma: float, math: str, ds: ShardedDataset,
                      block_size: int = 0):
    """The round function ``(state, idxs_kh, t) -> state`` over
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
        def round_fn(state, idxs_kh, t):
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

        plain = not kernels.takes_dtype(ds.dtype)

        def round_fn(state, idxs_kh, t):
            w, alpha = state
            da, dw = local_sdca_block_batched(
                w, alpha, shards, idxs_kh, params.lam, params.n,
                block=block_size, route=route, plain=plain, **common)
            return w + scaling * dw.sum(0), alpha + scaling * da
        return round_fn

    route = fast_round_route(ds.layout, ds.device, ds.dtype)
    if ds.layout == "sparse":
        # per-row nnz bounds the kernel's loops; once per run, not per round
        kw = dict(row_len=row_lengths(ds.sp_values)) \
            if route == "kernel" else {}
        fn = sparse_sdca_round if route == "kernel" \
            else sparse_sdca_round_plain

        def inner(w, alpha, idxs_kh):
            # a hybrid layout (--hotCols) passes its hot panel through:
            # the round then runs B1's hot-panel branch
            return fn(w, alpha, ds.sp_indices, ds.sp_values, ds.labels,
                      ds.sq_norms, idxs_kh, params.lam, params.n,
                      hot_cols=ds.hot_cols, hot_panel=ds.X_hot, **kw,
                      **common)
    else:
        fn = dense_sdca_round if route == "kernel" \
            else dense_sdca_round_plain

        def inner(w, alpha, idxs_kh):
            return fn(w, alpha, ds.X, ds.labels, ds.sq_norms, idxs_kh,
                      params.lam, params.n, **common)

    def round_fn(state, idxs_kh, t):
        w, alpha = state
        dw, a_inner = inner(w, alpha, idxs_kh)
        return (w + scaling * dw.sum(0),
                alpha + scaling * (a_inner - alpha))
    return round_fn


def run_sdca_family(ds: ShardedDataset, params: Params, debug: DebugParams,
                    alg_name: str, alg, test_ds: Optional[ShardedDataset] = None,
                    rng: str = "reference", math: str = "exact",
                    quiet: bool = False, block_size: int = 0,
                    w_init: Optional[torch.Tensor] = None,
                    alpha_init: Optional[torch.Tensor] = None,
                    eval_fn=None):
    """The SDCA family's driver: CoCoA, CoCoA+, mini-batch CD and, with
    the overrides below, ProxCoCoA+; ``alg`` is (mode, scaling, sigma')
    from :func:`_alg_config`.  Trains from ``w_init`` and ``alpha_init``
    (zeros when None); returns (w, alpha, Trajectory).  ``block_size`` > 0
    (``--blockSize``, needs ``math="fast"``) runs each round as the
    block-coordinate round (see :func:`block_route`).  ``eval_fn(state) ->
    (primal, gap or None, test_error or None)`` replaces the
    classification objectives, for a state of other meaning (ProxCoCoA+'s
    residual and coordinates)."""
    base.check_shards(ds)
    k = ds.k
    round_fn = _sdca_round_parts(params, *alg, math=math, ds=ds,
                                 block_size=block_size)
    if not quiet:
        # ds.n, not params.n: the prox family runs with n = 1
        print(f"\nRunning {alg_name} on {ds.n} data examples, "
              f"distributed over {k} workers")

    def start(init, shape):
        if init is None:
            return torch.zeros(shape, dtype=ds.dtype, device=ds.device)
        return init.to(device=ds.device, dtype=ds.dtype).clone()

    w = start(w_init, (ds.num_features,))
    alpha = start(alpha_init, (k, ds.n_shard))
    sampler = base.IndexSampler(rng, debug.seed, params.local_iters,
                                ds.counts)

    if eval_fn is None:
        def eval_fn(state):
            return objectives.evaluate(ds, state[0], state[1], params.lam,
                                       test_ds=test_ds, loss=params.loss,
                                       smoothing=params.smoothing)

    (w, alpha), traj = base.drive(
        alg_name, params, debug, (w, alpha), round_fn, eval_fn, sampler,
        ds.device, base.chunk_rounds(debug, k, params.local_iters),
        quiet=quiet)
    return w, alpha, traj


def run_cocoa(ds: ShardedDataset, params: Params, debug: DebugParams,
              plus: bool, **kw):
    """CoCoA (plus=False) or CoCoA+ (plus=True); see
    :func:`run_sdca_family` for the keyword options."""
    return run_sdca_family(ds, params, debug, "CoCoA+" if plus else "CoCoA",
                           _alg_config(params, ds.k, plus), **kw)
