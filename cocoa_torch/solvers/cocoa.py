"""CoCoA / CoCoA+ outer driver and the SDCA family's shared driver
(counterpart of cocoa_tpu/solvers/cocoa.py; reference CoCoA.scala:22-66).

One outer round: H local SDCA steps on each of the K shards (batched on
one device), the K dw summed, and the scaling law applied -- gamma for
CoCoA+ (adding) or beta/K for CoCoA (averaging), with sigma' = K*gamma;
beta/(K*H) for mini-batch CD (solvers/minibatch_cd.py).  ProxCoCoA+
(solvers/prox_cocoa.py) runs through the same driver in mode ``prox``.

A gap-targeted run can carry the JAX package's schedule (``--sigma=auto``,
``--sigmaSchedule``, ``--warmStart``) and accelerated outer loop
(``--accel``, ``--theta``): the branch a chunk of rounds runs (sigma'
stage x loss phase x Theta stage) is the same round function with other
scalars, picked on the host from the sched vector (solvers/base.py
``Schedule``), where JAX's ``lax.switch`` picks it on the device; with
``--deviceLoop`` the device picks it, one captured CUDA graph a branch
(solvers/base.py ``DeviceLoopRunner``).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

import numpy as np
import torch

from cocoa_torch import kernels
from cocoa_torch.config import DebugParams, Params
from cocoa_torch.data.sharding import ShardedDataset
from cocoa_torch.evals import objectives
from cocoa_torch.telemetry.events import get_bus
from cocoa_torch.ops.block_chain import CHAIN_MAX_B, fused_fits
from cocoa_torch.ops.dense_sdca import dense_sdca_round, \
    dense_sdca_round_plain
from cocoa_torch.ops.local_sdca import local_sdca, \
    local_sdca_block_batched, local_sdca_fast
from cocoa_torch.ops.rows import nonzero_slots, row_lengths, shards_axpy
from cocoa_torch.ops.sparse_sdca import sparse_sdca_round, \
    sparse_sdca_round_plain
from cocoa_torch.parallel.fanout import all_reduce_sum, fp_reducer, fp_sum
from cocoa_torch.parallel.mesh import has_fp
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


def fast_round_route(layout: str, device, dtype: torch.dtype,
                     fp: bool = False) -> str:
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
    refuse 2-byte dtypes.  A feature-parallel gang (``fp``) takes
    ``"plain"`` on every device, the fast-math loop with each step's x.dw
    summed over the fp peers, as the JAX package keeps its Pallas kernels
    off an fp mesh (cocoa_tpu/solvers/cocoa.py:576-586): B1 and B2 read
    a whole row against a whole w.  This is the fp route itself, not a
    fallback from a kernel.
    """
    if layout not in ("dense", "sparse"):
        raise ValueError(f"layout must be dense or sparse, got {layout!r}")
    if fp or kernels.runs_plain(device) or not kernels.takes_dtype(dtype):
        return "plain"
    return "kernel"


def block_route(layout: str, b: int, dtype: torch.dtype,
                fp: bool = False) -> str:
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
    (``local_sdca_block_batched(plain=True)`` for the dtype).

    A feature-parallel gang (``fp``, dense only) takes ``"split"``: each
    rank forms the partial Gram and margin base from its columns, one fp
    all-reduce a block sums them, the chain runs on B3, and each rank
    applies coef . X_B to its columns; the fused kernel forms the Gram
    from whole rows and is never taken.  A failure of B3 raises."""
    if b < 1 or b > CHAIN_MAX_B:
        raise ValueError(f"--blockSize must be in 1..{CHAIN_MAX_B} on this "
                         f"port, got {b}")
    if fp:
        return "split"
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
                      block_size: int = 0,
                      block_pipeline: Optional[bool] = None):
    """The round function ``(state, idxs_kh, t) -> state`` over
    ``state = (w, alpha)`` for one algorithm and math mode; ``block_size``
    > 0 runs the fast round as the block-coordinate round, its row tiles
    pipelined per ``block_pipeline`` (ops/local_sdca.py
    ``local_sdca_block_batched``'s ``pipeline``)."""
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
    mesh = ds.mesh
    fp = has_fp(mesh)
    fp_kw = dict(fp_sum=fp_reducer(mesh)) if fp else {}

    def reduce(dw):
        # the local shards' sum in the device, then the gang's one
        # all-reduce of the round (a no-op in one process)
        return all_reduce_sum(dw.sum(0), mesh)

    if math == "exact":
        def round_fn(state, idxs_kh, t):
            w, alpha = state
            da, dw = local_sdca(w, alpha, shards, idxs_kh, params.lam,
                                params.n, **common, **fp_kw)
            # CoCoA.scala:47-48,101
            return w + scaling * reduce(dw), alpha + scaling * da
        return round_fn

    if block_size:
        route = block_route(ds.layout, block_size, ds.dtype, fp)
        if route == "sparse_gram":
            # per-row nnz bounds the kernels' loops; once per run
            shards = {**shards, "sp_row_len": row_lengths(ds.sp_values)}

        plain = not kernels.takes_dtype(ds.dtype)

        def round_fn(state, idxs_kh, t):
            w, alpha = state
            da, dw = local_sdca_block_batched(
                w, alpha, shards, idxs_kh, params.lam, params.n,
                block=block_size, route=route, plain=plain,
                pipeline=block_pipeline, **common, **fp_kw)
            return w + scaling * reduce(dw), alpha + scaling * da
        return round_fn

    route = fast_round_route(ds.layout, ds.device, ds.dtype, fp)
    if fp:
        def inner(w, alpha, idxs_kh):
            # the whole rows' margins X.w0 once a round, then the
            # fast-math loop with each step's x.dw summed over the peers
            dw = torch.zeros(alpha.shape[0], w.shape[0], dtype=w.dtype,
                             device=w.device)
            da, dw = local_sdca_fast(
                fp_sum(ds.X @ w, mesh), alpha, shards, idxs_kh, params.lam,
                params.n, dw, **common, **fp_kw)
            return dw, alpha + da
    elif ds.layout == "sparse":
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
        return (w + scaling * reduce(dw),
                alpha + scaling * (a_inner - alpha))
    return round_fn


def _secant_jump(w, alpha, hist, shards: dict, inv_lam_n: float,
                 slots=None, mesh=None):
    """The accelerated loop's secant (Anderson-1) jump, as device ops with
    no host read (cocoa_tpu/solvers/cocoa.py:781-803): rho from the two
    banked window displacements, c = secant_coef(rho), the extrapolated
    alpha clipped to [0, 1] and masked, and w advanced by the exact
    correspondence update sum y*(alpha' - alpha)*x/(lam*n).  ``inv_lam_n``
    is 1/(lam*n) rounded to float32, as JAX applies it; ``slots`` the
    shards' nonzero slots (:func:`nonzero_slots`).  In a gang (``mesh``)
    the two dot products over alpha and the axpy's sum over the shards
    each cross the ranks, one all-reduce apiece."""
    d1 = (hist[1] - hist[0]).reshape(-1)
    den = d1 @ d1
    num = d1 @ (alpha - hist[1]).reshape(-1)
    if mesh is not None:
        den, num = all_reduce_sum(torch.stack([den, num]), mesh)
    pos = den > 0
    rho = torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)),
                      torch.zeros_like(den))
    c = base.secant_coef(torch, rho)
    a_ext = torch.clamp(alpha + c * (alpha - hist[1]), 0.0, 1.0) \
        * shards["mask"]
    coefs = shards["labels"] * (a_ext - alpha) * inv_lam_n
    if mesh is None:
        return shards_axpy(coefs, shards, w, slots), a_ext
    step = shards_axpy(coefs, shards, torch.zeros_like(w), slots)
    return w + all_reduce_sum(step, mesh), a_ext


def run_sdca_family(ds: ShardedDataset, params: Params, debug: DebugParams,
                    alg_name: str, alg, test_ds: Optional[ShardedDataset] = None,
                    rng: str = "reference", math: str = "exact",
                    quiet: bool = False, block_size: int = 0,
                    block_pipeline: Optional[bool] = None,
                    w_init=None, alpha_init=None, start_round: int = 1,
                    sched_init=None, hist_init=None, metrics=None,
                    gap_target: Optional[float] = None,
                    divergence_guard: str = "auto", sigma_levels=None,
                    warm_start=None, accel: bool = False,
                    theta: str = "fixed", scan_chunk: Optional[int] = None,
                    sampling: str = "auto", capture: Optional[bool] = None,
                    device_loop: bool = False, overlap_io: bool = False):
    """The SDCA family's driver: CoCoA, CoCoA+, mini-batch CD and, with
    the overrides below, ProxCoCoA+; ``alg`` is (mode, scaling, sigma')
    from :func:`_alg_config`.  Trains from ``w_init`` and ``alpha_init``
    (tensors or arrays; zeros when None) from round ``start_round``;
    a resumed scheduled or accelerated run also restores its sched vector
    (``sched_init``) and accel bank (``hist_init``), as a checkpoint
    carries them (cocoa_torch/checkpoint.py).  Returns (w, alpha,
    Trajectory).  ``block_size`` > 0
    (``--blockSize``, needs ``math="fast"``) runs each round as the
    block-coordinate round (see :func:`block_route`); ``block_pipeline``
    (``--blockPipeline``: None auto, True on, False off) gathers the next
    block's row tile while a block's kernel runs, on the fused and split
    routes.  ``metrics(state) ->
    (3,)`` (primal, gap, test error, NaN where there is none, on the
    device with no host read) replaces the classification objectives, for
    a state of other meaning (ProxCoCoA+'s residual and coordinates).

    ``gap_target`` stops the run at the first eval whose gap is at or
    below it; ``divergence_guard`` (auto | on | off,
    :func:`base.resolve_divergence_guard`) arms the stall watch's
    bail-out.  ``sigma_levels`` (the sigma' ladder,
    :func:`base.anneal_levels`) and ``warm_start`` = (s, warm_end), a
    smooth_hinge(s) phase for rounds <= warm_end (a ``debugIter``
    multiple), carry the sched vector in the state; ``accel`` adds the
    secant jump's window bank, and ``theta="adaptive"`` the Theta ladder
    (cocoa_tpu/solvers/cocoa.py ``run_sdca_family``).

    ``scan_chunk`` rounds run as one chunk (:func:`base.chunk_rounds`;
    None: the JAX CLI's default), on CUDA one replayed CUDA graph a chunk
    unless ``capture`` is False; ``sampling`` (auto | device | host,
    :func:`base.resolve_sampling`) says where the chunk's tables are
    made.  ``device_loop`` (``--deviceLoop``) runs the evals, the stop
    test and the ladder on the device too (:func:`base.drive_device`):
    the branch index from the device's sched vector, the secant jump
    taken on the device at the chunk's head; with ``overlap_io``
    (``--overlapComm``, resolved by the CLI for a single process) it
    writes its checkpoints on a thread, the files those of a synchronous
    save."""
    base.check_shards(ds)
    guard_on = base.resolve_divergence_guard(
        divergence_guard, alg[0], alg[2], ds.k, params.gamma)
    k = ds.k
    if not quiet:
        # ds.n, not params.n: the prox family runs with n = 1
        print(f"\nRunning {alg_name} on {ds.n} data examples, "
              f"distributed over {k} workers")
    if gap_target is not None and ds.dtype == torch.bfloat16:
        raise ValueError(
            "gap-targeted runs cannot certify in bfloat16 (the duality "
            "gap is below bf16 resolution — docs/DESIGN.md §6); use "
            "--dtype=float32, or drop --gapTarget for an uncertified "
            "bf16 run"
        )
    if theta not in ("fixed", "adaptive"):
        raise ValueError(f"theta must be fixed|adaptive, got {theta!r}")
    if accel:
        if debug.debug_iter <= 0:
            raise ValueError(
                "--accel requires --debugIter > 0 (the momentum restart "
                "rule rides the eval cadence)")
        if theta == "adaptive" and gap_target is None:
            raise ValueError(
                "--theta=adaptive requires --gapTarget (the Θ ladder's "
                "final full-accuracy stage is keyed to the target)")
    levels = (tuple(float(v) for v in sigma_levels)
              if sigma_levels is not None else (float(alg[2]),))
    branch_params = [params]
    warm_end = 0
    if warm_start is not None:
        warm_s, warm_end = warm_start
        if debug.debug_iter <= 0:
            raise ValueError(
                "warm_start needs debug_iter > 0 (the loss handoff "
                "lands on the eval-cadence chunk boundary)")
        if warm_end % debug.debug_iter != 0:
            raise ValueError(
                f"warm_start rounds ({warm_end}) must be a multiple "
                f"of debugIter ({debug.debug_iter}) — the CLI "
                f"rounds up for you")
        branch_params = [dataclasses.replace(params, loss="smooth_hinge",
                                             smoothing=float(warm_s)),
                         params]
    full_h = params.local_iters
    theta_hs = base.theta_ladder(full_h, accel and theta == "adaptive")
    if len(theta_hs) > 1 and (block_size > 0 or (
            math == "fast"
            and fast_round_route(ds.layout, ds.device, ds.dtype,
                                 has_fp(ds.mesh)) == "kernel")):
        raise ValueError(
            "--theta=adaptive slices the sequential (C, K, H) "
            "index tables and is not available on the Pallas/"
            "--blockSize paths (their kernels and the "
            "block-distinct sampling license are keyed to the "
            "full H); drop --theta=adaptive or the block flags")
    # one round function a branch: sigma' stage x loss phase
    branches = [[_sdca_round_parts(bp, alg[0], alg[1], lv, math=math, ds=ds,
                                   block_size=block_size,
                                   block_pipeline=block_pipeline)
                 for bp in branch_params] for lv in levels]

    w = (torch.zeros(ds.w_len, dtype=ds.dtype, device=ds.device)
         if w_init is None else base.restore_w(w_init, ds))
    alpha = (torch.zeros((ds.m, ds.n_shard), dtype=ds.dtype, device=ds.device)
             if alpha_init is None else base.align_alpha(alpha_init, ds))
    sampler = base.make_sampler(rng, debug.seed, params.local_iters,
                                ds.counts, sampling, params.num_rounds,
                                lane0=ds.shard_lo)

    if metrics is None:
        shards = ds.shard_arrays()
        test = None if test_ds is None else test_ds.shard_arrays()

        def metrics(state):
            # state[0:2]: the scheduled state appends its own leaves
            return objectives.eval_metrics(
                state[0], state[1], shards, params.lam, ds.n,
                test_shard_arrays=test,
                test_n=0 if test_ds is None else test_ds.n,
                loss=params.loss, smoothing=params.smoothing,
                mesh=ds.mesh)

    state = (w, alpha)
    schedule = None
    if not (len(levels) > 1 or warm_start is not None or accel):
        body = base.per_round(branches[0][0])
    else:
        jump = None
        if accel:
            shards = ds.shard_arrays()
            inv_lam_n = float(np.float32(1.0 / (params.lam * params.n)))
            slots = nonzero_slots(shards)

            def jump(w, alpha, hist):
                return _secant_jump(w, alpha, hist, shards, inv_lam_n,
                                    slots, ds.mesh)

        schedule = base.Schedule(len(levels), warm_end, len(branch_params),
                                 theta_hs, jump=jump)

        def body(key, c, tables, t0, iterate):
            stage, phase, hs = key
            if hs < full_h:
                tables = tables[:, :, :hs].contiguous()
            step = branches[stage][phase]
            for idxs_kh in tables:
                iterate = step(iterate, idxs_kh, None)
            return iterate

        if accel:
            state += (torch.zeros((2,) + alpha.shape, dtype=ds.dtype,
                                  device=ds.device) if hist_init is None
                      else torch.stack([base.align_alpha(h, ds)
                                        for h in hist_init]),)
        state += (base.sched_init_array(start_round, sched_init,
                                        accel=accel),)

    state, traj = base.drive(
        alg_name, params, debug, state, body, metrics, sampler, ds.device,
        base.chunk_rounds(debug, k, params.local_iters, scan_chunk),
        quiet=quiet, start_round=start_round, gap_target=gap_target,
        divergence_guard=guard_on, sigma_levels=levels,
        accel=base.AccelConfig(theta_hs) if accel else None,
        schedule=schedule, n_iterate=2, capture=capture,
        device_loop=device_loop, mesh=ds.mesh, overlap_io=overlap_io)
    return state[0], state[1], traj


def run_cocoa(ds: ShardedDataset, params: Params, debug: DebugParams,
              plus: bool, sigma_schedule: Optional[str] = None,
              warm_start=None, accel: Optional[str] = None,
              theta: Optional[str] = None, **kw):
    """CoCoA (plus=False) or CoCoA+ (plus=True); see
    :func:`run_sdca_family` for the keyword options.  The sigma' front end
    of cocoa_tpu/solvers/cocoa.py ``run_cocoa``:

    - ``params.sigma="auto"``: plain CoCoA runs the default sigma'; CoCoA+
      anneals from K*gamma/2 to K*gamma (``sigma_schedule`` None or
      "anneal"), or with "trial" runs a guarded trial at K*gamma/2 and,
      if it diverges, restarts from scratch at K*gamma;
    - an explicit sigma' below K*gamma with "anneal" anneals from it;
    - ``warm_start=(s, rounds)``: a smooth_hinge(s) phase for the first
      ``rounds`` rounds, rounded up to the ``debugIter`` cadence;
    - ``accel`` auto | on | off (default off): auto turns the accelerated
      loop on for gap-targeted CoCoA+; ``theta`` fixed | adaptive needs
      an accelerated run, and falls back to fixed where auto resolved
      off."""
    if sigma_schedule not in (None, "trial", "anneal"):
        raise ValueError(f"sigma schedule must be trial|anneal, got "
                         f"{sigma_schedule!r}")
    accel = "off" if accel is None else str(accel).lower()
    if accel not in ("auto", "on", "off"):
        raise ValueError(f"accel must be auto|on|off, got {accel!r}")
    theta = "fixed" if theta is None else str(theta).lower()
    if theta not in ("fixed", "adaptive"):
        raise ValueError(f"theta must be fixed|adaptive, got {theta!r}")
    if sigma_schedule == "trial":
        # the trial is the bit-exact A/B control: no acceleration on it
        if accel == "on":
            raise ValueError(
                "--accel cannot ride --sigmaSchedule=trial (the trial is "
                "the bit-exact A/B control); use --sigmaSchedule=anneal")
        accel = "off"
    accel_on = (accel == "on"
                or (accel == "auto" and plus
                    and kw.get("gap_target") is not None))
    if theta == "adaptive" and not accel_on:
        if accel == "off":
            raise ValueError(
                "--theta=adaptive requires an accelerated run: pass "
                "--accel=on, or --accel=auto with --gapTarget on CoCoA+")
        theta = "fixed"
    accel_kw = dict(accel="on" if accel_on else "off", theta=theta)
    if warm_start is not None:
        s_w, r_w = warm_start
        if params.loss != "hinge":
            raise ValueError(
                "--warmStart hands a smooth_hinge phase off to hinge and "
                "requires --loss=hinge")
        if not float(s_w) > 0:
            raise ValueError(
                f"--warmStart smoothing must be > 0, got {s_w}")
        if int(r_w) < 1:
            raise ValueError(
                f"--warmStart rounds must be >= 1, got {r_w}")
        if debug.debug_iter <= 0:
            raise ValueError(
                "--warmStart requires --debugIter > 0 (the in-loop "
                "handoff lands on the eval-cadence chunk boundary)")
        r_al = -(-int(r_w) // debug.debug_iter) * debug.debug_iter
        if r_al != int(r_w) and not kw.get("quiet", False):
            print(f"warmStart: handoff rounded up to round {r_al} "
                  f"(the debugIter={debug.debug_iter} cadence the device "
                  f"loop chunks on)")
        warm_start = (float(s_w), r_al)

    safe = ds.k * params.gamma
    if params.sigma == "auto":
        if not plus:
            # sigma' enters only the plus-mode subproblem: plain CoCoA
            # runs the default (the CLI runs both from one flag set)
            return run_cocoa(ds, dataclasses.replace(params, sigma=None),
                             debug, plus, warm_start=warm_start, **accel_kw,
                             **kw)
        if (sigma_schedule or "anneal") == "anneal":
            return _run_cocoa_anneal(
                ds, params, debug, plus, base.anneal_levels(safe / 2.0, safe),
                warm_start, accel_kw, kw)
        if kw.get("gap_target") is None:
            raise ValueError("--sigma=auto requires --gapTarget (the "
                             "σ′ fallback triggers on the divergence "
                             "guard, which runs on the gap-target path)")
        if kw.get("divergence_guard", "auto") == "off":
            raise ValueError("--sigma=auto requires the divergence guard "
                             "(drop --divergenceGuard=off)")
        quiet = kw.get("quiet", False)
        if kw.get("w_init") is not None or kw.get("start_round", 1) > 1:
            # a resumed run does not re-experiment: its state may be
            # mid-trial
            if not quiet:
                print("sigma=auto: resumed run continues with the safe "
                      f"σ′=K·γ={safe:g} (no re-trial from restored state)")
            return run_cocoa(ds, dataclasses.replace(params, sigma=None),
                             debug, plus, warm_start=warm_start, **accel_kw,
                             **kw)
        ckpt_dir = debug.chkpt_dir if debug.chkpt_iter > 0 else ""
        before = (set(os.listdir(ckpt_dir))
                  if ckpt_dir and os.path.isdir(ckpt_dir) else set())
        trial = dataclasses.replace(params, sigma=safe / 2.0)
        w, alpha, traj = run_cocoa(ds, trial, debug, plus,
                                   warm_start=warm_start, **kw)
        if traj.stopped != "diverged":
            return w, alpha, traj
        if ckpt_dir and os.path.isdir(ckpt_dir):
            _drop_trial_checkpoints(ckpt_dir, before, plus, traj)
        get_bus().emit(
            "restart", reason="sigma_trial_diverged",
            algorithm="CoCoA+" if plus else "CoCoA",
            sigma_trial=trial.sigma, sigma_safe=safe,
            round=traj.records[-1].round if traj.records else 0)
        if not quiet:
            print(f"sigma=auto: σ′=K·γ/2={trial.sigma:g} diverged; "
                  f"restarting with the safe σ′=K·γ={safe:g}")
        # from scratch: the safe run inherits nothing of the trial's
        safe_kw = {k2: v for k2, v in kw.items()
                   if k2 not in ("w_init", "alpha_init", "start_round",
                                 "sched_init", "hist_init")}
        return run_cocoa(ds, dataclasses.replace(params, sigma=None), debug,
                         plus, warm_start=warm_start, **accel_kw, **safe_kw)

    if sigma_schedule == "trial":
        raise ValueError(
            "sigma schedule 'trial' is the --sigma=auto A/B control; it "
            "needs --sigma=auto")
    if (sigma_schedule == "anneal" and plus and params.sigma is not None
            and float(params.sigma) < safe):
        return _run_cocoa_anneal(
            ds, params, debug, plus,
            base.anneal_levels(float(params.sigma), safe), warm_start,
            accel_kw, kw)
    return run_sdca_family(ds, params, debug, "CoCoA+" if plus else "CoCoA",
                           _alg_config(params, ds.k, plus),
                           warm_start=warm_start, accel=accel_on, theta=theta,
                           **kw)


def _drop_trial_checkpoints(ckpt_dir: str, before: set, plus: bool,
                            traj) -> None:
    """Delete a diverged sigma' trial's checkpoints before the safe rerun
    (cocoa_tpu/solvers/cocoa.py:1140-1160), so a later ``--resume``
    cannot pick its state: only files new since the trial began, with
    this algorithm's exact stamp and a round the trial reached."""
    algo = ("CoCoA+" if plus else "CoCoA").replace(" ", "_")
    last = traj.records[-1].round if traj.records else 0
    stamp = re.compile(re.escape(algo) + r"-r(\d+)\.(npz|npz\.json|json)$")
    for f in sorted(set(os.listdir(ckpt_dir)) - before):
        m = stamp.match(f)
        if m and int(m.group(1)) <= last:
            os.remove(os.path.join(ckpt_dir, f))


def _run_cocoa_anneal(ds, params, debug, plus, levels, warm_start, accel_kw,
                      kw):
    """The sigma' anneal entry (cocoa_tpu/solvers/cocoa.py
    ``_run_cocoa_anneal``): validate, and hand the ladder to
    :func:`run_sdca_family`."""
    if kw.get("gap_target") is None:
        raise ValueError(
            "the σ′ anneal schedule requires --gapTarget (the backoff "
            "triggers on the stall watch, which runs on the gap-target "
            "path)")
    if kw.get("divergence_guard", "auto") == "off":
        raise ValueError(
            "the σ′ anneal schedule IS the divergence guard's backoff "
            "action; drop --divergenceGuard=off")
    resumed = kw.get("w_init") is not None or kw.get("start_round", 1) > 1
    if resumed and kw.get("sched_init") is None:
        # resumed without the schedule's state: the iterate may sit
        # mid-stage at an unknown sigma'
        if not kw.get("quiet", False):
            print("sigma anneal: resumed run has no schedule state; "
                  f"continuing with the safe σ′=K·γ={ds.k * params.gamma:g}")
        return run_cocoa(ds, dataclasses.replace(params, sigma=None), debug,
                         plus, warm_start=warm_start, **accel_kw, **kw)
    p = dataclasses.replace(params, sigma=levels[0])
    return run_sdca_family(
        ds, p, debug, "CoCoA+" if plus else "CoCoA",
        _alg_config(p, ds.k, plus), sigma_levels=levels,
        warm_start=warm_start, accel=accel_kw["accel"] == "on",
        theta=accel_kw["theta"], **kw)


# --- bounded-staleness CoCoA+ aggregation (--staleRounds) -------------------
#
# The counterpart of cocoa_tpu/solvers/cocoa.py:1200-1390.  The
# synchronous round pays the slowest worker's time at every barrier.
# Bounded staleness relaxes the barrier, not the math: a worker may start
# round t+1 with its peers' contributions of rounds (t-S, t] still
# outstanding, as long as every round-r contribution is applied before
# round r+S+1's local solve.
#
# Safety (Ma et al., arXiv:1502.03508): every local subproblem is solved
# against sigma' = K*gamma, the bound under which all K contributions may
# be added at once; a subset of m <= K of them at the same gamma lies
# inside that region, and a late contribution joining alone is m = 1.
# The scale is gamma for every contribution, whenever it joins: its owner
# advanced alpha by gamma*dalpha at solve time, so any other scale of dw
# would break w = (1/(lambda n)) sum y alpha x, on which the duality-gap
# certificate rests.  The gap is evaluated at drained boundaries, where
# every contribution has landed and w = w(alpha) holds exactly again
# (arXiv:1611.02189).
#
# Determinism: the window is indexed by round, never by arrival.  Round r
# joins at round r + S, so the trajectory is a function of round numbers
# alone and bit for bit from run to run; the asynchrony moves the waiting
# off the critical path, not the data.


def partial_gamma(gamma: float, k: int, m: int) -> float:
    """The aggregation scale for applying ``m`` of ``k`` CoCoA+
    contributions whose subproblems were solved against sigma' = K*gamma:
    gamma itself, on purpose.  sigma' >= gamma*m holds for every m <= K,
    so the subset is safe at gamma; a subset scaled up (gamma*K/m, also
    inside the bound) would need the gang to agree on which contributions
    made the subset to keep w = w(alpha), since each owner applied
    gamma*dalpha at solve time."""
    if not 1 <= m <= k:
        raise ValueError(f"partial aggregation needs 1 <= m <= K, got "
                         f"m={m}, K={k}")
    return float(gamma)


class StaleJoinWindow:
    """The join window of a host-exchange gang round (``--staleRounds``;
    the transport is parallel/distributed.py's ExchangeHandle).

    Each round ``t`` the caller posts its contribution, registers the
    exchange with :meth:`admit`, then applies what :meth:`join_due`
    returns: exactly the rounds whose window ends at ``t`` (round r at
    t = r + S).  :meth:`drain` joins everything pending, at the eval and
    checkpoint boundaries, where w = w(alpha) must hold exactly.
    ``stale_rounds=0`` is the synchronous barrier: round t joins at t.

    **Gap-rise collapse** (:meth:`on_eval`): a gap that rose at an eval
    sets the window to 0 until a later eval improves again, as a momentum
    restart does; it withdraws the permission for further late joins and
    never unwinds an applied contribution.

    **Elastic** (:meth:`abort`): a gang teardown or resize drops the
    pending handles without joining them; the next generation resumes
    from a drained checkpoint, so no half-joined round crosses
    generations.

    Each late join (``rounds_late >= 1``) emits one ``stale_join``
    event; synchronous joins emit none."""

    def __init__(self, stale_rounds: int, algorithm: str = "CoCoA+"):
        s = int(stale_rounds)
        if s < 0:
            raise ValueError(f"staleRounds must be >= 0, got {stale_rounds}")
        self.stale_rounds = s
        self.algorithm = algorithm
        self.collapsed = False   # a gap rise set the window to 0
        self._last_gap = None
        self._pending: dict = {}   # round -> ExchangeHandle | payload list

    def effective_window(self) -> int:
        return 0 if self.collapsed else self.stale_rounds

    def pending_rounds(self) -> list:
        return sorted(self._pending)

    def admit(self, t: int, handle) -> None:
        """Register round ``t``'s exchange: an ExchangeHandle, or a
        payload list already collected (the synchronous path)."""
        if t in self._pending:
            raise ValueError(f"round {t} already has a pending exchange")
        self._pending[t] = handle

    def join_due(self, t: int) -> list:
        """Join every round whose window ends by round ``t`` (rounds
        r <= t - S): ``[(round, payloads, rounds_late), ...]`` in round
        order, ``rounds_late = t - r`` never past the configured S."""
        cut = t - self.effective_window()
        return self._join([r for r in sorted(self._pending) if r <= cut], t)

    def drain(self, t: int) -> list:
        """Join everything pending (an eval or checkpoint boundary): the
        contributions returned must be applied before the gap is
        evaluated."""
        return self._join(sorted(self._pending), t)

    def abort(self) -> None:
        """Drop the pending handles unjoined (teardown or resize): their
        collector threads die with the process; nothing is applied."""
        self._pending.clear()

    def _join(self, rounds: list, t: int) -> list:
        out = []
        for r in rounds:
            h = self._pending.pop(r)
            payloads = h.join() if hasattr(h, "join") else h
            late = max(0, t - r)
            if late > self.stale_rounds:
                # the bound the user asked for: a caller that skipped
                # join_due for a round fails here, rather than applying an
                # arbitrarily stale contribution
                raise RuntimeError(
                    f"round {r} would join {late} rounds late — past "
                    f"the --staleRounds={self.stale_rounds} window; a "
                    f"caller skipped join_due for it")
            if late >= 1:
                get_bus().emit(
                    "stale_join", algorithm=self.algorithm, t=int(t),
                    round=int(r), rounds_late=int(late),
                    workers=len(payloads) if payloads is not None else None)
            out.append((r, payloads, late))
        return out

    def on_eval(self, gap) -> bool:
        """The gap-rise rule at an eval (after :meth:`drain` and the
        gap's evaluation): a rise sets the window to 0 until an eval that
        improves restores it.  True when this eval changed the state."""
        if gap is None:
            return False
        g = float(gap)
        prev = self._last_gap
        self._last_gap = g
        if prev is None:
            return False
        if g > prev and not self.collapsed:
            self.collapsed = True
            return True
        if g <= prev and self.collapsed:
            self.collapsed = False
            return True
        return False
