"""Fleet training: many tenant models through one captured loop
(counterpart of cocoa_tpu/solvers/fleet.py).

The whole fleet runs as one device loop (solvers/base.py
``drive_fleet_on_device``): each tenant's lambda*n and sigma' enter the
solo path's plain local-SDCA loops (ops/local_sdca.py) as tensors, one
value per shard row, instead of floats, so one captured graph serves
every tenant, every sigma' stage and every round, and each tenant's
duality-gap certificate is the solo certificate of its lane.

Three drive modes (the fleet mirror of the solo ladder):

- ``plain``: a fixed sigma' (the safe K*gamma, or an explicit one);
- ``anneal``: each tenant's sigma' schedule, sigma' = levels[stage_t]
  read from the ladder as data;
- ``accel``: each tenant's secant (Anderson-1) outer loop, its own
  window bank, jumps and restarts (the fixed-Theta ladder).

No TPU kernel lies on this path: the JAX package runs the fleet's inner
loops in plain XLA under a vmap over tenants (the Pallas and block
kernels own their shard axes and cannot ride it), so here they are the
plain torch loops, ``--math=fast`` included.

A one-tenant fleet equals the solo run bit for bit in all three modes
(the solo plain round at ``--math=fast``); with ``lane_exec="map"`` every
lane does at any T, each lane running the solo round's code on its own
rows; a certified tenant's (w, alpha) is frozen bit for bit from its
certifying eval while the rest train on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from cocoa_torch.config import DebugParams, Params
from cocoa_torch.data.fleet import FleetDataset
from cocoa_torch.evals import objectives
from cocoa_torch.ops.dense_sdca import dense_sdca_round_plain
from cocoa_torch.ops.local_sdca import local_sdca, local_sdca_fast
from cocoa_torch.parallel.fanout import lane_fanout
from cocoa_torch.solvers import base
from cocoa_torch.solvers.cocoa import _secant_jump
from cocoa_torch.telemetry import events as _tele

DRIVE_MODES = ("plain", "anneal", "accel")


@dataclasses.dataclass
class FleetResult:
    """One fleet run's outcome, per tenant and aggregate."""

    algorithm: str
    tenants: list                 # T tenant ids
    certified: np.ndarray         # (T,) bool: gap target reached
    stalled: np.ndarray           # (T,) bool: divergence watch fired
    cert_round: np.ndarray        # (T,) int: certifying round, 0 = never
    final_primal: np.ndarray      # (T,)
    final_gap: np.ndarray         # (T,)
    rounds_run: int               # rounds the loop actually executed
    evals: int
    wall_s: float                 # queueing to fetch, capture included
    w: torch.Tensor               # (T, d) final primal iterates
    alpha: torch.Tensor           # (T, K, n_shard) final duals
    traj: np.ndarray              # (evals, T, base.FLEET_N_COLS)
    graphs: dict = dataclasses.field(default_factory=dict)  # capture s
    dead: int = 0                 # steps replayed after every lane stopped
    replay_ms: Optional[float] = None  # device ms a replayed step (CUDA)

    @property
    def models_per_second(self) -> float:
        return float(self.certified.sum()) / max(self.wall_s, 1e-9)


def _lane_views(fleet: FleetDataset) -> list:
    """Each tenant's own rows of every shard tensor, contiguous: views
    where the tenant fills the fleet's shard length, else copies, since a
    product with a strided view runs another kernel than the solo run's
    and rounds apart from it."""
    shards = fleet.shard_arrays()
    return [{key: v[t, :, :fleet.own_rows(t)].contiguous()
             for key, v in shards.items()} for t in range(fleet.t)]


def _tenant_chunk_parts(fleet: FleetDataset, params: Params, mode: str,
                        scaling: float, math: str, lane_exec: str,
                        per_tenant_idxs: bool, lanes: list):
    """The chunk of rounds over every lane with each tenant's lambda*n and
    sigma' (the fleet twin of solvers/cocoa.py ``_sdca_round_parts``,
    exact and fast math only): ``chunk((w, alpha), tables, sigma) -> (w,
    alpha)``, ``sigma`` a float or a (T,) tensor.  ``vmap`` runs the T*K
    shard rows as one batch; ``map`` runs each lane through the solo
    round's code on its own rows, ``lanes`` (:func:`_lane_views`;
    :func:`lane_fanout`)."""
    if math not in ("exact", "fast"):
        raise ValueError(f"fleet math must be 'exact' or 'fast', got "
                         f"{math!r}")
    t_fleet, k, n_shard, d = fleet.t, fleet.k, fleet.n_shard, \
        fleet.num_features
    shards = fleet.shard_arrays()
    flat = {key: v.reshape(t_fleet * k, *v.shape[2:])
            for key, v in shards.items()}
    # float64(lambda)*n rounded once to the dtype: the value a solo run
    # fills for its own lambda*n (ops/local_sdca.py _coef_staging)
    lam_n_rows = torch.tensor(np.repeat(fleet.lams * fleet.n, k),
                              dtype=fleet.dtype, device=fleet.device)
    common = dict(mode=mode, loss=params.loss, smoothing=params.smoothing)

    def rows_of(tab):
        # (K, H) shared, or (T, K, H) per tenant -> (T*K, H)
        return tab.reshape(t_fleet * k, -1) if per_tenant_idxs \
            else tab.repeat(t_fleet, 1)

    def batched_round(w, alpha, idxs, sigma):
        a_flat = alpha.reshape(t_fleet * k, n_shard)
        kw = dict(sigma=sigma, lam_n=lam_n_rows, **common)
        if math == "exact":
            w_rows = w[:, None, :].expand(t_fleet, k, d).reshape(-1, d)
            da, dw = local_sdca(w_rows, a_flat, flat, idxs, 0.0, 0, **kw)
            step = da
        else:
            m0 = torch.stack([shards["X"][t] @ w[t]
                              for t in range(t_fleet)])
            dw0 = torch.zeros(t_fleet * k, d, dtype=w.dtype,
                              device=w.device)
            da, dw = local_sdca_fast(m0.reshape(t_fleet * k, n_shard),
                                     a_flat, flat, idxs, 0.0, 0, dw0, **kw)
            # the solo plain round's alpha + scaling*(alpha_inner - alpha)
            step = (a_flat + da) - a_flat
        return (w + scaling * dw.view(t_fleet, k, d).sum(1),
                alpha + scaling * step.view(t_fleet, k, n_shard))

    def lane_round(t, w, alpha, idxs, sigma):
        m = fleet.own_rows(t)
        a = alpha[:, :m]
        sh = lanes[t]
        lam, n = float(fleet.lams[t]), int(fleet.n[t])
        if math == "exact":
            da, dw = local_sdca(w, a, sh, idxs, lam, n, sigma=sigma,
                                **common)
            a_new = a + scaling * da
        else:
            dw, a_inner = dense_sdca_round_plain(
                w, a, sh["X"], sh["labels"], sh["sq_norms"], idxs, lam, n,
                sigma=sigma, **common)
            a_new = a + scaling * (a_inner - a)
        return w + scaling * dw.sum(0), F.pad(a_new, (0, n_shard - m))

    def batched(state, tables, sigma):
        w, alpha = state
        sig = sigma if not isinstance(sigma, torch.Tensor) \
            else sigma.repeat_interleave(k)
        for tab in tables:
            w, alpha = batched_round(w, alpha, rows_of(tab), sig)
        return w, alpha

    def per_lane(t, state_t, tables, sigma):
        w, alpha = state_t
        sig = sigma if not isinstance(sigma, torch.Tensor) else sigma[t]
        for tab in tables:
            w, alpha = lane_round(t, w, alpha,
                                  tab[t] if per_tenant_idxs else tab, sig)
        return w, alpha

    return lane_fanout(per_lane, lane_exec, batched=batched)




def run_cocoa_fleet(
    fleet: FleetDataset,
    params: Params,
    debug: DebugParams,
    plus: bool = True,
    drive_mode: str = "plain",
    rng: str = "reference",
    math: str = "exact",
    lane_exec: str = "vmap",
    quiet: bool = False,
    divergence_guard: str = "auto",
    start_round: int = 1,
) -> FleetResult:
    """Train every tenant of ``fleet`` through one device loop, with the
    JAX package's arguments, checks and messages
    (cocoa_tpu/solvers/fleet.py:110-390).  ``params.lam`` is ignored
    (lambda is per tenant, ``fleet.lams``); ``params.local_iters`` must be
    the fleet's H; ``debug.debug_iter`` is the eval and chunk cadence and
    must divide ``params.num_rounds``.  On CUDA the step is one captured
    graph, replayed.  Emits the ``fleet_progress`` and
    ``tenant_certified`` events when the telemetry bus is active."""
    if drive_mode not in DRIVE_MODES:
        raise ValueError(f"fleet drive mode must be one of {DRIVE_MODES}, "
                         f"got {drive_mode!r}")
    if lane_exec not in ("vmap", "map"):
        raise ValueError(f"fleet lane_exec must be vmap|map, got "
                         f"{lane_exec!r}")
    c = debug.debug_iter
    if c <= 0:
        raise ValueError("the fleet loop requires debugIter > 0 (the eval "
                         "cadence is its chunk axis)")
    if params.num_rounds % c != 0:
        raise ValueError(
            f"fleet numRounds ({params.num_rounds}) must be a multiple of "
            f"debugIter ({c}) — the vmapped loop has no sub-cadence tail")
    if params.local_iters != fleet.local_iters:
        raise ValueError(
            f"params.local_iters ({params.local_iters}) disagrees with "
            f"the fleet's common H ({fleet.local_iters})")
    t_fleet, k, h = fleet.t, fleet.k, fleet.local_iters
    dtype, device = fleet.dtype, fleet.device
    mode = "plus" if plus else "cocoa"
    name = ("CoCoA+" if plus else "CoCoA") + " fleet"
    scaling = params.gamma if plus else params.beta / k
    safe = k * params.gamma
    sigma_fixed = safe
    if params.sigma is not None and params.sigma != "auto":
        sigma_fixed = float(params.sigma)
    has_targets = bool(np.all(np.isfinite(fleet.gap_targets)))

    levels = None
    n_stages = 0
    if drive_mode == "anneal":
        if not has_targets:
            raise ValueError(
                "fleet drive_mode='anneal' needs a gap target for every "
                "tenant (the backoff rides the per-tenant stall watch, "
                "which runs on the gap-target path)")
        start = (sigma_fixed if sigma_fixed < safe else safe / 2.0)
        levels = base.anneal_levels(start, safe)
        n_stages = len(levels)
    if drive_mode == "accel" and not has_targets:
        raise ValueError(
            "fleet drive_mode='accel' needs a gap target for every tenant "
            "(the momentum restart rule monitors each lane's gap)")
    guard_on = (n_stages > 1) or base.resolve_divergence_guard(
        divergence_guard, mode, sigma_fixed, k, params.gamma)

    # the index tables, sampled on the host once a run: one table when
    # every tenant's shard sizes coincide, else one per tenant
    n_chunks = params.num_rounds // c
    counts0 = fleet.counts[0]
    shared_tables = bool(np.all(fleet.counts == counts0[None]))
    per_round_ints = (1 if shared_tables else t_fleet) * k * h
    table_bytes = 4 * params.num_rounds * per_round_ints
    if table_bytes > base.MAX_IDX_TABLE_BYTES:
        raise ValueError(
            f"fleet index tables would need {table_bytes >> 20} MiB "
            f"(> {base.MAX_IDX_TABLE_BYTES >> 20} MiB): lower numRounds "
            f"or localIterFrac, or split the fleet")

    def tenant_tables(counts):
        sampler = base.IndexSampler(rng, debug.seed, h, counts)
        tab = sampler.chunk_indices(start_round, params.num_rounds)
        return tab.reshape(n_chunks, c, k, h)

    if shared_tables:
        tables = tenant_tables(counts0)
    else:
        tables = torch.stack([tenant_tables(fleet.counts[ti])
                              for ti in range(t_fleet)], dim=2)

    lanes = _lane_views(fleet)
    chunk = _tenant_chunk_parts(fleet, params, mode, scaling, math,
                                lane_exec, not shared_tables, lanes)
    lam_t = [float(v) for v in fleet.lams]
    n_t = [int(v) for v in fleet.n]
    levels_t = (None if levels is None else
                torch.tensor(levels, dtype=dtype, device=device))

    def sigma_of(state):
        if levels_t is None:
            return sigma_fixed
        stage = state[-1][:, 0].clamp(0, n_stages - 1).long()
        return levels_t[stage]

    def jump(state):
        # the solo run's chunk-head secant jump, lane by lane on each
        # lane's own rows, taken where the lane's eval armed it
        w, alpha, hist, sched = state
        armed = sched[:, base.A_JUMP] > 0
        ws, alphas = [], []
        for t, sh in enumerate(lanes):
            m = fleet.own_rows(t)
            inv = float(np.float32(1.0 / (lam_t[t] * n_t[t])))
            wj, aj = _secant_jump(w[t], alpha[t, :, :m], hist[t, :, :, :m],
                                  sh, inv)
            ws.append(wj)
            alphas.append(F.pad(aj, (0, fleet.n_shard - m)))
        sched = sched.clone()
        sched[:, base.A_JUMP] = 0.0
        return (torch.where(armed[:, None], torch.stack(ws), w),
                torch.where(armed[:, None, None], torch.stack(alphas),
                            alpha), hist, sched)

    def step_fn(state, tabs):
        head = jump(state) if drive_mode == "accel" else state
        w, alpha = chunk(head[:2], tabs, sigma_of(head))
        rest = head[2:]
        if rest:
            sched = rest[-1].clone()
            sched[:, 4] += float(c)
            rest = (*rest[:-1], sched)
        return head, (w, alpha, *rest)

    def eval_fn(state):
        w, alpha = state[0], state[1]
        return torch.stack([objectives.eval_metrics(
            w[t], alpha[t, :, :fleet.own_rows(t)], sh, lam_t[t], n_t[t],
            loss=params.loss, smoothing=params.smoothing)
            for t, sh in enumerate(lanes)])

    w0 = torch.zeros((t_fleet, fleet.num_features), dtype=dtype,
                     device=device)
    alpha0 = torch.zeros((t_fleet, k, fleet.n_shard), dtype=dtype,
                         device=device)
    state = (w0, alpha0)
    if drive_mode == "anneal":
        state += (torch.from_numpy(np.tile(
            base.sched_init_array(start_round)[None], (t_fleet, 1))
        ).to(device),)
    elif drive_mode == "accel":
        state += (torch.zeros((t_fleet, 2, k, fleet.n_shard), dtype=dtype,
                              device=device),
                  torch.from_numpy(np.tile(base.sched_init_array(
                      start_round, accel=True)[None], (t_fleet, 1))
                  ).to(device))

    if not quiet:
        print(f"\nRunning {name}: {t_fleet} tenants x (K={k}, "
              f"n_shard={fleet.n_shard}, d={fleet.num_features}, H={h}) "
              f"— one compiled round, drive_mode={drive_mode}")
    t0 = time.perf_counter()
    runner, n_done, traj_host, certified, stalled, cert_chunk, \
        stall_chunk = base.drive_fleet_on_device(
            name, state, step_fn, eval_fn, tables, fleet.gap_targets,
            start_round=start_round, stall_evals=base.stall_window(c),
            divergence_guard=guard_on, n_stages=n_stages,
            accel=(drive_mode == "accel"), key=(drive_mode, c))
    wall_s = time.perf_counter() - t0

    cert_round = np.where(cert_chunk > 0,
                          start_round - 1 + cert_chunk * c, 0)
    last = traj_host[n_done - 1] if n_done else np.full(
        (t_fleet, base.FLEET_N_COLS), np.nan)
    result = FleetResult(
        algorithm=name, tenants=list(fleet.tenants), certified=certified,
        stalled=stalled, cert_round=cert_round.astype(np.int64),
        final_primal=last[:, 0].copy(), final_gap=last[:, 1].copy(),
        rounds_run=n_done * c, evals=n_done, wall_s=wall_s,
        w=runner.state[0], alpha=runner.state[1], traj=traj_host,
        graphs=runner.graphs, dead=runner.dead, replay_ms=runner.replay_ms)

    bus = _tele.get_bus()
    if bus.active():
        for j in range(n_done):
            t_round = start_round - 1 + (j + 1) * c
            cum = int(((cert_chunk > 0) & (cert_chunk <= j + 1)).sum())
            # active = lanes still updating: certified and stalled-out
            # lanes are both frozen from their done eval on
            inactive = int((((cert_chunk > 0) & (cert_chunk <= j + 1))
                            | ((stall_chunk > 0)
                               & (stall_chunk <= j + 1))).sum())
            for ti in np.nonzero(cert_chunk == j + 1)[0]:
                bus.emit("tenant_certified", algorithm=name,
                         tenant=fleet.tenants[int(ti)], t=t_round,
                         gap=float(traj_host[j, int(ti), 1]))
            bus.emit(
                "fleet_progress", algorithm=name, t=t_round,
                active=t_fleet - inactive, certified_total=cum,
                models_per_second=(result.models_per_second
                                   if j == n_done - 1 else None))
    if not quiet:
        done_n = int(certified.sum())
        print(f"{name}: {done_n}/{t_fleet} tenants certified in "
              f"{result.rounds_run} rounds, {wall_s:.2f}s wall — "
              f"{result.models_per_second:.1f} models/s")
    return result
