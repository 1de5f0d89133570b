"""Shared solver machinery (counterpart of parts of
cocoa_tpu/solvers/base.py): the shard check, the index sampler (host or
device tables, ``--sampling``), the chunk size (``--scanChunk``), the
chunked round loop, each chunk of rounds one replayed CUDA graph on the
card, with the JAX host-stepped driver's ladder (``drive_chunked``): the
gap-target stop, the divergence guard's stall watch, the sigma' anneal
schedule and the accelerated outer loop's window bookkeeping; and the
device-resident run (``--deviceLoop``, JAX's ``drive_device_full``),
where the evals and the ladder run on the card too.

The schedule state is the JAX package's float32 sched vector.  The
chunked loop keeps it as a numpy array on the host, which picks each
chunk's branch from it, so no device read is added to the one fetch per
eval; the device loop keeps it on the card (:func:`ladder_step`, the
device twin of the host steps) and reads it back once a super-block.

Telemetry rides the host side of both loops, as in the JAX package: a
``local_solve`` span around each chunk's queueing (and each device-loop
super-block, its fetch included), an ``eval`` span around each eval's
fetch, and the events of the ladder (``round_eval``, ``sigma_backoff``,
``momentum_restart``, ``theta_stage``, ``divergence``).  None of it sits
inside a captured graph's body or reads the card: the device loop's
events are decoded from each super-block's fetched rows
(:class:`~cocoa_torch.telemetry.events.DeviceTap`)."""

from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from cocoa_torch import checkpoint, kernels
from cocoa_torch.config import DebugParams, Params
from cocoa_torch.data.sharding import ShardedDataset
from cocoa_torch.evals import objectives
from cocoa_torch.parallel import distributed
from cocoa_torch.telemetry import events as _events
from cocoa_torch.telemetry import tracing as _tracing
from cocoa_torch.utils import prng
from cocoa_torch.utils.logging import Trajectory


def check_shards(ds: ShardedDataset) -> None:
    """Reject empty shards up front (the reference crashes inside the task
    on ``nextInt(0)`` when numSplits > rows)."""
    counts = ds.global_counts
    if np.any(counts <= 0):
        raise ValueError(
            f"every shard needs at least one example; shard sizes are "
            f"{counts.tolist()} (n={ds.n} over K={ds.k} shards) -- "
            f"lower numSplits")


def _owned(init, ds: ShardedDataset) -> torch.Tensor:
    """An owned copy of a restored tensor or array (as a checkpoint holds
    it) in the dataset's dtype on its device, so no graph's buffer is
    aliased."""
    return torch.as_tensor(init).to(device=ds.device, dtype=ds.dtype).clone()


def fit_padding(a: torch.Tensor, size: int):
    """``a`` zero-padded or cut to ``size`` along its last axis; None when
    the cut would drop a nonzero.  The JAX package pads its shards wider
    than the port does (rows to a multiple of 16, dense features to one
    of 8): slots that no update reaches and that stay exactly 0, so a JAX
    checkpoint's state fits the port's shapes exactly."""
    n = a.shape[-1]
    if n <= size:
        return torch.nn.functional.pad(a, (0, size - n))
    if bool(torch.count_nonzero(a[..., size:])):
        return None
    return a[..., :size].clone()


def restore_w(w_init, ds: ShardedDataset) -> torch.Tensor:
    """w (or ProxCoCoA+'s residual) from a restored ``w_init``, its zero
    padding fitted (:func:`fit_padding`)."""
    w = _owned(w_init, ds)
    out = fit_padding(w, ds.num_features) if w.ndim == 1 else None
    if out is None or w.shape[0] < ds.num_features:
        raise ValueError(
            f"w_init has shape {tuple(w.shape)} but the dataset has "
            f"{ds.num_features} features — was the checkpoint written with "
            f"different data?")
    return out


def align_alpha(alpha_init, ds: ShardedDataset) -> torch.Tensor:
    """(K, n_shard) alpha from a restored ``alpha_init`` with the JAX
    package's rule and messages (cocoa_tpu/solvers/base.py:1427-1449):
    the shard axis zero-padded when the checkpoint's is shorter (rows past
    counts[k] are never drawn, so the padding is exact), and, unlike JAX,
    cut when it is longer with only zeros past ``n_shard``, as a JAX
    checkpoint's is (:func:`fit_padding`).  A gang's rank takes its own
    shards [shard_lo, shard_lo + m) of a whole-run (K, ...) alpha, as
    every checkpoint holds it, whatever gang wrote it."""
    a = _owned(alpha_init, ds)
    if a.ndim == 2 and ds.m != ds.k and a.shape[0] == ds.k:
        a = a[ds.shard_lo:ds.shard_lo + ds.m]
    if a.ndim != 2 or a.shape[0] != ds.m:
        raise ValueError(
            f"alpha_init shape {tuple(a.shape)} is incompatible with "
            f"K={ds.k} shards")
    out = fit_padding(a, ds.n_shard)
    if a.shape[1] < int(ds.counts.max()) or out is None:
        raise ValueError(
            f"alpha_init has {a.shape[1]} rows per shard but the dataset "
            f"shards to counts={ds.global_counts.tolist()} "
            f"(n_shard={ds.n_shard}) — was the checkpoint written with "
            f"different data or numSplits?")
    return out


class IndexSampler:
    """Per-round local-coordinate draws, (C, K, H) int32 tables for a
    chunk of rounds (see utils/prng.py for the modes).  With ``device``
    (``--sampling``, :func:`resolve_sampling`) a chunk makes its tables
    where its first round lies, :meth:`draw`: on the card, one launch of
    the draw kernel inside the captured chunk; without it the host builds
    them, :meth:`chunk_indices`, and the chunk copies them over.  Both are
    the same tables bit for bit.  ``lane0`` is the first lane's global
    shard id: a gang's rank draws rows [lane0, lane0 + len(counts)) of
    the whole run's tables."""

    MODES = prng.MODES

    def __init__(self, mode: str, seed: int, h: int, counts,
                 device: bool = False, lane0: int = 0):
        if mode not in self.MODES:
            raise ValueError(
                f"rng mode must be one of {self.MODES}, got {mode!r}")
        self.mode = mode
        self.seed = seed
        self.h = h
        self.counts = np.asarray(counts)
        self.device = device
        self.lane0 = int(lane0)
        if np.any(self.counts <= 0):
            raise ValueError(
                f"all shards must be non-empty, got sizes {self.counts}")
        self._counts_on = {}

    def device_capable(self, max_round: int) -> bool:
        """Whether device tables are exact for this run, by the JAX
        package's rule (cocoa_tpu/solvers/base.py ``device_capable``):
        reference replay while seed + round stays in int32
        (:func:`prng.device_replay_ok`), permuted while (rounds + 1) * H
        does; the counter hash always."""
        if self.mode == "reference":
            return prng.device_replay_ok(self.seed, max_round)
        if self.mode == "permuted":
            return (max_round + 1) * self.h < (1 << 31)
        return True

    def ints_per_round(self) -> int:
        """Index-table ints copied from the host per round: K*H, or 1 (the
        first round) in device mode."""
        return 1 if self.device else int(self.counts.shape[0]) * self.h

    def chunk_indices(self, t0: int, c: int) -> torch.Tensor:
        """Host tables for rounds t0..t0+c-1 (1-based, as the reference),
        on the CPU."""
        return prng.host_tables(self.mode, self.seed, self.h, self.counts,
                                t0, c, self.lane0)

    def draw(self, t0: torch.Tensor, c: int) -> torch.Tensor:
        """Device mode's tables for rounds t0..t0+c-1, ``t0`` a 0-d int64
        tensor read where it lies (:func:`prng.draw_tables`).  The shard
        sizes go to that device once, at the first call."""
        counts = self._counts_on.get(t0.device)
        if counts is None:
            counts = torch.as_tensor(self.counts, dtype=torch.int64).to(
                t0.device)
            self._counts_on[t0.device] = counts
        return prng.draw_tables(self.mode, self.seed, self.h, counts, t0, c,
                                self.lane0)

    def round_indices(self, t: int) -> torch.Tensor:
        return self.chunk_indices(t, 1)[0]


def resolve_sampling(sampling: str, sampler: IndexSampler,
                     max_round: int) -> bool:
    """``--sampling`` resolved to the sampler's ``device`` switch, with
    the JAX package's rules and messages (cocoa_tpu/solvers/base.py
    ``resolve_sampling``): ``auto`` makes the tables on the device
    wherever they are exact for this run, ``host`` never, ``device``
    insists and raises where they are not exact; permuted draws past the
    int32 global step raise in every setting."""
    if sampling not in ("auto", "device", "host"):
        raise ValueError(
            f"sampling must be auto|device|host, got {sampling!r}")
    capable = sampler.device_capable(max_round)
    if not capable and sampler.mode == "permuted":
        raise ValueError(
            f"rng=permuted overflows int32 global-step arithmetic for "
            f"num_rounds={max_round}, localIters={sampler.h} "
            f"((rounds+1)*H must stay below 2^31); split the run via "
            f"checkpoint/resume or lower localIterFrac"
        )
    if sampling == "host":
        return False
    if sampling == "device" and not capable:
        raise ValueError(
            f"device sampling is not exact for rng={sampler.mode!r} with "
            f"seed={sampler.seed}, num_rounds={max_round} (int32 range); "
            f"use --sampling=host"
        )
    return capable


def make_sampler(rng: str, seed: int, h: int, counts, sampling: str,
                 num_rounds: int, lane0: int = 0) -> IndexSampler:
    """The run's sampler with ``--sampling`` resolved."""
    sampler = IndexSampler(rng, seed, h, counts, lane0=lane0)
    sampler.device = resolve_sampling(sampling, sampler, num_rounds)
    return sampler


def chunk_rounds(debug: DebugParams, k: int, h: int,
                 scan_chunk: Optional[int] = None) -> int:
    """Rounds per chunk (``--scanChunk``): ``scan_chunk`` when given, and
    one round a chunk when it is not positive, as the JAX package runs
    ``scan_chunk <= 0`` round by round; by default the JAX CLI's
    (cocoa_tpu/cli.py:1590-1599): the eval cadence, capped so one chunk's
    (C, K, H) table stays modest when debugIter is large.  A chunk also
    ends at every eval (:func:`drive`)."""
    if scan_chunk is not None:
        return max(1, int(scan_chunk))
    cap = max(1, 32_000_000 // max(1, k * h))
    return min(debug.debug_iter if debug.debug_iter > 0 else 50, cap)


# The divergence guard's stall watch (cocoa_tpu/solvers/base.py:35-66):
# bail out when the best gap has not improved to <= STALL_REL x (the best
# at the last reset) within the window, which is denominated in rounds
# (STALL_ROUNDS) with STALL_EVALS evals as its floor.
STALL_EVALS = 12
STALL_ROUNDS = 300
STALL_REL = 0.75


def stall_window(debug_iter: int) -> int:
    """The no-improvement window in evals for this eval cadence."""
    return max(STALL_EVALS, -(-STALL_ROUNDS // max(1, int(debug_iter))))


# The sigma' anneal schedule's state (cocoa_tpu/solvers/base.py:70-97), a
# float32 vector: sched[0] stage (index into the sigma' ladder), sched[1]
# stall (no-improvement evals at this stage), sched[2] best gap since the
# stage started, sched[3] best at the last watch reset, sched[4] t_next
# (the 1-based round the next chunk starts at; the warm start's loss
# handoff reads it).  Small integers and float32 gaps, exact in float32.
SCHED_LEN = 5
MAX_SIGMA_LEVELS = 8

# The accelerated outer loop's slots after the schedule's
# (cocoa_tpu/solvers/base.py:99-175): the window bank's length, the armed
# jump, the restart count, the last eval's gap, and the Theta ladder's
# stage and stall watch.  The state then also holds ``hist``, the two
# previous eval-boundary alpha snapshots, (2, K, n_shard) on the device.
ACCEL_LEN = 8
A_HIST = SCHED_LEN
A_JUMP = SCHED_LEN + 1
A_RESTARTS = SCHED_LEN + 2
A_LASTGAP = SCHED_LEN + 3
A_TH_STAGE = SCHED_LEN + 4
A_TH_STALL = SCHED_LEN + 5
A_TH_BEST = SCHED_LEN + 6
A_TH_BPREV = SCHED_LEN + 7

# the secant jump's coefficient c = rho/(1 - min(rho, RHO_CAP)) clipped
# to [CMIN, CMAX]; the JAX package applies them as float32 constants
ACCEL_CMIN = -0.5
ACCEL_CMAX = 3.0
ACCEL_RHO_CAP = 0.9

# the Theta (local accuracy) ladder: H/2 then H inner steps; a stage
# advances when the gap misses halving for THETA_EVALS evals, or jumps to
# full H once the gap is within THETA_NEAR x the target
THETA_DIVS = (2, 1)
THETA_REL = 0.5
THETA_EVALS = 1
THETA_NEAR = 10.0


def secant_coef(xp, rho):
    """The jump coefficient, ``xp`` numpy or torch.  Numpy takes the JAX
    package's float32 constants as they are; torch applies them to
    ``rho`` (a 0-d tensor) with the cap rounded to float32 first, as JAX's
    ``jnp.float32(ACCEL_RHO_CAP)`` is when promoted to a float64 ``rho``.
    The other constants are exact in float32."""
    if xp is np:
        den = np.float32(1.0) - np.minimum(rho, np.float32(ACCEL_RHO_CAP))
        return np.clip(rho / den, np.float32(ACCEL_CMIN),
                       np.float32(ACCEL_CMAX))
    cap = torch.full_like(rho, float(np.float32(ACCEL_RHO_CAP)))
    return torch.clamp(rho / (1.0 - torch.minimum(rho, cap)), ACCEL_CMIN,
                       ACCEL_CMAX)


def theta_ladder(h: int, adaptive: bool) -> tuple:
    """Inner steps per Theta stage, coarse to exact; the last is the full
    ``h``, and a small ``h`` drops duplicate rungs."""
    if not adaptive:
        return (int(h),)
    out = []
    for dv in THETA_DIVS:
        hs = min(int(h), max(1, int(h) // dv))
        if not out or hs > out[-1]:
            out.append(hs)
    return tuple(out)


class AccelConfig:
    """The accelerated loop's static configuration: the Theta ladder's
    inner steps per stage (the near-target jump reads ``drive``'s
    ``gap_target``)."""

    def __init__(self, theta_hs: tuple):
        self.theta_hs = tuple(int(v) for v in theta_hs)
        self.n_theta = len(self.theta_hs)


def _gap32(gap):
    return (np.float32(np.inf) if gap is None or np.isnan(gap)
            else np.float32(gap))


def _watch_update(xp, gv, best, best_prev, stall, rel):
    """One windowed no-improvement step, the arithmetic of every in-loop
    stall watch, ``xp`` numpy (the host twins) or torch (the device loop,
    :func:`ladder_step`); ``rel`` at the comparison's dtype.  Returns
    (best, best_prev, stall)."""
    best = xp.minimum(best, gv)
    improved = best <= rel * best_prev
    stall = xp.where(improved, xp.zeros_like(stall), stall + 1)
    best_prev = xp.where(improved, best, best_prev)
    return best, best_prev, stall


def accel_host_step(sched, gap, n_theta: int, gap_target,
                    seam: bool = False):
    """The accelerated loop's per-eval bookkeeping in float32, as the JAX
    package's ``accel_host_step``: a gap rise restarts the bank; two
    banked windows and an improving gap arm the jump (taken at the head
    of the next chunk); otherwise this eval's alpha is banked.  Then the
    Theta watch.  ``seam`` marks a sigma' backoff at this eval, which caps
    the bank at 1 as a Theta stage advance does.  Returns (sched,
    restarted, theta_staged)."""
    s = np.asarray(sched, dtype=np.float32).copy()
    gv = _gap32(gap)
    restarted = bool(gv > s[A_LASTGAP])
    if restarted:
        s[A_RESTARTS] += 1.0
        s[A_HIST] = 1.0
    elif s[A_HIST] >= 2.0:
        s[A_JUMP] = 1.0
        s[A_HIST] = 0.0
    else:
        s[A_HIST] = min(s[A_HIST] + 1.0, 2.0)
    s[A_LASTGAP] = gv
    staged = False
    if n_theta > 1:
        s[A_TH_BEST], s[A_TH_BPREV], s[A_TH_STALL] = _watch_update(
            np, gv, s[A_TH_BEST], s[A_TH_BPREV], s[A_TH_STALL],
            np.float32(THETA_REL))
        tgt32 = (np.float32(-np.inf) if gap_target is None
                 else np.float32(gap_target))
        near = bool(gv <= np.float32(THETA_NEAR) * tgt32)
        fire = bool(s[A_TH_STALL] >= np.float32(THETA_EVALS))
        if s[A_TH_STAGE] < n_theta - 1 and (near or fire):
            s[A_TH_STAGE] = (np.float32(n_theta - 1) if near
                             else s[A_TH_STAGE] + 1)
            s[A_TH_STALL] = 0.0
            s[A_TH_BEST] = np.float32(np.inf)
            s[A_TH_BPREV] = np.float32(np.inf)
            # the windows banked before the seam measured the old round
            # map: keep at most the alpha just banked; an armed jump stays
            s[A_HIST] = min(s[A_HIST], 1.0)
            staged = True
    if seam:
        s[A_HIST] = min(s[A_HIST], np.float32(1.0))
    return s, restarted, staged


def _accel_replace(state, sched):
    """Commit an accel step into (w, alpha, hist, sched): the sched vector,
    and, unless this eval armed a jump, the bank hist <- [hist[1], alpha]
    (a fresh tensor, on the device)."""
    w, alpha, hist = state[:3]
    if float(sched[A_JUMP]) <= 0.0:
        hist = torch.stack([hist[1], alpha])
    return (w, alpha, hist, sched)


def _emit_accel_events(name, t, restarted, restarts_total, staged, stage,
                       accel, quiet):
    """The ``momentum_restart`` and ``theta_stage`` events of one eval
    (emitted whatever ``quiet`` says) and their console lines, as the JAX
    package's ``_emit_accel_events``."""
    bus = _events.get_bus()
    if restarted:
        bus.emit("momentum_restart", algorithm=name, t=int(t),
                 restarts_total=int(restarts_total))
        if not quiet:
            print(f"{name}: momentum restart at round {t} (gap rose; "
                  f"secant window bank discarded)")
    if staged:
        bus.emit("theta_stage", algorithm=name, t=int(t), stage=int(stage),
                 h=int(accel.theta_hs[int(stage)]))
        if not quiet:
            print(f"{name}: Θ schedule — local accuracy raised to "
                  f"H={accel.theta_hs[int(stage)]} at round {t}")


def anneal_levels(start: float, safe: float, factor: float = 2.0,
                  max_levels: int = MAX_SIGMA_LEVELS) -> tuple:
    """The sigma' ladder: geometric from ``start`` up to ``safe`` = K*gamma,
    always the last rung; a ladder past ``max_levels`` jumps to safe on
    its last step."""
    if start >= safe:
        return (float(safe),)
    levels = [float(start)]
    while levels[-1] * factor < safe and len(levels) < max_levels - 1:
        levels.append(levels[-1] * factor)
    levels.append(float(safe))
    return tuple(levels)


def sched_init_array(start_round: int, sched_init=None,
                     accel: bool = False) -> np.ndarray:
    """The initial sched vector, float32 on the host: a restored one
    (``sched_init``, kept for checkpoint resume), or a fresh stage-0 watch
    at ``start_round``; with ``accel`` the accel slots follow.  A restored
    plain vector gains fresh accel slots, and an accel-length one without
    ``accel`` keeps its sigma' head."""
    head = np.array([0.0, 0.0, np.inf, np.inf, float(start_round)],
                    dtype=np.float32)
    tail = np.array([0.0, 0.0, 0.0, np.inf, 0.0, 0.0, np.inf, np.inf],
                    dtype=np.float32)
    if sched_init is not None:
        s = np.asarray(sched_init, dtype=np.float32)
        if s.shape not in ((SCHED_LEN,), (SCHED_LEN + ACCEL_LEN,)):
            raise ValueError(
                f"restored sigma-schedule state has shape {s.shape}, "
                f"expected ({SCHED_LEN},) or ({SCHED_LEN + ACCEL_LEN},) — "
                f"was the checkpoint written by an incompatible version?")
        if accel and s.shape == (SCHED_LEN,):
            return np.concatenate([s, tail])
        if not accel and s.shape == (SCHED_LEN + ACCEL_LEN,):
            return s[:SCHED_LEN].copy()
        return s.copy()
    return np.concatenate([head, tail]) if accel else head


def sched_host_step(sched, gap, stall_evals: int, n_stages: int):
    """The anneal's per-eval update in float32, as the JAX package's
    ``sched_host_step``: the stall watch, and a backoff to the next stage
    (a fresh watch; the iterate carries over) when it fires below the last
    stage.  Returns (sched, backed_off)."""
    s = np.asarray(sched, dtype=np.float32).copy()
    s[2], s[3], s[1] = _watch_update(np, _gap32(gap), s[2], s[3], s[1],
                                     np.float32(STALL_REL))
    backed = bool(s[1] >= np.float32(stall_evals) and s[0] < n_stages - 1)
    if backed:
        s[0] += 1.0
        s[1] = 0.0
        s[2] = np.float32(np.inf)
        s[3] = np.float32(np.inf)
    return s, backed


def resolve_divergence_guard(flag: str, mode: str, sigma: float, k: int,
                             gamma: float) -> bool:
    """``--divergenceGuard``: ``on``/``off`` force it; ``auto`` arms it only
    when sigma' is below the safe K*gamma in a mode whose subproblem reads
    sigma' (plus, prox)."""
    if flag not in ("auto", "on", "off"):
        raise ValueError(
            f"divergence guard must be auto|on|off, got {flag!r}")
    if flag != "auto":
        return flag == "on"
    return mode in ("plus", "prox") and sigma < k * gamma


def _last_gap(traj: Trajectory):
    """The newest eval's duality gap (None before the first eval and on
    solvers without a gap): what a checkpoint stamps into its meta."""
    for rec in reversed(traj.records):
        if rec.gap is not None:
            return float(rec.gap)
    return None


def save_checkpoint(debug: DebugParams, name: str, round_t: int,
                    state: tuple, n_iterate: int, accel, traj: Trajectory,
                    mesh=None):
    """Save ``state`` at ``round_t`` in the JAX package's layout
    (cocoa_tpu/solvers/base.py:680-687).  The port's state is the
    iterate (``n_iterate`` tensors: w, then alpha), then the accel bank on
    the device when ``accel`` is set, then the sched vector on the host
    when the run has one; JAX's is (w, alpha, sched) or (w, alpha, hist,
    sched).  Counted in ``traj.saves``, apart from the evals' fetches.
    A gang's ranks first gather the whole alpha and bank over the host
    group (``mesh``), so that each writes a complete file, as the JAX
    package's save does (cocoa_tpu/checkpoint.py:141-150)."""
    rest = state[n_iterate:]
    hist = rest[0] if accel is not None else None
    sched = rest[-1] if len(rest) > (accel is not None) else None
    alpha = state[1] if n_iterate > 1 else None
    if mesh is not None:
        alpha = (None if alpha is None
                 else distributed.host_gather_shards(alpha, 0))
        hist = (None if hist is None
                else distributed.host_gather_shards(hist, 1))
    checkpoint.save(debug.chkpt_dir, name, round_t, state[0], alpha,
                    seed=debug.seed,
                    sched=sched, hist=hist, gap=_last_gap(traj))
    traj.saves += 1


def checkpoints_on(debug: DebugParams) -> bool:
    return bool(debug.chkpt_dir) and debug.chkpt_iter > 0


class _GapWatch:
    """Windowed no-improvement watch over eval-cadence gaps, in Python
    floats; ``update(gap)`` is True when the run should bail out."""

    def __init__(self, n_evals: int = STALL_EVALS, rel: float = STALL_REL):
        self.n = n_evals
        self.rel = rel
        self.best = float("inf")
        self.best_prev = float("inf")
        self.stall = 0

    def update(self, gap) -> bool:
        if gap is None:
            return False
        self.best = min(self.best, float(gap))
        if self.best <= self.rel * self.best_prev:
            self.stall = 0
            self.best_prev = self.best
        else:
            self.stall += 1
        return self.stall >= self.n


def per_round(round_fn: Callable):
    """A chunk body (see :func:`drive`) that runs ``round_fn(iterate,
    idxs_kh, t) -> iterate`` once a round: ``idxs_kh`` the round's (K, H)
    table (None for a solver without draws), ``t`` its 1-based number as
    a 0-d int64 tensor on the device (the eta(t) schedules read it)."""
    def body(key, c, tables, t0, iterate):
        ts = t0 + torch.arange(c, dtype=torch.int64, device=t0.device)
        for r in range(c):
            iterate = round_fn(iterate, None if tables is None else tables[r],
                               ts[r])
        return iterate
    return body


class ChunkRunner:
    """Runs a chunk of rounds, ``body(key, c, tables, t0, iterate) ->
    iterate``: ``iterate`` the device tensors the rounds advance,
    ``tables`` the chunk's (C, K, H) draws (None without a sampler),
    ``t0`` the first round, a 0-d int64 tensor on the device that the host
    writes before each chunk, and ``key`` the branch the host picked.

    On the CPU, and with ``capture=False``, the body runs eagerly.  On
    CUDA each (key, c) is run eagerly once, which loads the libraries and
    sets every kernel's attributes outside any capture, then captured as
    one ``torch.cuda.CUDAGraph`` and replayed from then on.  The graph
    holds the chunk's tables (the draw kernel in device mode; else it
    reads a static buffer that the host fills before each replay), every
    round's kernels and glue, and the copy of the new iterate into static
    buffers, which the host's evals and the jump read between replays.  All graphs share one
    memory pool: a graph's outputs are copied into the static buffers,
    which lie outside the pool, before it ends, so nothing a graph
    allocates is live after its replay, and no order of replays can
    corrupt what another graph left.  A capture that fails raises.

    A replay launches no wrapper, so the wrappers' launch counts while a
    graph is captured are taken back and added again at each replay
    (:func:`cocoa_torch.kernels.add_launches`)."""

    def __init__(self, body: Callable, sampler, device, capture=None):
        self.body = body
        self.sampler = sampler
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.capture = cuda if capture is None else bool(capture)
        if self.capture and not cuda:
            raise ValueError("a captured chunk needs a CUDA device")
        # device tables come from the draw kernel on the card; on the CPU
        # its plain version is the host tables themselves
        self.draws = sampler is not None and sampler.device and cuda
        self.t0 = torch.zeros((), dtype=torch.int64, device=self.device)
        self.static = None
        self.host_tabs = {}
        self.graphs = {}
        self.seconds = {}
        self.pool = None
        self.stream = None

    def __call__(self, key, t: int, c: int, iterate: tuple) -> tuple:
        """Rounds t..t+c-1 on ``iterate``; returns the new iterate (on
        CUDA with capture, the static buffers themselves)."""
        self.t0.fill_(t)
        host = None
        if self.sampler is not None and not self.draws:
            host = self.sampler.chunk_indices(t, c)
            if self.capture:
                buf = self.host_tabs.get(c)
                if buf is None:
                    buf = torch.empty(host.shape, dtype=host.dtype,
                                      device=self.device)
                    self.host_tabs[c] = buf
                host = buf.copy_(host)
            else:
                host = host.to(self.device)
        if not self.capture:
            return self._chunk(key, c, host, iterate)
        if self.static is None:
            self.static = tuple(x.clone() for x in iterate)
        for buf, x in zip(self.static, iterate):
            if buf is not x:
                buf.copy_(x)
        graph = self.graphs.get((key, c))
        if graph is None:
            self._store(self._chunk(key, c, host, self.static))
            self.graphs[(key, c)] = self._capture(key, c, host)
        else:
            graph[0].replay()
            kernels.add_launches(graph[1])
        return self.static

    def _chunk(self, key, c, host, iterate):
        tables = self.sampler.draw(self.t0, c) if self.draws else host
        return self.body(key, c, tables, self.t0, iterate)

    def _store(self, out):
        for buf, x in zip(self.static, out):
            buf.copy_(x)

    def _capture(self, key, c, host):
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        start = time.perf_counter()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            graph.capture_begin(self.pool)
            try:
                self._store(self._chunk(key, c, host, self.static))
            except BaseException:
                _end_failed_capture(graph)
                raise
            graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        self.seconds[(key, c)] = time.perf_counter() - start
        delta = [b - a for a, b in zip(before, kernels.launch_counts())]
        kernels.add_launches([-n for n in delta])
        return graph, delta


GLOO_DEVICE_LOOP = (
    "--deviceLoop runs each chunk, its eval and the ladder as captured "
    "CUDA graphs, and this gang's device group is gloo (two ranks share a "
    "card), whose all-reduce cannot be captured; give each rank a card of "
    "its own (NCCL), or drop --deviceLoop for the chunked loop")


def gang_capture(capture: Optional[bool], device, mesh) -> Optional[bool]:
    """The chunks' ``capture`` for a gang's run: as asked, except that on
    the card a gloo device group (:attr:`~cocoa_torch.parallel.mesh.Mesh.
    capturable` False) runs the chunks eagerly, since a gloo collective
    cannot sit inside a CUDA graph."""
    if (mesh is None or mesh.capturable
            or torch.device(device).type != "cuda"):
        return capture
    return False


def _end_failed_capture(graph) -> None:
    """End a capture that its body broke off, so the stream leaves capture
    mode; the body's own error is the one raised."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass




class Schedule:
    """The branch table of a scheduled or accelerated run
    (cocoa_tpu/solvers/cocoa.py:701-826): one branch per (sigma' stage,
    loss phase, Theta stage), keyed ``(stage, phase, h)`` for the chunk's
    body, picked from the sched vector as ``br = (stage * n_phases +
    phase) * n_theta + theta``.  A chunk runs the warm phase (0) while it
    ends at or before round ``warm_end``; chunks never straddle an eval,
    so one test a chunk is exact.  ``jump(w, alpha, hist) -> (w, alpha)``
    is the accelerated loop's secant jump, taken at the head of the chunk
    after an eval armed it (None without acceleration)."""

    def __init__(self, n_levels: int, warm_end: int, n_phases: int,
                 theta_hs: tuple, jump: Optional[Callable] = None):
        self.n_levels = n_levels
        self.warm_end = warm_end
        self.n_phases = n_phases
        self.theta_hs = tuple(theta_hs)
        self.jump = jump
        self.keys = [(s, p, h) for s in range(n_levels)
                     for p in range(n_phases) for h in self.theta_hs]

    def index(self, sched, c: int):
        """The branch of a chunk of ``c`` rounds: an int from the host's
        numpy sched vector, a 0-d int64 tensor from the device's (no host
        read)."""
        n_theta = len(self.theta_hs)
        if isinstance(sched, torch.Tensor):
            br = sched[0].to(torch.int64).clamp(0, self.n_levels - 1) \
                * self.n_phases
            if self.n_phases == 2:
                warm = sched[4] + float(c - 1) <= float(self.warm_end)
                br = br + torch.logical_not(warm).to(torch.int64)
            br = br * n_theta
            if n_theta > 1:
                br = br + sched[A_TH_STAGE].to(torch.int64).clamp(
                    0, n_theta - 1)
            return br
        br = min(max(int(sched[0]), 0), self.n_levels - 1) * self.n_phases
        if self.n_phases == 2:
            warm = sched[4] + np.float32(c - 1) <= np.float32(self.warm_end)
            br += 0 if warm else 1
        br *= n_theta
        if n_theta > 1:
            br += min(max(int(sched[A_TH_STAGE]), 0), n_theta - 1)
        return br

    def head(self, c: int, state: tuple):
        """The chunked loop's head on the host: an armed jump, the chunk's
        key, and the sched vector's jump slot cleared and next round
        advanced by ``c``.  Returns (key, state)."""
        w, alpha = state[0], state[1]
        sched = state[-1].copy()
        if self.jump is not None:
            if sched[A_JUMP] > 0:
                w, alpha = self.jump(w, alpha, state[2])
            sched[A_JUMP] = 0.0
        key = self.keys[self.index(sched, c)]
        sched[4] += np.float32(c)
        return key, (w, alpha, *state[2:-1], sched)


class Ladder:
    """The static configuration of :func:`ladder_step`, as JAX's device
    loop derives it (cocoa_tpu/solvers/base.py:764-775): the guard's watch
    and the sigma' anneal arm only on gap-targeted runs (a fixed-round run
    executes exactly its budget), the anneal with more than one stage;
    ``n_theta`` is the Theta ladder's length on an accelerated run, 0
    without acceleration."""

    def __init__(self, gap_target, divergence_guard: bool, n_stages: int,
                 stall_evals: int, n_theta: int = 0):
        self.gap_target = gap_target
        check_div = gap_target is not None and divergence_guard
        self.anneal = check_div and n_stages > 1
        self.guard = check_div and not self.anneal
        self.n_stages = n_stages
        self.stall_evals = stall_evals
        self.n_theta = n_theta
        # the Theta watch's near-target bound, rounded to float32 once as
        # the host twin computes it
        tgt32 = np.float32(-np.inf if gap_target is None else gap_target)
        self.near = float(np.float32(THETA_NEAR) * tgt32)


# the device loop's eval row: primal, gap, test error, sigma' stage,
# stall, Theta stage, restarts (cocoa_tpu/solvers/base.py:776-787)
ROW_COLS = 7


def ladder_step(lad: Ladder, metrics, sched, watch, hist, alpha):
    """One eval's ladder step on the device, with no host read: the device
    twin of :func:`sched_host_step`, the divergence guard's watch and
    :func:`accel_host_step` (cocoa_tpu/solvers/base.py:802-934).
    ``metrics`` is the eval's (primal, gap, test error); ``sched`` the
    float32 sched vector (None without one); ``watch`` the guard's (stall,
    best, best_prev), 0-d int64 and float64 tensors (None unless it runs);
    ``hist`` the accel bank and ``alpha`` the iterate's alpha.  Returns
    (sched, watch, hist, done_tgt, done_stall, row), the row the eval's
    :data:`ROW_COLS` columns in the metrics' dtype, NaN where one does not
    apply.

    A NaN gap counts as +inf.  The target test and the guard's watch run
    in float64, as the chunked loop compares Python floats; the sched
    vector's slots in float32, op for op as the host twins.  On a target
    hit nothing acts (no backoff, restart, arm, bank push or Theta stage),
    as in JAX's device loop, while the watches' arithmetic still commits:
    only the sched vector left at the stop shows it."""
    gap = metrics[1]
    dt = metrics.dtype
    inf = float("inf")
    nan = torch.full_like(gap, float("nan"))
    tgt = -inf if lad.gap_target is None else float(lad.gap_target)
    done_tgt = gap.to(torch.float64) <= tgt
    going = torch.logical_not(done_tgt)
    done_stall = torch.zeros_like(done_tgt)
    gap_inf = torch.where(torch.isnan(gap), torch.full_like(gap, inf), gap)
    gv = gap_inf.to(torch.float32)
    backed = None
    if lad.anneal:
        best, best_prev, stall = _watch_update(torch, gv, sched[2], sched[3],
                                               sched[1], STALL_REL)
        stage = sched[0]
        backed = ((stall >= float(lad.stall_evals))
                  & (stage < lad.n_stages - 1) & going)
        fresh = torch.full_like(stage, inf)
        stage = torch.where(backed, stage + 1.0, stage)
        stall = torch.where(backed, torch.zeros_like(stall), stall)
        best = torch.where(backed, fresh, best)
        best_prev = torch.where(backed, fresh, best_prev)
        sched = torch.cat([torch.stack([stage, stall, best, best_prev]),
                           sched[4:]])
        extra = [stage.to(dt), stall.to(dt)]
    elif lad.guard:
        best, best_prev, stall = _watch_update(
            torch, gap_inf.to(torch.float64), watch[1], watch[2], watch[0],
            STALL_REL)
        done_stall = (stall >= lad.stall_evals) & going
        watch = (stall, best, best_prev)
        extra = [nan, stall.to(dt)]
    else:
        extra = [nan, torch.zeros_like(gap)]
    if lad.n_theta:
        def f32(v):
            return torch.full_like(gv, v)

        hl, rst, lg = sched[A_HIST], sched[A_RESTARTS], sched[A_LASTGAP]
        restart = (gv > lg) & going
        arm = (hl >= 2.0) & torch.logical_not(restart) & going
        rst = torch.where(restart, rst + 1.0, rst)
        hl = torch.where(done_tgt, hl, torch.where(
            arm, f32(0.0), torch.where(restart, f32(1.0),
                                       torch.minimum(hl + 1.0, f32(2.0)))))
        jmp = torch.where(arm, f32(1.0), f32(0.0))
        lg = torch.where(done_tgt, lg, gv)
        push = torch.logical_not(arm) & going
        th, th_stall = sched[A_TH_STAGE], sched[A_TH_STALL]
        th_best, th_prev = sched[A_TH_BEST], sched[A_TH_BPREV]
        if lad.n_theta > 1:
            th_best, th_prev, th_stall = _watch_update(
                torch, gv, th_best, th_prev, th_stall, THETA_REL)
            near = gv <= lad.near
            step = ((near | (th_stall >= float(THETA_EVALS)))
                    & (th < lad.n_theta - 1) & going)
            th = torch.where(step, torch.where(
                near, f32(lad.n_theta - 1), th + 1.0), th)
            th_stall = torch.where(step, f32(0.0), th_stall)
            th_best = torch.where(step, f32(inf), th_best)
            th_prev = torch.where(step, f32(inf), th_prev)
            hl = torch.where(step, torch.minimum(hl, f32(1.0)), hl)
        if backed is not None:
            # a sigma' backoff is a seam of the round map, as a Theta stage
            hl = torch.where(backed, torch.minimum(hl, f32(1.0)), hl)
        sched = torch.cat([sched[:SCHED_LEN], torch.stack(
            [hl, jmp, rst, lg, th, th_stall, th_best, th_prev])])
        hist = torch.where(push, torch.stack([hist[1], alpha]), hist)
        extra += [th.to(dt), rst.to(dt)]
    else:
        extra += [nan, nan]
    row = torch.cat([metrics, torch.stack(extra)])
    return sched, watch, hist, done_tgt, done_stall, row


# the device loop's super-blocks (cocoa_tpu/solvers/base.py:718-725): the
# (chunks, C, K, H) int32 host tables staged per super-block stay under
# MAX_IDX_TABLE_BYTES (tests shrink it), and a gap-targeted run whose
# tables come past SMALL_TABLE_INTS grows its blocks geometrically
MAX_IDX_TABLE_BYTES = 256 << 20
SMALL_TABLE_INTS = 4_000_000


def super_blocks(n_full: int, chunk_ints: int, gap_target,
                 max_chunks: Optional[int] = None) -> list:
    """The device loop's super-block sizes in chunks, for ``n_full``
    chunks of ``chunk_ints`` table ints each (cocoa_tpu/solvers/
    base.py:1302-1337): equal blocks under the table cap, or, for a
    gap-targeted run with large tables, blocks doubling from what
    SMALL_TABLE_INTS holds; none longer than ``max_chunks`` (a
    checkpointed run's ceil(chkptIter / debugIter), so a block boundary,
    where it saves, comes at least every chkptIter rounds)."""
    max_block = max(1, MAX_IDX_TABLE_BYTES // (4 * chunk_ints))
    if max_chunks is not None:
        max_block = min(max_block, max(1, max_chunks))
    if gap_target is None or n_full * chunk_ints <= SMALL_TABLE_INTS:
        n_blocks = -(-n_full // max_block)
        per_block = -(-n_full // n_blocks)
        g = per_block
    else:
        per_block = None
        g = max(1, SMALL_TABLE_INTS // chunk_ints)
    sizes = []
    remaining = n_full
    while remaining > 0:
        b = min(per_block or g, max_block, remaining)
        g = min(g * 2, max_block)
        sizes.append(b)
        remaining -= b
    return sizes


class _Buffers:
    """The device loop's state on its device: ``iterate``, ``hist`` (the
    accel bank) and ``sched``; ``t0`` the next chunk's first round, ``i``
    the chunks done in the super-block, ``live`` whether the next chunk
    commits, ``done_tgt`` and ``done_stall`` the stop flags, ``watch`` the
    guard's (stall, best, best_prev), ``runs`` the chunks done per branch,
    ``rows`` the super-block's eval rows and ``tabs`` its staged host
    tables (None with device tables)."""


class DeviceLoopRunner:
    """The device loop's chunks (``--deviceLoop``): each chunk of ``c``
    rounds (the eval cadence) is one step that runs the chunk, the eval
    ``metrics(iterate) -> (3,)`` and :func:`ladder_step` on the device,
    and writes the eval's row; a super-block of ``b`` chunks is up to
    ``b`` steps with no read of the device's results between them, then
    one fetch of the rows, the stop flags and the sched vector.

    Design B (PERF.md section 7): the torch on the card has no CUDA graph
    conditional nodes, so a step that is queued runs, and commits its
    writes only while ``live`` (``torch.where``).  Each step also copies
    ``live`` into a word of pinned host memory; the host keeps
    :data:`AHEAD` steps queued past the last one it has seen finish (a
    CUDA event), and stops queueing once that word says the run stopped,
    so at most ``AHEAD - 1`` steps replay dead after a stop.  A step runs
    one branch of the :class:`Schedule`; when the ladder moves the run to
    another branch it clears ``live``, and the host re-enters the
    super-block with that branch's step after a fetch.  On CUDA a
    branch's first step runs eagerly on the run's own buffers (loading
    the libraries and setting the kernels' attributes outside any
    capture), then is captured as one CUDA graph and replayed; a capture
    that fails raises.  Everything a step writes lies outside the graphs'
    pool.  On the CPU the steps run eagerly, the host reading ``live``
    after each.

    The wrappers' launch counts: the eager steps count as they run, the
    capture's are taken back, and each branch's captured launches are
    added once for every replay that ran live (``runs``), so dead replays
    do not count.

    ``ahead`` overrides :data:`AHEAD`.  A gang of more than one rank runs
    with 1: the host then reads the live word of the one step in flight,
    so every rank queues the same steps, dead ones too, and the ranks'
    all-reduces pair up (with 2 the count would depend on when the host
    looks)."""

    # steps queued on the card past the last one the host has seen finish
    AHEAD = 2

    def __init__(self, body: Callable, metrics: Callable, sampler, device,
                 c: int, ladder: Ladder, schedule: Optional[Schedule],
                 n_iterate: int, hist: bool, ahead: Optional[int] = None):
        self.body = body
        self.metrics = metrics
        self.sampler = sampler
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.c = c
        self.ladder = ladder
        self.schedule = schedule
        self.keys = [None] if schedule is None else schedule.keys
        self.n_iterate = n_iterate
        self.hist = hist
        self.draws = sampler is not None and sampler.device and self.cuda
        self.ahead = self.AHEAD if ahead is None else int(ahead)
        self.graphs = {}
        self.deltas = {}
        self.seconds = {}
        self.eager = [0] * len(self.keys)
        self.pool = None
        self.stream = None
        self.flag = None
        self.v = None
        self.sched = None
        self.steps = 0

    def enter(self, state: tuple, b_max: int) -> None:
        """Copy the run's state to the loop's buffers, for super-blocks of
        up to ``b_max`` chunks."""
        dev, n = self.device, self.n_iterate
        v = _Buffers()
        v.iterate = tuple(x.clone() for x in state[:n])
        v.hist = state[n].clone() if self.hist else None
        v.sched = None
        if self.schedule is not None:
            self.sched = np.asarray(state[-1], dtype=np.float32).copy()
            v.sched = torch.from_numpy(self.sched.copy()).to(dev)
        i64 = dict(dtype=torch.int64, device=dev)
        v.t0 = torch.zeros((), **i64)
        v.i = torch.zeros((), **i64)
        v.live = torch.zeros((), dtype=torch.bool, device=dev)
        v.done_tgt = torch.zeros((), dtype=torch.bool, device=dev)
        v.done_stall = torch.zeros((), dtype=torch.bool, device=dev)
        v.watch = None
        if self.ladder.guard:
            f64 = dict(dtype=torch.float64, device=dev)
            v.watch = (torch.zeros((), **i64), torch.zeros((), **f64),
                       torch.zeros((), **f64))
        v.runs = torch.zeros(len(self.keys), **i64)
        v.rows = torch.zeros((b_max, ROW_COLS), dtype=state[0].dtype,
                             device=dev)
        v.tabs = None
        if self.sampler is not None and not self.draws:
            v.tabs = torch.zeros((b_max, self.c, len(self.sampler.counts),
                                  self.sampler.h), dtype=torch.int32,
                                 device=dev)
        if self.cuda:
            self.flag = torch.zeros(1, dtype=torch.bool, pin_memory=True)
        self.v = v

    def leave(self) -> tuple:
        """The run's state after the last super-block: the iterate, the
        bank and the sched vector (numpy, as the chunked loop keeps it)."""
        v = self.v
        out = v.iterate + ((v.hist,) if self.hist else ())
        return out + ((self.sched.copy(),) if self.sched is not None else ())

    def snapshot(self) -> tuple:
        """The state at the last super-block's end, as :meth:`leave`
        orders it, copied to the host (owned numpy arrays; the sched
        vector is the one that block's fetch read), with the loop left
        where it is: its buffers hold only what live chunks committed, so
        a chunk replayed dead after a stop is not in it."""
        return tuple(checkpoint.host_array(x) if isinstance(x, torch.Tensor)
                     else x for x in self.leave())

    def block(self, start: int, b: int, traj: Trajectory):
        """Chunks from round ``start`` on, ``b`` of them unless the run
        stops: returns (rows (n, ROW_COLS) float64 numpy of the n chunks
        that ran, done_tgt, done_stall).  One fetch, and one more each
        time the run changes branch (``traj.fetches``)."""
        v, c = self.v, self.c
        if v.tabs is not None:
            host = self.sampler.chunk_indices(start, b * c)
            v.tabs[:b].copy_(host.reshape(b, c, *host.shape[1:]))
        v.t0.fill_(start)
        for buf in (v.i, v.runs, v.done_tgt, v.done_stall):
            buf.zero_()
        if v.watch is not None:
            v.watch[0].zero_()
            v.watch[1].fill_(float("inf"))
            v.watch[2].fill_(float("inf"))
        self.eager = [0] * len(self.keys)
        i = 0
        while True:
            k = 0 if self.schedule is None else self.schedule.index(
                self.sched, c)
            v.live.fill_(True)
            self.steps += self._steps(k, b - i)
            i, tgt, stall, runs, rows = self._fetch()
            traj.fetches += 1
            if tgt or stall or i >= b:
                break
        for k, n in enumerate(runs):
            n = int(n) - self.eager[k]
            if n and k in self.deltas:
                kernels.add_launches([n * d for d in self.deltas[k]])
        return rows[:i], tgt, stall

    def _steps(self, k: int, n: int) -> int:
        """Up to ``n`` steps on branch ``k``, ending once the device says
        the run stopped or left the branch; returns the steps queued."""
        v = self.v
        if not self.cuda:
            for j in range(n):
                self._step(k, v)
                if not bool(v.live):
                    return j + 1
            return n
        finished = []
        for j in range(n):
            if j >= self.ahead:
                # wait for step j - ahead, then read the live word it wrote
                finished[j - self.ahead].synchronize()
                if not bool(self.flag[0]):
                    return j
            graph = self.graphs.get(k)
            if graph is not None:
                graph.replay()
            else:
                self._step(k, v)
                self.eager[k] += 1
                self._capture(k)
            ev = torch.cuda.Event()
            ev.record()
            finished.append(ev)
        return n

    def _fetch(self):
        """The super-block's one read of the device: every counter, flag,
        the sched vector and the rows, packed into one float64 copy."""
        v = self.v
        parts = [v.i.view(1), v.done_tgt.view(1), v.done_stall.view(1),
                 v.runs]
        if v.sched is not None:
            parts.append(v.sched)
        parts.append(v.rows.reshape(-1))
        out = torch.cat([p.to(torch.float64) for p in parts]).cpu().numpy()
        nk = len(self.keys)
        runs = out[3:3 + nk].astype(np.int64)
        p = 3 + nk
        if v.sched is not None:
            self.sched = out[p:p + v.sched.numel()].astype(np.float32)
            p += v.sched.numel()
        return (int(out[0]), bool(out[1]), bool(out[2]), runs,
                out[p:].reshape(-1, ROW_COLS))

    def _capture(self, k: int) -> None:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        start = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            graph.capture_begin(self.pool)
            try:
                self._step(k, self.v)
            except BaseException:
                _end_failed_capture(graph)
                raise
            graph.capture_end()
        current.wait_stream(self.stream)
        self.seconds[(self.keys[k], self.c, "device loop")] = \
            time.perf_counter() - start
        after = kernels.launch_counts()
        self.deltas[k] = [b - a for a, b in zip(before, after)]
        kernels.add_launches([a - b for a, b in zip(before, after)])
        self.graphs[k] = graph

    def _step(self, k: int, v: _Buffers) -> None:
        """One chunk on branch ``k``: the jump an eval armed, the chunk,
        the eval and the ladder, each write committed only while
        ``v.live``; then ``live`` for the next chunk (cleared on a stop or
        a change of branch).  Device ops only."""
        c, live = self.c, v.live
        cur = v.iterate
        sched = None if v.sched is None else v.sched.clone()
        if self.schedule is not None and self.schedule.jump is not None:
            armed = sched[A_JUMP] > 0
            w, alpha = self.schedule.jump(cur[0], cur[1], v.hist)
            cur = (torch.where(armed, w, cur[0]),
                   torch.where(armed, alpha, cur[1]), *cur[2:])
            sched.select(0, A_JUMP).zero_()
        tables = None
        if self.draws:
            tables = self.sampler.draw(v.t0, c)
        elif v.tabs is not None:
            slot = v.i.clamp(max=v.tabs.shape[0] - 1).view(1)
            tables = v.tabs.index_select(0, slot)[0]
        out = self.body(self.keys[k], c, tables, v.t0, cur)
        for buf, x in zip(v.iterate, out):
            buf.copy_(torch.where(live, x, buf))
        v.t0.add_(live.to(torch.int64) * c)
        if sched is not None:
            sched.select(0, 4).add_(float(c))
        alpha = v.iterate[1] if self.hist else None
        sched, watch, hist, done_tgt, done_stall, row = ladder_step(
            self.ladder, self.metrics(v.iterate), sched, v.watch, v.hist,
            alpha)
        if sched is not None:
            v.sched.copy_(torch.where(live, sched, v.sched))
        if self.hist:
            v.hist.copy_(torch.where(live, hist, v.hist))
        if v.watch is not None:
            for buf, x in zip(v.watch, watch):
                buf.copy_(torch.where(live, x, buf))
        v.done_tgt.logical_or_(live & done_tgt)
        v.done_stall.logical_or_(live & done_stall)
        slot = v.i.clamp(max=v.rows.shape[0] - 1).view(1)
        v.rows.index_copy_(0, slot, torch.where(
            live, row, v.rows.index_select(0, slot)[0]).unsqueeze(0))
        v.runs.select(0, k).add_(live.to(torch.int64))
        v.i.add_(live.to(torch.int64))
        going = live & torch.logical_not(v.done_tgt | v.done_stall)
        if self.schedule is not None:
            going = going & (self.schedule.index(v.sched, c) == k)
        v.live.copy_(going)
        if self.flag is not None:
            self.flag.copy_(v.live.view(1), non_blocking=True)


def _fetch_metrics(traj: Trajectory, m: torch.Tensor):
    """An eval's (primal, gap or None, test_error or None) from the
    device's (3,) metrics: one fetch (``traj.fetches``)."""
    traj.fetches += 1
    return objectives.fetch_metrics(m)


def _run_chunk(runner: ChunkRunner, schedule: Optional[Schedule],
               n_iterate: int, t: int, c: int, state: tuple) -> tuple:
    """Rounds t..t+c-1 through ``runner``, the branch and an armed jump
    from the host's sched vector (:meth:`Schedule.head`)."""
    key = None
    if schedule is not None:
        key, state = schedule.head(c, state)
    return (*runner(key, t, c, state[:n_iterate]), *state[n_iterate:])


def drive(name: str, params: Params, debug: DebugParams, state: tuple,
          body: Callable, metrics: Callable, sampler, device, chunk: int,
          quiet: bool = False, start_round: int = 1,
          gap_target: Optional[float] = None, divergence_guard: bool = True,
          sigma_levels: Optional[tuple] = None,
          accel: Optional[AccelConfig] = None,
          schedule: Optional[Schedule] = None, n_iterate: int = 1,
          capture: Optional[bool] = None, device_loop: bool = False,
          mesh=None):
    """The outer loop (CoCoA.scala:39-63 skeleton, with the ladder of
    cocoa_tpu/solvers/base.py ``drive_chunked``).  Rounds run in chunks
    of up to ``chunk`` that end at each ``debugIter`` boundary; the first
    ``n_iterate`` entries of ``state`` are the device tensors the rounds
    advance, and the rest the accel bank (on the device) and the sched
    vector (on the host).  With a ``schedule`` the host picks each chunk's
    branch from the sched vector and takes an armed jump at its head
    (:meth:`Schedule.head`); then a :class:`ChunkRunner` runs ``body``
    over the chunk, on CUDA as a replayed CUDA graph unless ``capture`` is
    False.  The host reads the device only at the evaluations, one fetch
    of ``metrics(state) -> (3,)`` (primal, gap, test error; NaN where
    there is none).  The returned state owns its tensors (no graph writes
    them again); ``Trajectory.graphs`` has each graph's capture time and
    ``Trajectory.fetches`` the host's reads of the device.

    At an eval: ``gap <= gap_target`` stops the run (``stopped =
    "target"``); with ``divergence_guard`` and a target the stall watch
    bails out (``"diverged"``), unless ``sigma_levels`` has more than one
    rung: then the state's last entry is the sched vector, and the watch
    backs sigma' off a rung instead (:func:`sched_host_step`).  ``accel``
    runs :func:`accel_host_step` on the state (w, alpha, hist, sched).

    With ``debug.chkpt_dir`` the state is saved at every
    ``debug.chkpt_iter`` boundary (:func:`save_checkpoint`), where a chunk
    also ends, after that eval's ladder step; a run that stops at an eval
    does not save there.  A ``chkpt_iter`` that is a multiple of
    ``debugIter`` ends no chunk that an eval does not, so it adds no
    graph.

    ``device_loop`` runs the evals and the ladder on the device instead
    (:func:`drive_device`).

    ``mesh`` (parallel/mesh.py) is a gang's: ``body`` and ``metrics``
    all-reduce across its ranks, the checkpoints gather alpha, and on the
    card a gloo device group, whose collectives cannot be captured, runs
    the chunks eagerly (:func:`gang_capture`).  Returns (state,
    Trajectory)."""
    capture = gang_capture(capture, device, mesh)
    if device_loop:
        return drive_device(
            name, params, debug, state, body, metrics, sampler, device,
            quiet=quiet, start_round=start_round, gap_target=gap_target,
            divergence_guard=divergence_guard, sigma_levels=sigma_levels,
            accel=accel, schedule=schedule, n_iterate=n_iterate,
            capture=capture, mesh=mesh)
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    anneal = sigma_levels is not None and len(sigma_levels) > 1
    traj = Trajectory(name, quiet=quiet, device=device)
    runner = ChunkRunner(body, sampler, device, capture)
    traj.graphs = runner.seconds
    watch = _GapWatch(n_evals=stall_window(debug.debug_iter))
    t = start_round
    total = params.num_rounds
    di = debug.debug_iter
    ckpt_on = checkpoints_on(debug)
    ci = debug.chkpt_iter
    while t <= total:
        end = min(total, t + chunk - 1)
        if di > 0:
            end = min(end, ((t - 1) // di + 1) * di)
        if ckpt_on:
            end = min(end, ((t - 1) // ci + 1) * ci)
        with _tracing.span("local_solve", algorithm=name, round=end, t0=t,
                           rounds=end - t + 1):
            state = _run_chunk(runner, schedule, n_iterate, t, end - t + 1,
                               state)
        t = end + 1
        if not (di > 0 and end % di == 0):
            if ckpt_on and end % ci == 0:
                save_checkpoint(debug, name, end, state, n_iterate, accel,
                                traj, mesh)
            continue
        with _tracing.span("eval", algorithm=name, round=end):
            primal, gap, test_err = _fetch_metrics(traj, metrics(state))
        anneal_on = gap_target is not None and divergence_guard and anneal
        hit = gap_target is not None and gap is not None and gap <= gap_target
        sigma_val = stage = stall_v = None
        backed = False
        if anneal_on:
            if hit:
                # the run ends here and the schedule is not advanced; the
                # stall counter logged is the watch's, previewed
                s = state[-1]
                _, _, stl = _watch_update(np, _gap32(gap), s[2], s[3], s[1],
                                          np.float32(STALL_REL))
                stage, stall_v = int(s[0]), int(stl)
            else:
                sched, backed = sched_host_step(state[-1], gap, watch.n,
                                                len(sigma_levels))
                state = (*state[:-1], sched)
                stage, stall_v = int(sched[0]), int(sched[1])
            sigma_val = sigma_levels[stage]
        if accel is not None and not hit:
            sched, restarted, staged = accel_host_step(
                state[-1], gap, accel.n_theta, gap_target, seam=backed)
            state = _accel_replace(state, sched)
            _emit_accel_events(name, end, restarted, sched[A_RESTARTS],
                               staged, sched[A_TH_STAGE], accel, quiet)
        traj.log_round(end, primal=primal, gap=gap, test_error=test_err,
                       sigma=sigma_val, sigma_stage=stage, stall=stall_v)
        if backed:
            _emit_backoff(name, watch.n, sigma_levels, stage, end, quiet)
        if hit:
            traj.stopped = "target"
            break
        if (not anneal_on and gap_target is not None and divergence_guard
                and watch.update(gap)):
            traj.mark_diverged(end, watch.n)
            break
        if ckpt_on and end % ci == 0:
            save_checkpoint(debug, name, end, state, n_iterate, accel, traj,
                            mesh)
    if runner.capture:
        state = (*(x.clone() for x in state[:n_iterate]),
                 *state[n_iterate:])
    return state, traj


def _emit_backoff(name, n_evals, sigma_levels, stage, t, quiet):
    """One sigma' backoff at a host eval: the ``sigma_backoff`` event
    (emitted whatever ``quiet`` says; the host step moves one rung) and
    its console line, as the JAX package's ``_emit_backoff``."""
    _events.get_bus().emit(
        "sigma_backoff", algorithm=name, t=int(t),
        sigma=sigma_levels[stage], from_sigma=sigma_levels[stage - 1],
        stage=int(stage))
    if not quiet:
        print(f"{name}: σ′ anneal — gap stalled for {n_evals} evals; "
              f"backing off to σ′={sigma_levels[stage]:g} at round {t} "
              f"(iterate kept, certificate exact)")


def drive_device(name: str, params: Params, debug: DebugParams,
                 state: tuple, body: Callable, metrics: Callable, sampler,
                 device, quiet: bool = False, start_round: int = 1,
                 gap_target: Optional[float] = None,
                 divergence_guard: bool = True,
                 sigma_levels: Optional[tuple] = None,
                 accel: Optional[AccelConfig] = None,
                 schedule: Optional[Schedule] = None, n_iterate: int = 1,
                 capture: Optional[bool] = None, mesh=None):
    """The device-resident run (``--deviceLoop``; cocoa_tpu/solvers/
    base.py ``drive_device_full`` and ``drive_on_device``), arguments as
    :func:`drive`: the rounds up to the first ``debugIter`` boundary (an
    off-cadence ``start_round``) run as one chunk with the host's eval and
    ladder, every full cadence chunk after it in super-blocks on the
    device (:class:`DeviceLoopRunner`, sized by :func:`super_blocks`), and
    the sub-cadence tail as one chunk with no eval.  The host reads the
    device once a super-block (and once more each time the run changes
    branch), and decodes the rows as JAX does: ``wall_time`` None but on
    each super-block's last record, the time of its fetch; the sigma'
    backoffs the rows show within a super-block printed; and ``stopped``
    from the device's stop flags, the guard's host watch running over the
    records across super-blocks as in JAX (under the anneal, the sched
    vector carries the watch instead).  On CUDA the device loop's chunks
    are captured CUDA graphs: ``capture=False`` is refused.  The
    Trajectory's ``dead_chunks`` counts the chunk steps replayed after a
    stop or a change of branch.

    With ``debug.chkpt_dir`` the state is saved as JAX's ``maybe_ckpt``
    saves it (cocoa_tpu/solvers/base.py:1195-1247): after the head, after
    each super-block at the round it actually reached, and after the
    tail, whenever ``chkpt_iter`` rounds have passed since the last save;
    the super-blocks are then capped at ceil(chkptIter / debugIter)
    chunks, so the saves land at the first super-block boundary at or
    past each ``chkpt_iter`` multiple."""
    c = debug.debug_iter
    if c <= 0:
        raise ValueError("the device loop requires debug_iter > 0 (the eval "
                         "cadence is its chunk axis)")
    if torch.device(device).type == "cuda" and capture is False:
        if mesh is not None and not mesh.capturable:
            raise ValueError(GLOO_DEVICE_LOOP)
        raise ValueError("the device loop runs as captured CUDA graphs on "
                         "the card; capture=False is the chunked loop's")
    anneal = (sigma_levels is not None and len(sigma_levels) > 1
              and gap_target is not None and divergence_guard)
    traj = Trajectory(name, quiet=quiet, device=device)
    chunks = ChunkRunner(body, sampler, device, capture)
    traj.graphs = chunks.seconds
    watch = _GapWatch(n_evals=stall_window(c))
    total = params.num_rounds
    ckpt_on = checkpoints_on(debug)
    last_saved = start_round - 1

    def maybe_ckpt(done_round, get_state):
        nonlocal last_saved
        if ckpt_on and done_round - last_saved >= debug.chkpt_iter:
            save_checkpoint(debug, name, done_round, get_state(), n_iterate,
                            accel, traj, mesh)
            last_saved = done_round

    def hit_target():
        return (gap_target is not None and traj.records
                and traj.records[-1].gap is not None
                and traj.records[-1].gap <= gap_target)

    t = start_round
    head_end = min(total, ((t - 1) // c + 1) * c)
    if (t - 1) % c != 0 and head_end >= t:
        with _tracing.span("local_solve", algorithm=name, round=head_end,
                           t0=t, rounds=head_end - t + 1):
            state = _run_chunk(chunks, schedule, n_iterate, t,
                               head_end - t + 1, state)
        t = head_end + 1
        if head_end % c == 0:
            with _tracing.span("eval", algorithm=name, round=head_end):
                primal, gap, test_err = _fetch_metrics(traj, metrics(state))
            sigma_val = stage = stall_v = None
            backed = False
            hit = (gap_target is not None and gap is not None
                   and gap <= gap_target)
            if anneal:
                sched, backed = sched_host_step(state[-1], gap, watch.n,
                                                len(sigma_levels))
                state = (*state[:-1], sched)
                stage, stall_v = int(sched[0]), int(sched[1])
                sigma_val = sigma_levels[stage]
            else:
                watch.update(gap)
            if accel is not None and not hit:
                sched, restarted, staged = accel_host_step(
                    state[-1], gap, accel.n_theta, gap_target, seam=backed)
                state = _accel_replace(state, sched)
                _emit_accel_events(name, head_end, restarted,
                                   sched[A_RESTARTS], staged,
                                   sched[A_TH_STAGE], accel, quiet)
            traj.log_round(head_end, primal=primal, gap=gap,
                           test_error=test_err, sigma=sigma_val,
                           sigma_stage=stage, stall=stall_v)
            if backed:
                _emit_backoff(name, watch.n, sigma_levels, stage, head_end,
                              quiet)
        maybe_ckpt(head_end, lambda: state)

    n_full = max(0, (total - (t - 1)) // c)
    if n_full > 0 and not hit_target():
        ints = 1 if sampler is None else sampler.ints_per_round()
        sizes = super_blocks(
            n_full, c * ints, gap_target,
            -(-debug.chkpt_iter // c) if ckpt_on else None)
        loop = DeviceLoopRunner(
            body, metrics, sampler, device, c,
            Ladder(gap_target, divergence_guard,
                   len(sigma_levels) if sigma_levels is not None else 0,
                   watch.n, accel.n_theta if accel is not None else 0),
            schedule, n_iterate, accel is not None,
            ahead=1 if mesh is not None and mesh.size > 1 else None)
        loop.enter(state, max(sizes))
        done = t - 1
        start = t
        # one tap for the run, seeded from the host's sched vector; it
        # carries the stage, Theta stage and restarts of each super-block's
        # last row into the next
        tap = _events.DeviceTap(
            _events.get_bus(), name, start, c,
            sigma_levels if anneal else None,
            theta_hs=accel.theta_hs if accel is not None else None,
            **_tap_seeds(state[-1] if schedule is not None else None,
                         anneal, accel))
        for b in sizes:
            # the super-block: its chunks queued and its one fetch (the
            # finest local-solve timing the device loop can report)
            with _tracing.span("local_solve", algorithm=name, t0=start,
                               round=start - 1 + b * c, rounds=b * c,
                               cadence=c):
                rows, _, stop_stall = loop.block(start, b, traj)
            tap.start_round = start
            new = _decode_rows(traj, name, rows, start, c,
                               sigma_levels if anneal else None, quiet, tap)
            if new:
                # the super-block's fetch: its last record's time
                new[-1].wall_time = traj.elapsed()
            done = start - 1 + len(rows) * c
            start += b * c
            maybe_ckpt(done, loop.snapshot)
            if hit_target():
                traj.stopped = "target"
                break
            diverged = not anneal and divergence_guard and (
                stop_stall or any(watch.update(r.gap) for r in new))
            if gap_target is not None and diverged:
                traj.mark_diverged(done, watch.n)
                break
        state = loop.leave()
        traj.graphs.update(loop.seconds)
        traj.dead_chunks = loop.steps - (done - (t - 1)) // c
        t = done + 1

    rem = total - (t - 1)
    if rem > 0 and not hit_target() and traj.stopped is None:
        with _tracing.span("local_solve", algorithm=name, round=total, t0=t,
                           rounds=rem):
            state = _run_chunk(chunks, schedule, n_iterate, t, rem, state)
        maybe_ckpt(total, lambda: state)
    if chunks.capture:
        state = (*(x.clone() for x in state[:n_iterate]),
                 *state[n_iterate:])
    return state, traj


def _tap_seeds(sched, anneal: bool, accel) -> dict:
    """A :class:`~cocoa_torch.telemetry.events.DeviceTap`'s seeds from the
    host's sched vector (None without one)."""
    out = dict(init_stage=None, init_theta_stage=None, init_restarts=None)
    if sched is None:
        return out
    if anneal:
        out["init_stage"] = int(sched[0])
    if accel is not None:
        out["init_theta_stage"] = int(sched[A_TH_STAGE])
        out["init_restarts"] = int(sched[A_RESTARTS])
    return out


def _decode_rows(traj: Trajectory, name: str, rows, start: int, c: int,
                 levels: Optional[tuple], quiet: bool, tap) -> list:
    """A super-block's rows as records, as JAX's ``drive_on_device``
    decodes them: round ``start - 1 + (j + 1) * c`` for row j, NaN gap and
    test error as None, no wall time; under the anneal (``levels``) the
    stage and stall columns, and a line for each change of sigma' between
    two rows of the super-block.  The rows are first replayed through
    ``tap``, which emits their events (JAX's fetch-fallback bridge), and
    the records are logged without one.  Returns the new records."""
    for j, row in enumerate(rows):
        tap(j, row)
    prev = None
    out = []
    for j, row in enumerate(rows):
        end = start - 1 + (j + 1) * c
        primal, gap, err = (float(x) for x in row[:3])
        sigma = stage = stall = None
        if levels is not None:
            stage, stall = int(row[3]), int(row[4])
            sigma = levels[stage]
        traj.log_round(end, primal=primal,
                       gap=None if math.isnan(gap) else gap,
                       test_error=None if math.isnan(err) else err,
                       sigma=sigma, sigma_stage=stage, stall=stall,
                       wall_time=None, emit=False)
        if (not quiet and levels is not None and prev is not None
                and sigma != prev):
            print(f"{name}: σ′ anneal — backed off to σ′={sigma:g} in the "
                  f"device loop at round {end} (iterate kept, certificate "
                  f"exact)")
        prev = sigma
        out.append(traj.records[-1])
    return out


# --- the fleet's device loop (--fleet; cocoa_tpu/solvers/base.py:1685-2030)
#
# T independent tenants run as one loop: every state leaf carries a
# leading T axis, and one step runs a chunk of rounds for every lane,
# each lane's eval, and each lane's watch, sigma' anneal and accel
# bookkeeping.  A tenant that certifies (or stalls out) is masked: the
# step still computes its lane, and a lane-wise ``torch.where`` keeps its
# (w, alpha, hist, sched) bit for bit from that eval on.  The step is
# captured as one CUDA graph on the card and replayed (design B, as
# :class:`DeviceLoopRunner`: the torch on the card has no conditional
# nodes), its writes committed only while some lane is live; the host
# stops queueing once a pinned live word says every lane is done, and
# reads the card once at the end of the run.

FLEET_N_COLS = 7   # the solo row layout (ROW_COLS), per tenant


class FleetCarry:
    """The per-tenant watch vectors on the device: the stop flags, the
    guard's stall count and its float64 bests, and the 1-based eval each
    lane certified or stalled out at (0: never), from which the host
    decodes each eval's active lanes and each tenant's outcome."""

    def __init__(self, done_tgt, done_stall, stall, best, best_prev,
                 cert_chunk, stall_chunk):
        self.done_tgt = done_tgt
        self.done_stall = done_stall
        self.stall = stall
        self.best = best
        self.best_prev = best_prev
        self.cert_chunk = cert_chunk
        self.stall_chunk = stall_chunk

    @classmethod
    def init(cls, t: int, device) -> "FleetCarry":
        i64 = dict(dtype=torch.int64, device=device)
        f64 = dict(dtype=torch.float64, device=device)
        return cls(torch.zeros(t, dtype=torch.bool, device=device),
                   torch.zeros(t, dtype=torch.bool, device=device),
                   torch.zeros(t, **i64),
                   torch.full((t,), math.inf, **f64),
                   torch.full((t,), math.inf, **f64),
                   torch.zeros(t, **i64), torch.zeros(t, **i64))

    def tensors(self) -> tuple:
        return (self.done_tgt, self.done_stall, self.stall, self.best,
                self.best_prev, self.cert_chunk, self.stall_chunk)


def _lane(flag: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (T,) lane flag shaped to broadcast against ``like`` (T, ...)."""
    return flag.reshape(flag.shape + (1,) * (like.dim() - 1))


class FleetLadder:
    """The fleet step's static configuration, as JAX's
    ``_build_fleet_run`` derives it: the anneal's stages (> 1 arms it,
    with the guard on), the guard's watch otherwise, and the accel
    bookkeeping (the fixed-Theta ladder)."""

    def __init__(self, gap_targets: torch.Tensor, stall_evals: int,
                 divergence_guard: bool, n_stages: int, accel: bool):
        self.tgt = gap_targets              # (T,) float64, -inf = none
        self.stall_evals = stall_evals
        self.anneal = divergence_guard and n_stages > 1
        self.guard = divergence_guard and not self.anneal
        self.n_stages = n_stages
        self.accel = accel


def fleet_ladder_step(lad: FleetLadder, metrics, state: tuple,
                      carry: FleetCarry, done0, i):
    """One eval's per-tenant ladder on the device: the solo device loop's
    target test, guard watch, sigma' anneal and accel bookkeeping
    (:func:`ladder_step`) with every scalar a (T,) column, each frozen
    for a lane that was done before this eval (``done0``), as JAX's fleet
    body does (cocoa_tpu/solvers/base.py:1800-1917).  ``i`` is the 0-d
    chunk counter.  Returns (state, carry, row (T, FLEET_N_COLS)); the
    target test and the guard's watch in float64 as the solo loop's,
    the sched vector's slots in float32."""
    gap = metrics[:, 1]
    dt = metrics.dtype
    hit = gap.to(torch.float64) <= lad.tgt
    done_now = hit | done0
    newly = hit & torch.logical_not(done0)
    not_now = torch.logical_not(done_now)
    nans = torch.full_like(gap, math.nan)
    gv = torch.where(torch.isnan(gap), torch.full_like(gap, math.inf),
                     gap)
    gv32 = gv.to(torch.float32)
    done_tgt, done_stall, stall, best, best_prev, cert, stall_chunk = \
        carry.tensors()
    step = (i + 1).to(torch.int64)
    if lad.anneal:
        sched = state[-1]
        stg = sched[:, 0]
        bst, bpv, stl = _watch_update(torch, gv32, sched[:, 2], sched[:, 3],
                                      sched[:, 1], STALL_REL)
        bo = ((stl >= float(lad.stall_evals)) & (stg < lad.n_stages - 1)
              & not_now)
        inf = torch.full_like(bst, math.inf)
        stg = torch.where(bo, stg + 1.0, stg)
        stl = torch.where(bo, torch.zeros_like(stl), stl)
        bst = torch.where(bo, inf, bst)
        bpv = torch.where(bo, inf, bpv)
        head = torch.stack([stg, stl, bst, bpv, sched[:, 4]], dim=1)
        state = (*state[:-1], torch.where(done0[:, None], sched, head))
        extra = [stg.to(dt), stl.to(dt)]
    elif lad.guard:
        bst, bpv, stl = _watch_update(torch, gv.to(torch.float64), best,
                                      best_prev, stall, STALL_REL)
        best = torch.where(done0, best, bst)
        best_prev = torch.where(done0, best_prev, bpv)
        stall = torch.where(done0, stall, stl)
        newly_stalled = ((stall >= lad.stall_evals) & (lad.tgt > -math.inf)
                         & not_now & torch.logical_not(done_stall))
        done_stall = done_stall | newly_stalled
        stall_chunk = torch.where(newly_stalled, step, stall_chunk)
        extra = [nans, stall.to(dt)]
    else:
        extra = [nans, torch.zeros_like(gap)]
    if lad.accel:
        w, alpha, hist, sched = state
        hl, rst, lg = (sched[:, A_HIST], sched[:, A_RESTARTS],
                       sched[:, A_LASTGAP])
        one, zero = torch.ones_like(hl), torch.zeros_like(hl)
        restart = (gv32 > lg) & not_now
        arm = (hl >= 2.0) & torch.logical_not(restart) & not_now
        rst = torch.where(restart, rst + 1.0, rst)
        hl = torch.where(done_now, hl, torch.where(
            arm, zero, torch.where(restart, one,
                                   torch.minimum(hl + 1.0, 2.0 * one))))
        jmp = torch.where(arm, one, zero)
        lg = torch.where(done_now, lg, gv32)
        push = torch.logical_not(arm) & not_now
        tail = torch.stack([hl, jmp, rst, lg, sched[:, A_TH_STAGE],
                            sched[:, A_TH_STALL], sched[:, A_TH_BEST],
                            sched[:, A_TH_BPREV]], dim=1)
        hist = torch.where(_lane(push, hist),
                           torch.stack([hist[:, 1], alpha], dim=1), hist)
        state = (w, alpha, hist,
                 torch.cat([sched[:, :SCHED_LEN], tail], dim=1))
        extra += [sched[:, A_TH_STAGE].to(dt), rst.to(dt)]
    else:
        extra += [nans, nans]
    done_tgt = done_tgt | newly
    cert = torch.where(newly, step, cert)
    row = torch.stack([metrics[:, 0], metrics[:, 1], metrics[:, 2],
                       *extra], dim=1)
    return state, FleetCarry(done_tgt, done_stall, stall, best, best_prev,
                             cert, stall_chunk), row


class FleetRunner:
    """The fleet's loop on its device: one step a chunk of ``c`` rounds,
    ``step_fn(state, tables) -> (head, state)`` for every lane (``head``
    the state after an accelerated run's jump at the chunk's head, else
    the state given, and the state after the chunk), then ``eval_fn(state) ->
    (T, 3)`` and :func:`fleet_ladder_step`, the eval's row written at the
    device's chunk counter, every write committed only while ``live``
    (some lane not done, chunks left).

    On CUDA the first step runs eagerly on the loop's own buffers, then is
    captured as one CUDA graph (``graphs``: its capture seconds by
    ``key``) and replayed; the host keeps :data:`AHEAD` steps queued past
    the last it has seen finish and stops once the pinned live word says
    the run stopped, so at most ``AHEAD - 1`` steps replay dead
    (``dead``), and they change no bit and write no row; ``replay_ms`` is
    the device time of a replayed step, dead ones included.  A capture
    that fails raises.  On the CPU the steps run eagerly, the host reading
    ``live`` after each."""

    AHEAD = DeviceLoopRunner.AHEAD

    def __init__(self, step_fn: Callable, eval_fn: Callable,
                 ladder: FleetLadder, tables: torch.Tensor, state: tuple,
                 key):
        self.step_fn = step_fn
        self.eval_fn = eval_fn
        self.ladder = ladder
        dev = state[0].device
        self.device = dev
        cuda = dev.type == "cuda"
        self.key = key
        self.tabs = tables.to(dev)
        self.n_chunks = int(tables.shape[0])
        t = int(state[0].shape[0])
        self.state = tuple(x.clone() for x in state)
        self.carry = FleetCarry.init(t, dev)
        self.i = torch.zeros((), dtype=torch.int64, device=dev)
        self.live = torch.ones((), dtype=torch.bool, device=dev)
        self.rows = torch.full((self.n_chunks, t, FLEET_N_COLS), math.nan,
                               dtype=state[0].dtype, device=dev)
        self.flag = (torch.ones(1, dtype=torch.bool, pin_memory=True)
                     if cuda else None)
        self.graphs = {}
        self.steps = 0
        self.dead = 0
        # CUDA events around the replays (after the eager step and the
        # capture): their device time a replayed step, ``replay_ms``
        self._marks = None
        self.replay_ms = None

    def _step(self) -> None:
        """One chunk for every lane, its evals and ladder; device ops
        only."""
        live, i = self.live, self.i
        carry = self.carry
        done0 = carry.done_tgt | carry.done_stall
        tables = self.tabs.index_select(
            0, i.clamp(max=self.n_chunks - 1).view(1))[0]
        cur, new = self.step_fn(self.state, tables)
        # a done lane's whole state stays as it was, bit for bit
        state = tuple(torch.where(_lane(done0, nw), o, nw)
                      for o, nw in zip(cur, new))
        metrics = self.eval_fn(state)
        state, carry2, row = fleet_ladder_step(self.ladder, metrics, state,
                                               carry, done0, i)
        for buf, x in zip(self.state, state):
            buf.copy_(torch.where(live, x, buf))
        for buf, x in zip(carry.tensors(), carry2.tensors()):
            buf.copy_(torch.where(live, x, buf))
        slot = i.clamp(max=self.n_chunks - 1).view(1)
        self.rows.index_copy_(0, slot, torch.where(
            live, row, self.rows.index_select(0, slot)[0]).unsqueeze(0))
        i.add_(live.to(torch.int64))
        done = carry.done_tgt | carry.done_stall
        live.copy_(live & torch.logical_not(done.all())
                   & (i < self.n_chunks))
        if self.flag is not None:
            self.flag.copy_(live.view(1), non_blocking=True)

    def run(self) -> None:
        """Every chunk the run needs, queued as described above."""
        if self.flag is None:
            for _ in range(self.n_chunks):
                self._step()
                self.steps += 1
                if not bool(self.live):
                    break
            return
        graph = None
        finished = []
        for j in range(self.n_chunks):
            if j >= self.AHEAD:
                # wait for step j - AHEAD, then read the live word it wrote
                finished[j - self.AHEAD].synchronize()
                if not bool(self.flag[0]):
                    break
            if graph is None:
                self._step()
                graph = self._capture()
                self._marks = [torch.cuda.Event(enable_timing=True)
                               for _ in range(2)]
                self._marks[0].record()
            else:
                graph.replay()
            self.steps += 1
            ev = torch.cuda.Event()
            ev.record()
            finished.append(ev)
        if self._marks is not None:
            self._marks[1].record()

    def _capture(self):
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        start = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            graph.capture_begin(pool)
            try:
                self._step()
            except BaseException:
                _end_failed_capture(graph)
                raise
            graph.capture_end()
        current.wait_stream(stream)
        self.graphs[self.key] = time.perf_counter() - start
        return graph

    def fetch(self):
        """The run's two reads of the device (``host_transfer`` events
        ``fleet_loop_fetch`` and ``fleet_result_fetch``): the chunks done
        and their rows ((n_done, T, FLEET_N_COLS) float64), then the stop
        flags and the certifying and stalling evals, as numpy."""
        t = self.rows.shape[1]
        out = _events.host_fetch(torch.cat([
            self.i.view(1).to(torch.float64),
            self.rows.reshape(-1).to(torch.float64)]), "fleet_loop_fetch")
        n_done = int(out[0])
        rows = out[1:].reshape(self.n_chunks, t, FLEET_N_COLS)[:n_done]
        self.dead = self.steps - n_done
        if self._marks is not None and self.steps > 1:
            self.replay_ms = (self._marks[0].elapsed_time(self._marks[1])
                              / (self.steps - 1))
        c = self.carry
        res = _events.host_fetch(torch.stack([
            c.done_tgt.to(torch.int64), c.done_stall.to(torch.int64),
            c.cert_chunk, c.stall_chunk]), "fleet_result_fetch")
        return (n_done, rows, res[0].astype(bool), res[1].astype(bool),
                res[2], res[3])


def drive_fleet_on_device(name: str, state: tuple, step_fn: Callable,
                          eval_fn: Callable, tables: torch.Tensor,
                          gap_targets: np.ndarray, start_round: int = 1,
                          stall_evals: int = STALL_EVALS,
                          divergence_guard: bool = True, n_stages: int = 0,
                          accel: bool = False, key=None):
    """Run a whole fleet (cocoa_tpu/solvers/base.py
    ``drive_fleet_on_device``): every chunk, every per-tenant eval, the
    per-tenant anneal, accel and gap watch and the all-lanes-done stop on
    the device (:class:`FleetRunner`), inside one ``local_solve`` span,
    then the run's fetch.  ``tables`` is the run's (n_chunks, C, ...)
    int32 draws, ``gap_targets`` (T,) float64 with NaN for none.  Returns
    (runner, n_done, rows, done_tgt, done_stall, cert_chunk,
    stall_chunk), the runner holding the final state (``state``), the
    capture seconds (``graphs``) and the dead replays (``dead``)."""
    dev = state[0].device
    tgt = torch.as_tensor(np.where(np.isnan(gap_targets), -np.inf,
                                   gap_targets), dtype=torch.float64,
                          device=dev)
    ladder = FleetLadder(tgt, stall_evals, divergence_guard, n_stages,
                         accel)
    runner = FleetRunner(step_fn, eval_fn, ladder, tables, state, key)
    n_chunks, c = int(tables.shape[0]), int(tables.shape[1])
    with _tracing.span("local_solve", algorithm=name, t0=start_round,
                       round=start_round - 1 + n_chunks * c,
                       rounds=n_chunks * c, cadence=c,
                       tenants=int(state[0].shape[0])):
        runner.run()
        out = runner.fetch()
    return (runner, *out)
