"""Shared solver machinery (counterpart of parts of
cocoa_tpu/solvers/base.py): the shard check, the index sampler (host
tables), the chunk size, and the chunked round loop with the JAX
host-stepped driver's ladder (``drive_chunked``): the gap-target stop, the
divergence guard's stall watch, the sigma' anneal schedule and the
accelerated outer loop's window bookkeeping.

The schedule state is the JAX package's float32 sched vector, kept here as
a numpy array on the host: the host picks each chunk's branch from it, so
no device read is added to the one fetch per eval."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from cocoa_torch.config import DebugParams, Params
from cocoa_torch.data.sharding import ShardedDataset
from cocoa_torch.utils import prng
from cocoa_torch.utils.logging import Trajectory


def check_shards(ds: ShardedDataset) -> None:
    """Reject empty shards up front (the reference crashes inside the task
    on ``nextInt(0)`` when numSplits > rows)."""
    if np.any(ds.counts <= 0):
        raise ValueError(
            f"every shard needs at least one example; shard sizes are "
            f"{ds.counts.tolist()} (n={ds.n} over K={ds.k} shards) -- "
            f"lower numSplits")


class IndexSampler:
    """Per-round local-coordinate draws, (C, K, H) int32 tables built on
    the host for a chunk of rounds (see utils/prng.py for the modes)."""

    MODES = ("reference", "jax", "permuted")

    def __init__(self, mode: str, seed: int, h: int, counts):
        if mode not in self.MODES:
            raise ValueError(
                f"rng mode must be one of {self.MODES}, got {mode!r}")
        self.mode = mode
        self.seed = seed
        self.h = h
        self.counts = np.asarray(counts)
        if np.any(self.counts <= 0):
            raise ValueError(
                f"all shards must be non-empty, got sizes {self.counts}")

    def chunk_indices(self, t0: int, c: int) -> torch.Tensor:
        """Tables for rounds t0..t0+c-1 (1-based, as the reference)."""
        if self.mode == "reference":
            tab = prng.sample_indices_per_shard(
                self.seed, range(t0, t0 + c), self.h, self.counts)
            return torch.from_numpy(np.ascontiguousarray(
                np.swapaxes(tab, 0, 1)))
        ts = torch.arange(t0, t0 + c, dtype=torch.int64)
        if self.mode == "permuted":
            return prng.permuted_tables(self.seed, ts, self.h, self.counts)
        return prng.hash_tables(self.seed, ts, self.h, self.counts)

    def round_indices(self, t: int) -> torch.Tensor:
        return self.chunk_indices(t, 1)[0]


def chunk_rounds(debug: DebugParams, k: int, h: int) -> int:
    """Rounds per chunk: a chunk ends at each eval, and is capped so one
    chunk's (C, K, H) table stays modest when debugIter is large."""
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
    stall watch (here numpy only; ``rel`` at the comparison's dtype).
    Returns (best, best_prev, stall)."""
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


def _emit_accel_events(name, t, restarted, staged, stage, accel, quiet):
    """The console half of the JAX package's momentum-restart and
    Theta-stage events."""
    if quiet:
        return
    if restarted:
        print(f"{name}: momentum restart at round {t} (gap rose; "
              f"secant window bank discarded)")
    if staged:
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


def per_round(round_fn: Callable[[tuple, torch.Tensor, int], tuple]):
    """A chunk function (see :func:`drive`) that runs ``round_fn(state,
    idxs_kh, t)`` over the chunk's tables, one round each."""
    def chunk_fn(t0, tables, state):
        for r, idxs_kh in enumerate(tables, start=t0):
            state = round_fn(state, idxs_kh, r)
        return state
    return chunk_fn


def drive(name: str, params: Params, debug: DebugParams, state: tuple,
          chunk_fn: Callable[[int, object, tuple], tuple],
          eval_fn: Callable[[tuple], tuple], sampler, device, chunk: int,
          quiet: bool = False, start_round: int = 1,
          gap_target: Optional[float] = None, divergence_guard: bool = True,
          sigma_levels: Optional[tuple] = None,
          accel: Optional[AccelConfig] = None):
    """The outer loop (CoCoA.scala:39-63 skeleton, with the ladder of
    cocoa_tpu/solvers/base.py ``drive_chunked``).  Rounds run in chunks
    that end at each ``debugIter`` boundary: a chunk's (C, K, H) index
    table is built on the host and copied to ``device`` once, and
    ``chunk_fn(t0, tables, state) -> state`` runs its rounds (``tables``
    a list of None when ``sampler`` is None, for a solver without draws);
    the host reads the device only at the evaluations, ``eval_fn(state)
    -> (primal, gap, test_error)``.

    At an eval: ``gap <= gap_target`` stops the run (``stopped =
    "target"``); with ``divergence_guard`` and a target the stall watch
    bails out (``"diverged"``), unless ``sigma_levels`` has more than one
    rung: then the state's last entry is the sched vector, and the watch
    backs sigma' off a rung instead (:func:`sched_host_step`).  ``accel``
    runs :func:`accel_host_step` on the state (w, alpha, hist, sched).
    Returns (state, Trajectory)."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    anneal = sigma_levels is not None and len(sigma_levels) > 1
    traj = Trajectory(name, quiet=quiet, device=device)
    watch = _GapWatch(n_evals=stall_window(debug.debug_iter))
    t = start_round
    total = params.num_rounds
    di = debug.debug_iter
    while t <= total:
        end = min(total, t + chunk - 1)
        if di > 0:
            end = min(end, ((t - 1) // di + 1) * di)
        tables = ([None] * (end - t + 1) if sampler is None
                  else sampler.chunk_indices(t, end - t + 1).to(device))
        state = chunk_fn(t, tables, state)
        t = end + 1
        if not (di > 0 and end % di == 0):
            continue
        primal, gap, test_err = eval_fn(state)
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
            _emit_accel_events(name, end, restarted, staged,
                               sched[A_TH_STAGE], accel, quiet)
        traj.log_round(end, primal=primal, gap=gap, test_error=test_err,
                       sigma=sigma_val, sigma_stage=stage, stall=stall_v)
        if backed and not quiet:
            print(f"{name}: σ′ anneal — gap stalled for {watch.n} evals; "
                  f"backing off to σ′={sigma_levels[stage]:g} at round "
                  f"{end} (iterate kept, certificate exact)")
        if hit:
            traj.stopped = "target"
            break
        if (not anneal_on and gap_target is not None and divergence_guard
                and watch.update(gap)):
            traj.mark_diverged(end, watch.n)
            break
    return state, traj
