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
device twin of the host steps) and reads it back once a super-block."""

from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from cocoa_torch import kernels
from cocoa_torch.config import DebugParams, Params
from cocoa_torch.data.sharding import ShardedDataset
from cocoa_torch.evals import objectives
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
    """Per-round local-coordinate draws, (C, K, H) int32 tables for a
    chunk of rounds (see utils/prng.py for the modes).  With ``device``
    (``--sampling``, :func:`resolve_sampling`) a chunk makes its tables
    where its first round lies, :meth:`draw`: on the card, one launch of
    the draw kernel inside the captured chunk; without it the host builds
    them, :meth:`chunk_indices`, and the chunk copies them over.  Both are
    the same tables bit for bit."""

    MODES = prng.MODES

    def __init__(self, mode: str, seed: int, h: int, counts,
                 device: bool = False):
        if mode not in self.MODES:
            raise ValueError(
                f"rng mode must be one of {self.MODES}, got {mode!r}")
        self.mode = mode
        self.seed = seed
        self.h = h
        self.counts = np.asarray(counts)
        self.device = device
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
                                t0, c)

    def draw(self, t0: torch.Tensor, c: int) -> torch.Tensor:
        """Device mode's tables for rounds t0..t0+c-1, ``t0`` a 0-d int64
        tensor read where it lies (:func:`prng.draw_tables`).  The shard
        sizes go to that device once, at the first call."""
        counts = self._counts_on.get(t0.device)
        if counts is None:
            counts = torch.as_tensor(self.counts, dtype=torch.int64).to(
                t0.device)
            self._counts_on[t0.device] = counts
        return prng.draw_tables(self.mode, self.seed, self.h, counts, t0, c)

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
                 num_rounds: int) -> IndexSampler:
    """The run's sampler with ``--sampling`` resolved."""
    sampler = IndexSampler(rng, seed, h, counts)
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


def super_blocks(n_full: int, chunk_ints: int, gap_target) -> list:
    """The device loop's super-block sizes in chunks, for ``n_full``
    chunks of ``chunk_ints`` table ints each (cocoa_tpu/solvers/
    base.py:1302-1337): equal blocks under the table cap, or, for a
    gap-targeted run with large tables, blocks doubling from what
    SMALL_TABLE_INTS holds."""
    max_block = max(1, MAX_IDX_TABLE_BYTES // (4 * chunk_ints))
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
    do not count."""

    # steps queued on the card past the last one the host has seen finish
    AHEAD = 2

    def __init__(self, body: Callable, metrics: Callable, sampler, device,
                 c: int, ladder: Ladder, schedule: Optional[Schedule],
                 n_iterate: int, hist: bool):
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
            if j >= self.AHEAD:
                # wait for step j - AHEAD, then read the live word it wrote
                finished[j - self.AHEAD].synchronize()
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
          capture: Optional[bool] = None, device_loop: bool = False):
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

    ``device_loop`` runs the evals and the ladder on the device instead
    (:func:`drive_device`).  Returns (state, Trajectory)."""
    if device_loop:
        return drive_device(
            name, params, debug, state, body, metrics, sampler, device,
            quiet=quiet, start_round=start_round, gap_target=gap_target,
            divergence_guard=divergence_guard, sigma_levels=sigma_levels,
            accel=accel, schedule=schedule, n_iterate=n_iterate,
            capture=capture)
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
    while t <= total:
        end = min(total, t + chunk - 1)
        if di > 0:
            end = min(end, ((t - 1) // di + 1) * di)
        state = _run_chunk(runner, schedule, n_iterate, t, end - t + 1,
                           state)
        t = end + 1
        if not (di > 0 and end % di == 0):
            continue
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
            _emit_accel_events(name, end, restarted, staged,
                               sched[A_TH_STAGE], accel, quiet)
        traj.log_round(end, primal=primal, gap=gap, test_error=test_err,
                       sigma=sigma_val, sigma_stage=stage, stall=stall_v)
        if backed:
            _print_backoff(name, watch.n, sigma_levels[stage], end, quiet)
        if hit:
            traj.stopped = "target"
            break
        if (not anneal_on and gap_target is not None and divergence_guard
                and watch.update(gap)):
            traj.mark_diverged(end, watch.n)
            break
    if runner.capture:
        state = (*(x.clone() for x in state[:n_iterate]),
                 *state[n_iterate:])
    return state, traj


def _print_backoff(name, n_evals, sigma, t, quiet):
    if not quiet:
        print(f"{name}: σ′ anneal — gap stalled for {n_evals} evals; "
              f"backing off to σ′={sigma:g} at round {t} (iterate kept, "
              f"certificate exact)")


def drive_device(name: str, params: Params, debug: DebugParams,
                 state: tuple, body: Callable, metrics: Callable, sampler,
                 device, quiet: bool = False, start_round: int = 1,
                 gap_target: Optional[float] = None,
                 divergence_guard: bool = True,
                 sigma_levels: Optional[tuple] = None,
                 accel: Optional[AccelConfig] = None,
                 schedule: Optional[Schedule] = None, n_iterate: int = 1,
                 capture: Optional[bool] = None):
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
    stop or a change of branch."""
    c = debug.debug_iter
    if c <= 0:
        raise ValueError("the device loop requires debug_iter > 0 (the eval "
                         "cadence is its chunk axis)")
    if torch.device(device).type == "cuda" and capture is False:
        raise ValueError("the device loop runs as captured CUDA graphs on "
                         "the card; capture=False is the chunked loop's")
    anneal = (sigma_levels is not None and len(sigma_levels) > 1
              and gap_target is not None and divergence_guard)
    traj = Trajectory(name, quiet=quiet, device=device)
    chunks = ChunkRunner(body, sampler, device, capture)
    traj.graphs = chunks.seconds
    watch = _GapWatch(n_evals=stall_window(c))
    total = params.num_rounds

    def hit_target():
        return (gap_target is not None and traj.records
                and traj.records[-1].gap is not None
                and traj.records[-1].gap <= gap_target)

    t = start_round
    head_end = min(total, ((t - 1) // c + 1) * c)
    if (t - 1) % c != 0 and head_end >= t:
        state = _run_chunk(chunks, schedule, n_iterate, t, head_end - t + 1,
                           state)
        t = head_end + 1
        if head_end % c == 0:
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
                _emit_accel_events(name, head_end, restarted, staged,
                                   sched[A_TH_STAGE], accel, quiet)
            traj.log_round(head_end, primal=primal, gap=gap,
                           test_error=test_err, sigma=sigma_val,
                           sigma_stage=stage, stall=stall_v)
            if backed:
                _print_backoff(name, watch.n, sigma_levels[stage], head_end,
                               quiet)

    n_full = max(0, (total - (t - 1)) // c)
    if n_full > 0 and not hit_target():
        ints = 1 if sampler is None else sampler.ints_per_round()
        sizes = super_blocks(n_full, c * ints, gap_target)
        loop = DeviceLoopRunner(
            body, metrics, sampler, device, c,
            Ladder(gap_target, divergence_guard,
                   len(sigma_levels) if sigma_levels is not None else 0,
                   watch.n, accel.n_theta if accel is not None else 0),
            schedule, n_iterate, accel is not None)
        loop.enter(state, max(sizes))
        done = t - 1
        start = t
        for b in sizes:
            rows, _, stop_stall = loop.block(start, b, traj)
            new = _decode_rows(traj, name, rows, start, c,
                               sigma_levels if anneal else None, quiet)
            if new:
                # the super-block's fetch: its last record's time
                new[-1].wall_time = traj.elapsed()
            done = start - 1 + len(rows) * c
            start += b * c
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
        state = _run_chunk(chunks, schedule, n_iterate, t, rem, state)
    if chunks.capture:
        state = (*(x.clone() for x in state[:n_iterate]),
                 *state[n_iterate:])
    return state, traj


def _decode_rows(traj: Trajectory, name: str, rows, start: int, c: int,
                 levels: Optional[tuple], quiet: bool) -> list:
    """A super-block's rows as records, as JAX's ``drive_on_device``
    decodes them: round ``start - 1 + (j + 1) * c`` for row j, NaN gap and
    test error as None, no wall time; under the anneal (``levels``) the
    stage and stall columns, and a line for each change of sigma' between
    two rows of the super-block.  Returns the new records."""
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
                       wall_time=None)
        if (not quiet and levels is not None and prev is not None
                and sigma != prev):
            print(f"{name}: σ′ anneal — backed off to σ′={sigma:g} in the "
                  f"device loop at round {end} (iterate kept, certificate "
                  f"exact)")
        prev = sigma
        out.append(traj.records[-1])
    return out
