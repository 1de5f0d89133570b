"""Shared solver machinery (counterpart of parts of
cocoa_tpu/solvers/base.py): the shard check, the index sampler (host or
device tables, ``--sampling``), the chunk size (``--scanChunk``), and the
chunked round loop, each chunk of rounds one replayed CUDA graph on the
card, with the JAX host-stepped driver's ladder (``drive_chunked``): the
gap-target stop, the divergence guard's stall watch, the sigma' anneal
schedule and the accelerated outer loop's window bookkeeping.

The schedule state is the JAX package's float32 sched vector, kept here as
a numpy array on the host: the host picks each chunk's branch from it, so
no device read is added to the one fetch per eval."""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from cocoa_torch import kernels
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


def drive(name: str, params: Params, debug: DebugParams, state: tuple,
          body: Callable, eval_fn: Callable[[tuple], tuple], sampler,
          device, chunk: int, quiet: bool = False, start_round: int = 1,
          gap_target: Optional[float] = None, divergence_guard: bool = True,
          sigma_levels: Optional[tuple] = None,
          accel: Optional[AccelConfig] = None,
          head: Optional[Callable] = None, n_iterate: int = 1,
          capture: Optional[bool] = None):
    """The outer loop (CoCoA.scala:39-63 skeleton, with the ladder of
    cocoa_tpu/solvers/base.py ``drive_chunked``).  Rounds run in chunks
    of up to ``chunk`` that end at each ``debugIter`` boundary; the first
    ``n_iterate`` entries of ``state`` are the device tensors the rounds
    advance, and the rest the host's (the accel bank, the sched vector).
    At a chunk's head ``head(t0, c, state) -> (key, state)`` (default: key
    None) picks the branch on the host and may move the iterate (the
    secant jump); then a :class:`ChunkRunner` runs ``body`` over the
    chunk, on CUDA as a replayed CUDA graph unless ``capture`` is False.
    The host reads the device only at the evaluations, ``eval_fn(state)
    -> (primal, gap, test_error)``.  The returned state owns its tensors
    (no graph writes them again), and ``Trajectory.graphs`` has each
    graph's capture time.

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
        c = end - t + 1
        key = None
        if head is not None:
            key, state = head(t, c, state)
        state = (*runner(key, t, c, state[:n_iterate]), *state[n_iterate:])
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
    if runner.capture:
        state = (*(x.clone() for x in state[:n_iterate]),
                 *state[n_iterate:])
    return state, traj
