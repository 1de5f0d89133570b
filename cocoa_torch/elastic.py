"""Elastic multi-process supervision: gang restart, shrink to survivors,
checkpoint resume (counterpart of cocoa_tpu/elastic.py).

``--elastic=N`` makes the invoking CLI process the supervisor of a gang
of N port workers (``python -m cocoa_torch.cli`` with the user's flags
plus ``--master=127.0.0.1:<port> --processId=i --numProcesses=N``, and
``--resume`` when there is a ``--chkptDir``).  When a worker dies the
supervisor kills the rest and relaunches the whole gang from the latest
checkpoint; round-keyed sampling makes the resumed trajectory the
uninterrupted one, so a failure costs the rounds since the last save.
With ``num_splits`` given it reforms the gang at the largest P' < P
whose devices divide the K shards, after ``max_restarts`` consecutive
failed generations (``--elastic=N``) or at the first loss
(``--elastic=N,shrink``); a shrunk gang re-ingests its inherited shards
through the streamed ingest (data/ingest.py) and, with
``--ingestCache``, maps them warm from the slab cache.  With
``stall_timeout_s`` and a ``progress_token`` a gang whose token has not
changed for that long is killed and restarted like a death, and counts
against the budget (``shrink="now"`` spares a stall: every process is
alive).  Between generations it backs off exponentially with seeded
jitter, reset on progress.  The decisions, the ``restart`` and
``gang_resize`` events, the ``gang_generation`` and ``restart_backoff``
spans, the victim's flight-recorder dump and the ``elastic: ...`` lines
on stderr are the JAX supervisor's, through the port's telemetry.

Where the port departs from it:

- **The victim.**  A JAX survivor wedges inside a KV get until the
  supervisor kills it; a gloo survivor raises at once ("connection
  closed by peer") and exits 1, so one poll can see a survivor's exit
  code beside the killed worker's signal.  Within one poll a death by a
  signal (a negative return code) ranks before an exit code, and rank
  order decides within each class; JAX takes the first failure in rank
  order.  The flight recorder then names the worker that was killed.
- **Workers of several devices.**  A JAX worker owns its
  ``devices_per_worker`` devices in one process; a port worker of D
  devices is D ranks, one a card (rank r on ``cuda:(r % cards)``), so
  the supervisor spawns N x D ranks and worker w is ranks [w·D, (w+1)·D).
  A rank's death is its worker's: the ``elastic:`` line names the worker
  and the rank (with D = 1 it is JAX's line), the flight recorder dumps
  the rank's stream under the worker's index, and the gang's size in
  the events and spans counts workers.
- **The workers' environment.**  The port runs uninstalled from its
  checkout, so each worker gets the directory holding ``cocoa_torch``
  at the head of ``PYTHONPATH`` (``python -m cocoa_torch.cli`` from
  another working directory finds it), and ``GLOO_SOCKET_IFNAME`` and
  ``NCCL_SOCKET_IFNAME`` set to ``lo`` unless the caller set them: the
  rendezvous is 127.0.0.1, and gloo and NCCL otherwise bind the
  interface the host's name resolves to.

The supervisor never touches a device: the cards are its workers'.
"""

from __future__ import annotations

import os
import random
import signal
import socket
import subprocess
import sys
import time
from typing import Optional

# the directory that holds the cocoa_torch package (the checkout's root)
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def shrink_gang_size(num_splits: int, current: int,
                     devices_per_worker: int = 1) -> Optional[int]:
    """The largest gang size P' < ``current`` whose device count divides
    the K logical shards, or None when no smaller gang can carry them
    (each rank holds m = K/P whole shards, parallel/mesh.py)."""
    for p in range(current - 1, 0, -1):
        if num_splits % (p * devices_per_worker) == 0:
            return p
    return None


def backoff_seconds(streak: int, base_s: float, cap_s: float,
                    jitter: float, rng: random.Random) -> float:
    """Exponential backoff with jitter for the ``streak``-th consecutive
    failed generation: min(cap, base·2^(streak-1)) scaled by a uniform
    factor in [1-jitter, 1+jitter].  ``base_s <= 0`` disables the wait;
    the seeded ``rng`` gives the JAX supervisor's sequence."""
    if base_s <= 0 or streak <= 0:
        return 0.0
    delay = min(cap_s, base_s * (2.0 ** (streak - 1)))
    return delay * (1.0 + jitter * (2.0 * rng.random() - 1.0))


def worker_env() -> dict:
    """The environment a worker starts in: the supervisor's, with the
    package's directory first on ``PYTHONPATH`` and the gang's sockets
    on the loopback unless it says otherwise."""
    env = dict(os.environ)
    paths = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join(
        [_PACKAGE_PARENT] + [p for p in paths if p != _PACKAGE_PARENT])
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    return env


def _spawn(worker_argv, i, n, port, python, module, quiet_tail, resume):
    argv = [
        python, "-m", module, *worker_argv,
        f"--master=127.0.0.1:{port}",
        f"--processId={i}", f"--numProcesses={n}",
        *(["--resume"] if resume else []),
    ]
    out = None if (i == 0 or not quiet_tail) else subprocess.DEVNULL
    return subprocess.Popen(argv, stdout=out, stderr=out, env=worker_env())


def first_failure(codes):
    """(index, code) of the failure a poll's ``codes`` report, or None:
    a death by a signal ranks before an exit code, then rank order (see
    the module docstring)."""
    failures = [(c >= 0, idx, c) for idx, c in enumerate(codes)
                if c not in (None, 0)]
    if not failures:
        return None
    _, idx, code = min(failures)
    return idx, code


def supervise(
    worker_argv: list,
    num_processes: int,
    max_restarts: int = 5,
    poll_s: float = 0.25,
    python: Optional[str] = None,
    module: str = "cocoa_torch.cli",
    quiet_tail: bool = True,
    on_generation=None,
    resume: bool = True,
    progress_token=None,
    stall_timeout_s: Optional[float] = None,
    num_splits: Optional[int] = None,
    shrink: str = "auto",
    devices_per_worker: int = 1,
    backoff_base_s: float = 1.0,
    backoff_cap_s: float = 60.0,
    backoff_jitter: float = 0.5,
    backoff_seed: int = 0,
    on_restart=None,
) -> int:
    """Run the gang to completion, restarting it from the latest
    checkpoint (the workers' ``--resume``) whenever a member dies or,
    with ``stall_timeout_s``, whenever ``progress_token`` stops
    changing; with ``num_splits``, reform it at P' < P survivors when the
    same-size gang cannot be kept alive.  Returns 0 on success, else the
    failing worker's code once the budget is spent with no smaller gang
    to fall back to.  The keywords are the JAX supervisor's
    (cocoa_tpu/elastic.py:154-239): ``on_generation(gen, procs)`` after
    each spawn (0-based), ``on_restart(generation, reason, old_size,
    new_size, backoff_s)`` before each relaunch, ``shrink``
    auto|now|off.

    ``worker_argv`` is the user's flag list without the flags the
    supervisor owns (:func:`strip_elastic_flags`).  Each worker is
    ``devices_per_worker`` ranks (module docstring).  Rank 0 inherits
    stdout and stderr; the others are silenced unless
    ``quiet_tail=False``.  A shrunk generation drops any ``--mesh``."""
    python = python or sys.executable
    if stall_timeout_s is not None and progress_token is None:
        raise ValueError("stall_timeout_s needs progress_token — without "
                         "a token there is no progress signal to watch")
    if shrink not in ("auto", "now", "off"):
        raise ValueError(f"shrink must be auto|now|off, got {shrink!r}")
    from cocoa_torch.telemetry import events as _tele
    from cocoa_torch.telemetry import recorder as _recorder
    from cocoa_torch.telemetry import tracing as _tracing

    rng = random.Random(backoff_seed)
    n_cur = num_processes
    argv_cur = list(worker_argv)
    restarts = 0   # consecutive failed generations at this size: the
    #                give-up / shrink budget (reset on progress and resize)
    streak = 0     # consecutive failed generations since progress: the
    #                backoff's exponent (a resize keeps it)
    gen = 0
    last_token = progress_token() if progress_token else None

    while True:
        port = free_port()
        # generation numbers are 1-based in the span, the events and the
        # dump (gangs spawned so far); on_generation keeps JAX's 0-based
        with _tracing.span("gang_generation", generation=gen + 1,
                           gang_size=n_cur):
            ranks = n_cur * devices_per_worker
            procs = [
                _spawn(argv_cur, i, ranks, port, python, module,
                       quiet_tail, resume)
                for i in range(ranks)
            ]
            if on_generation is not None:
                on_generation(gen, procs)
            gen += 1
            failed = None
            failed_idx = None
            stalled = False
            last_change = time.monotonic()
            try:
                while True:
                    codes = [p.poll() for p in procs]
                    hit = first_failure(codes)
                    if hit is not None:
                        failed_idx, failed = hit
                        break
                    if all(c == 0 for c in codes):
                        return 0
                    if stall_timeout_s is not None:
                        token = progress_token()
                        if token != last_token:
                            last_token = token
                            last_change = time.monotonic()
                            restarts = 0  # live progress breaks the streak
                            streak = 0
                        elif (time.monotonic() - last_change
                                > stall_timeout_s):
                            stalled = True
                            break
                    time.sleep(poll_s)
            finally:
                # the survivors are blocked in (or failing out of) a
                # collective whose peer is gone, or we are unwinding on
                # KeyboardInterrupt: kill the gang
                for p in procs:
                    if p.poll() is None:
                        try:
                            p.send_signal(signal.SIGKILL)
                        except OSError:
                            pass
                for p in procs:
                    try:
                        p.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        pass
        if progress_token is not None:
            token = progress_token()
            if token != last_token:
                restarts = 0      # the dead generation still advanced
                streak = 0
                last_token = token
        restarts += 1
        streak += 1
        attempt_used = restarts   # the restart event reports the failures
        #                           that led here, even after a resize
        reason = "gang_stalled" if stalled else "worker_died"

        # the victim cannot dump its own ring after a SIGKILL, but its
        # events streamed to its per-process JSONL: leave the
        # `.flightrec` beside it, scoped to its pid; a stall has no single
        # victim, so worker 0's stream stands for the gang
        victim = 0 if failed_idx is None else failed_idx
        if _tele.get_bus().jsonl_path:
            victim_pid = (getattr(procs[failed_idx], "pid", None)
                          if failed_idx is not None else None)
            _recorder.dump_victim(
                _tele.get_bus().jsonl_path, victim // devices_per_worker,
                reason, exit_code=failed, generation=gen,
                victim_pid=victim_pid, stream_index=victim)

        old_n = n_cur
        can_shrink = (num_splits is not None and shrink != "off"
                      and n_cur > 1)
        # "now" reforms on a worker's loss only: a stall has every
        # process alive, so it burns the budget and shrinks only when
        # that is spent
        if can_shrink and ((shrink == "now" and not stalled)
                           or restarts > max_restarts):
            n_new = shrink_gang_size(num_splits, n_cur, devices_per_worker)
            if n_new is None:
                print(f"elastic: cannot reform the gang below {n_cur} "
                      f"workers — numSplits={num_splits} does not divide "
                      f"across any smaller gang's devices "
                      f"({devices_per_worker} per worker); giving up "
                      f"(pick a numSplits with more divisors to allow "
                      f"deeper shrink)", file=sys.stderr, flush=True)
                return int(failed or 1)
            _tele.get_bus().emit(
                "gang_resize", reason=reason, old_size=n_cur,
                new_size=n_new, generation=gen, num_splits=num_splits,
                exit_code=failed)
            stripped = [a for a in argv_cur
                        if a.lstrip("-").split("=", 1)[0] != "mesh"]
            if len(stripped) != len(argv_cur):
                print("elastic: dropping the explicit --mesh from the "
                      "worker line — the reformed gang re-infers its mesh "
                      f"from {n_new} worker(s)", file=sys.stderr)
            argv_cur = stripped
            n_cur = n_new
            restarts = 0   # a reformed gang earns a fresh same-size budget
        elif restarts > max_restarts:
            why = ("stalled" if stalled
                   else f"failed (last exit code {failed})")
            print(f"elastic: giving up after {max_restarts} consecutive "
                  f"{why} generations", file=sys.stderr)
            return int(failed or 1)
        backoff = backoff_seconds(streak, backoff_base_s, backoff_cap_s,
                                  backoff_jitter, rng)
        _tele.get_bus().emit(
            "restart", reason=reason,
            attempt=attempt_used, max_restarts=max_restarts,
            exit_code=failed, generation=gen, gang_size=n_cur,
            backoff_s=backoff)
        if on_restart is not None:
            on_restart(gen, reason, old_n, n_cur, backoff)
        who = ("worker" if devices_per_worker == 1 else
               f"worker {victim // devices_per_worker} (rank {victim})")
        what = (f"gang made no progress for {stall_timeout_s:g}s"
                if stalled else f"{who} died (exit {failed})")
        if n_cur != old_n:
            print(f"elastic: {what}; reforming the gang at {n_cur} of "
                  f"{old_n} workers ({num_splits} shards re-divided over "
                  f"the survivors) from the latest checkpoint"
                  + (f" after {backoff:.1f}s backoff" if backoff else ""),
                  file=sys.stderr, flush=True)
        else:
            print(f"elastic: {what}; restarting gang "
                  f"(attempt {restarts}/{max_restarts}) from the latest "
                  f"checkpoint"
                  + (f" after {backoff:.1f}s backoff" if backoff else ""),
                  file=sys.stderr, flush=True)
        if backoff > 0:
            with _tracing.span("restart_backoff", generation=gen,
                               backoff_s=backoff):
                time.sleep(backoff)


def strip_elastic_flags(argv: list) -> list:
    """The worker command line: the user's line minus the flags the
    supervisor owns (it adds its own --master/--processId/...)."""
    own = ("elastic", "master", "processId", "numProcesses", "resume",
           "stallTimeout")
    return [a for a in argv if a.lstrip("-").split("=", 1)[0] not in own]
