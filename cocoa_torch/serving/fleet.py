"""Fleet lifecycle (counterpart of cocoa_tpu/serving/fleet.py): spawn N
scorer replica processes, watch them, respawn the dead.

Each replica is an ordinary single-process serve CLI (``python -m
cocoa_torch.cli --serve=0`` on an ephemeral port, its ``--device`` in
the base argv) pointed at the same validated checkpoint directory: the
same program a one-process deployment runs.  Models arrive per replica
through the watcher and hot-swap, and the only new process is the router
in front.

:class:`ServeFleet` owns the subprocesses:

- ``start()`` spawns them and parses each replica's ``listening on
  host:port`` announce line (printed even under ``--quiet`` exactly so
  supervisors can do this);
- ``attach(router)`` starts the monitor thread: a replica whose
  process exits is marked dead on the router immediately (in-flight
  lines against it requeue, see router.py) and — with
  ``restart=True`` — respawned and re-registered under its old name,
  emitting the ``replica_state`` dead/live event pair;
- ``stop()`` tears everything down.

Tests that want a fleet without processes skip this module entirely:
:class:`~cocoa_torch.serving.router.Router` takes any (name, address)
list, so in-process ``MarginServer`` threads compose the same way.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

_ANNOUNCE_RE = re.compile(r"listening on ([0-9.]+):([0-9]+)")
_POLL_S = 0.2


class ReplicaProc:
    """One spawned replica: its process, parsed address, restart count."""

    def __init__(self, name: str):
        self.name = name
        self.proc: Optional[subprocess.Popen] = None
        self.address: Optional[Tuple[str, int]] = None
        self.restarts = 0

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None


class ServeFleet:
    """Spawn, announce-parse, monitor and restart scorer replicas."""

    def __init__(self, base_argv: Sequence[str], n_replicas: int,
                 extra_argv_fn: Optional[Callable[[int], List[str]]]
                 = None, env: Optional[dict] = None,
                 start_timeout_s: float = 300.0, restart: bool = True,
                 echo: Optional[Callable[[str], None]] = None):
        """``base_argv`` is the per-replica CLI tail (everything after
        ``--serve=0`` — chkptDir, buckets, dtype...); ``extra_argv_fn``
        appends per-index flags (e.g. a per-replica events sink)."""
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got "
                             f"{n_replicas}")
        self.base_argv = list(base_argv)
        self.extra_argv_fn = extra_argv_fn
        self.env = dict(os.environ, **(env or {}))
        self.start_timeout_s = float(start_timeout_s)
        self.restart = restart
        self.echo = echo or (lambda s: None)
        self.replicas = [ReplicaProc(f"r{i}")
                         for i in range(n_replicas)]
        self._router = None
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None

    # --- spawning ----------------------------------------------------------

    def _argv(self, i: int) -> List[str]:
        extra = self.extra_argv_fn(i) if self.extra_argv_fn else []
        return [sys.executable, "-m", "cocoa_torch.cli", "--serve=0",
                *self.base_argv, *extra]

    def _spawn(self, rep: ReplicaProc, i: int):
        self._launch(rep, i)
        self._await_announce(rep)

    def _launch(self, rep: ReplicaProc, i: int):
        rep.proc = subprocess.Popen(
            self._argv(i), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=self.env)

    def _await_announce(self, rep: ReplicaProc):
        """Read the replica's output up to its announce line."""
        deadline = time.monotonic() + self.start_timeout_s
        head = []
        while True:
            line = rep.proc.stdout.readline()
            if not line:
                raise RuntimeError(
                    f"replica {rep.name} exited before announcing "
                    f"(rc={rep.proc.poll()}); output:\n"
                    + "".join(head[-40:]))
            head.append(line)
            m = _ANNOUNCE_RE.search(line)
            if m:
                rep.address = (m.group(1), int(m.group(2)))
                break
            if time.monotonic() > deadline:
                rep.proc.kill()
                raise RuntimeError(
                    f"replica {rep.name} never announced within "
                    f"{self.start_timeout_s:g}s; output:\n"
                    + "".join(head[-40:]))
        # keep draining stdout so the pipe never fills and blocks the
        # replica; lines go to the echo hook (the CLI prefixes and
        # prints them)
        threading.Thread(target=self._drain, args=(rep,),
                         daemon=True).start()
        self.echo(f"replica {rep.name} pid={rep.pid} "
                  f"port={rep.address[1]}")

    def _drain(self, rep: ReplicaProc):
        proc = rep.proc
        for line in proc.stdout:
            self.echo(f"[{rep.name}] {line.rstrip()}")

    def start(self) -> List[Tuple[str, Tuple[str, int]]]:
        """Spawn every replica, all started before any announce is read
        (each takes seconds to reach its device); returns [(name, (host,
        port))] for the router."""
        for i, rep in enumerate(self.replicas):
            self._launch(rep, i)
        for rep in self.replicas:
            self._await_announce(rep)
        return [(r.name, r.address) for r in self.replicas]

    # --- monitoring --------------------------------------------------------

    def attach(self, router):
        """Start the liveness monitor against ``router``."""
        self._router = router
        self._monitor = threading.Thread(target=self._watch,
                                         daemon=True,
                                         name="cocoa-fleet-monitor")
        self._monitor.start()

    def _watch(self):
        while not self._stop.is_set():
            for i, rep in enumerate(self.replicas):
                if rep.proc is None or rep.proc.poll() is None:
                    continue
                rc = rep.proc.returncode
                self.echo(f"replica {rep.name} died (rc={rc})")
                dead = next(r for r in self._router.replicas
                            if r.name == rep.name)
                self._router.mark_dead(dead)
                if not self.restart or self._stop.is_set():
                    rep.proc = None
                    continue
                try:
                    rep.restarts += 1
                    self._spawn(rep, i)
                    self._router.mark_live(rep.name, rep.address)
                except RuntimeError as e:
                    self.echo(f"replica {rep.name} respawn failed: "
                              f"{e}")
                    rep.proc = None
            self._stop.wait(_POLL_S)

    # --- teardown ----------------------------------------------------------

    def pids(self) -> List[Optional[int]]:
        return [r.pid for r in self.replicas]

    def stop(self, timeout: float = 10.0):
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout)
        for rep in self.replicas:
            proc = rep.proc
            if proc is None or proc.poll() is not None:
                continue
            proc.terminate()
        deadline = time.monotonic() + timeout
        for rep in self.replicas:
            proc = rep.proc
            if proc is None:
                continue
            try:
                proc.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(5.0)
