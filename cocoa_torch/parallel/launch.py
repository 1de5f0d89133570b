"""One command, one rank a card: the local launcher (the port's form of
the JAX CLI's one-process mesh over a host's devices, cocoa_tpu/cli.py:
1042-1100).

The JAX CLI puts a run's K shards on D local devices in one process.
The port runs one process a card, so a run of the CLI without
``--master`` whose mesh spans R = mesh x fp > 1 devices becomes this
launcher: it starts R ranks of ``python -m cocoa_torch.cli`` on this
host, each with the user's flags plus ``--master=127.0.0.1:<free port>
--processId=i --numProcesses=R``, and waits for them.  Rank i runs on
``cuda:(i % cards)`` (parallel/distributed.py ``rank_device``), or on the
CPU under ``--device=cpu``; the ranks are the gang of parallel/, joined
and checked by the CLI as a hand-launched gang is.

- **Output.**  Rank 0's stdout and stderr are the launcher's: the run
  prints what a hand-launched gang's rank 0 prints.  The other ranks
  print the same lines, so their stdout is dropped; the last
  :data:`TAIL_BYTES` of each one's stderr are kept and printed, each
  line prefixed ``[rank i]``, when that rank fails.
- **Failure.**  When a rank fails (elastic.py ``first_failure``'s order:
  a death by a signal before an exit code, then rank order), every other
  rank is killed and reaped, and the launcher exits non-zero naming the
  rank and its code.  SIGINT and SIGTERM to the launcher go to every
  rank; a rank still alive :data:`GRACE_S` later is killed.  Each rank
  is also killed by the kernel if the launcher dies first (Linux
  ``PR_SET_PDEATHSIG``, set by a trampoline that then execs the rank), so
  no rank outlives it.
- **The launcher itself** joins no gang, resolves no card and loads no
  data, as the elastic supervisor does not.

``COCOA_MESH_NOTE`` in a rank's environment is a line the rank prints
after its flag echo: the JAX CLI's ``note: inferred mesh uses ...``,
which the JAX CLI prints there and the launcher cannot.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Optional

from cocoa_torch.elastic import first_failure, free_port, worker_env

TAIL_BYTES = 64 * 1024   # of each rank's stderr (ranks 1..R-1)
GRACE_S = 10.0           # after a forwarded signal, before SIGKILL
MESH_NOTE_ENV = "COCOA_MESH_NOTE"
# the rank flags the launcher owns; the user's copies (meaningless
# without --master) are dropped from the ranks' argv
_OWN = ("master", "processId", "numProcesses")


class _Tail:
    """The last ``limit`` bytes of a pipe, read on a daemon thread."""

    def __init__(self, pipe, limit: int = TAIL_BYTES):
        self.limit = limit
        self.data = bytearray()
        self.thread = threading.Thread(target=self._read, args=(pipe,),
                                       daemon=True)

    def _read(self, pipe) -> None:
        while True:
            chunk = pipe.read1(65536)
            if not chunk:
                break
            self.data += chunk
            if len(self.data) > self.limit:
                del self.data[:len(self.data) - self.limit]
        pipe.close()

    def lines(self) -> list:
        self.thread.join(timeout=5)
        return bytes(self.data).decode(errors="replace").splitlines()


# each rank starts through this trampoline: it asks the kernel to SIGKILL
# it when the launcher dies (PR_SET_PDEATHSIG, which an exec keeps), gives
# up if the launcher is already gone, and execs the rank's command; the
# launcher thus needs no preexec_fn, which a fork in a threaded process
# makes unsafe
_TRAMPOLINE = (
    "import ctypes, os, signal, sys\n"
    "ctypes.CDLL(None).prctl(1, signal.SIGKILL)\n"
    "if os.getppid() != int(sys.argv[1]):\n"
    "    sys.exit(1)\n"
    "os.execv(sys.argv[2], sys.argv[2:])\n")


def rank_argv(argv: list, rank: int, ranks: int, port: int,
              python: Optional[str] = None,
              module: str = "cocoa_torch.cli") -> list:
    """Rank ``rank``'s command line: the user's flags without the rank
    flags, then the gang's own."""
    flags = [a for a in argv if a.lstrip("-").split("=", 1)[0] not in _OWN]
    return [python or sys.executable, "-m", module, *flags,
            f"--master=127.0.0.1:{port}", f"--processId={rank}",
            f"--numProcesses={ranks}"]


def _spawn(argv: list, rank: int, ranks: int, port: int, env: dict,
           python: Optional[str], module: str) -> subprocess.Popen:
    """Start rank ``rank`` through the trampoline: rank 0 on the
    launcher's stdout and stderr, the others with stdout dropped and
    stderr piped."""
    cmd = rank_argv(argv, rank, ranks, port, python, module)
    return subprocess.Popen(
        [cmd[0], "-c", _TRAMPOLINE, str(os.getpid()), *cmd], env=env,
        stdout=None if rank == 0 else subprocess.DEVNULL,
        stderr=None if rank == 0 else subprocess.PIPE)


def run_gang(argv: list, ranks: int, note: Optional[str] = None,
             poll_s: float = 0.05, python: Optional[str] = None,
             module: str = "cocoa_torch.cli") -> int:
    """Run ``ranks`` local ranks of ``module`` on the user's ``argv`` to
    their end; returns 0 when every rank exits 0, else the first failed
    rank's code (128 + s for a death by signal s, as a shell reports
    it), or 128 + the signal the launcher was sent.  ``note`` goes to every rank as ``COCOA_MESH_NOTE``."""
    env = worker_env()
    env.pop(MESH_NOTE_ENV, None)
    if note:
        env[MESH_NOTE_ENV] = note
    port = free_port()
    sys.stdout.flush()
    sys.stderr.flush()
    procs, tails = [], {}
    got = []   # the signals the launcher was sent

    def forward(signum, frame):
        got.append(signum)
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(signum)
                except OSError:
                    pass

    saved = {}
    if threading.current_thread() is threading.main_thread():
        for s in (signal.SIGINT, signal.SIGTERM):
            saved[s] = signal.signal(s, forward)
    try:
        for i in range(ranks):
            procs.append(_spawn(argv, i, ranks, port, env, python, module))
            if i:
                tails[i] = _Tail(procs[i].stderr)
                tails[i].thread.start()
        deadline = None
        while True:
            codes = [p.poll() for p in procs]
            hit = first_failure(codes)
            if hit is not None:
                rank, code = hit
                for i, c in enumerate(codes):
                    if i > 0 and c not in (None, 0):
                        for line in tails[i].lines():
                            print(f"[rank {i}] {line}", file=sys.stderr)
                print(f"launch: rank {rank} of {ranks} failed (exit "
                      f"{code}); stopping the other ranks", file=sys.stderr,
                      flush=True)
                return code if code > 0 else 128 - code
            if all(c == 0 for c in codes):
                return 128 + got[0] if got else 0
            if got and deadline is None:
                deadline = time.monotonic() + GRACE_S
            if deadline is not None and time.monotonic() > deadline:
                print(f"launch: ranks alive {GRACE_S:g} s after signal "
                      f"{got[0]}; killing them", file=sys.stderr, flush=True)
                return 128 + got[0]
            time.sleep(poll_s)
    finally:
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
        for s, old in saved.items():
            signal.signal(s, old)
