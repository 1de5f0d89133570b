"""Gangs of the port's CLI on the CPU for the tests: one ``python -m
cocoa_torch.cli`` child a rank with ``--device=cpu`` and the gang's
flags, one torch thread each (``OMP_NUM_THREADS=1``)."""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argvs, ids=None) -> list:
    """Start one port CLI a rank, ``argvs[r]`` rank r's flags; the gang's
    own are added, ``--processId=ids[r]`` (default r) among them."""
    port, world = free_port(), len(argvs)
    ids = ids or [str(r) for r in range(world)]
    return [subprocess.Popen(
        [sys.executable, "-m", "cocoa_torch.cli", *argv, "--device=cpu",
         f"--master=127.0.0.1:{port}", f"--processId={ids[r]}",
         f"--numProcesses={world}"], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
        for r, argv in enumerate(argvs)]


def collect(gangs, timeout=240) -> list:
    """Each gang of ``gangs`` (lists of :func:`spawn`'s children) as
    [(rc, stdout, stderr)] a rank; every child of every gang is killed on
    any failure, so no rank is left waiting at a rendezvous."""
    out = []
    try:
        for procs in gangs:
            ranks = []
            for p in procs:
                o, e = p.communicate(timeout=timeout)
                ranks.append((p.returncode, o, e))
            out.append(ranks)
    finally:
        for procs in gangs:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


def gang(argvs, timeout=240, ids=None) -> list:
    """Run one port CLI a rank (:func:`spawn`); returns [(rc, stdout,
    stderr)] in rank order."""
    return collect([spawn(argvs, ids)], timeout)[0]
