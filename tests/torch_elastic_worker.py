"""A toy gang worker for the port's supervisor tests (the counterpart of
tests/_gang_worker.py's toy mode).

    python -m torch_elastic_worker --numSplits=K --numRounds=T
        [--chkptDir=D --chkptIter=C] [--stepSeconds=S] [--algorithm=A]
        [--events=P] [--metrics=P] [--trace] --master=... --processId=i
        --numProcesses=n [--resume]

Run under ``cocoa_torch.elastic.supervise(..., module=
"torch_elastic_worker")`` with ``tests/`` on ``PYTHONPATH``: it joins a
gloo gang through ``cocoa_torch.parallel.distributed`` (a real
rendezvous), splits the K shards over the gang, adds one all-reduce a
round of a deterministic per-shard increment, and checkpoints through
``cocoa_torch.checkpoint``.  Each shard's increment is keyed to (round,
shard) alone and each w[s] gets one nonzero addend a round, so a killed,
shrunk and resumed run ends on the unfailed run's w bit for bit.  Its
telemetry is the CLI's: worker 0 owns ``<events>`` and ``<metrics>``,
worker p streams to ``<events>.p<p>``, spans tagged with the worker.
``--algorithm`` names the checkpoints (``ToyGang``; ``CoCoA+`` for a
``--serve`` process to take them).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ALGORITHM = "ToyGang"
# a dead peer must fail this worker well inside a test's time
TIMEOUT_S = 30.0


def parse(argv):
    opts = {}
    for a in argv:
        k, _, v = a.lstrip("-").partition("=")
        opts[k] = v if v else "true"
    return opts


def round_increments(t: int, k: int, lo: int, hi: int) -> np.ndarray:
    """Round t's update of shards [lo, hi), keyed to (round, shard) only
    (tests/_gang_worker.py ``round_increments``)."""
    out = np.zeros(k, np.float64)
    for s in range(lo, hi):
        out[s] = ((t * 1000003 + s * 7919) % 104729) / 104729.0
    return out


def main(argv=None) -> int:
    import torch

    from cocoa_torch import checkpoint
    from cocoa_torch.parallel import distributed
    from cocoa_torch.telemetry import events, recorder, tracing

    opts = parse(sys.argv[1:] if argv is None else argv)
    pid = int(opts.get("processId", 0))
    nproc = int(opts.get("numProcesses", 1))
    k = int(opts["numSplits"])
    rounds = int(opts["numRounds"])
    ckdir = opts.get("chkptDir", "")
    ck_iter = int(opts.get("chkptIter", 5))
    step_s = float(opts.get("stepSeconds", 0.05))
    algorithm = opts.get("algorithm", ALGORITHM)

    stream = (recorder.worker_stream_path(opts["events"], pid)
              if opts.get("events") else None)
    metrics = opts.get("metrics") if pid == 0 else None
    if stream or metrics:
        events.get_bus().configure(jsonl_path=stream, metrics_path=metrics)
    if opts.get("trace"):
        tracing.configure(enabled=True, worker=pid)

    distributed.maybe_initialize(opts.get("master"), pid, nproc,
                                 timeout_s=TIMEOUT_S)
    if k % nproc != 0:
        print(f"error: K={k} shards cannot divide over {nproc} workers",
              file=sys.stderr)
        return 2
    m = k // nproc

    w = np.zeros(k, np.float64)
    start = 1
    if "resume" in opts and ckdir:
        path = checkpoint.latest(ckdir, algorithm)
        if path is not None:
            meta, w0, _ = checkpoint.load(path)
            w = np.array(w0, np.float64)
            start = meta["round"] + 1
            print(f"resuming {algorithm} from round {meta['round']} "
                  f"({path})", flush=True)

    for t in range(start, rounds + 1):
        with tracing.span("round", round=t):
            mine = torch.from_numpy(round_increments(t, k, pid * m,
                                                     (pid + 1) * m))
            with tracing.span("all_reduce"):
                if distributed.initialized():
                    torch.distributed.all_reduce(mine)
            w = w + mine.numpy()
            with tracing.span("local_step"):
                time.sleep(step_s)
            if ckdir and t % ck_iter == 0 and pid == 0:
                checkpoint.save(ckdir, algorithm, t, w, None, seed=0)
    distributed.shutdown()
    print(f"{algorithm}: done at round {rounds}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
