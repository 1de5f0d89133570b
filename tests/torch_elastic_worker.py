"""A gang worker for the port's supervisor tests (the counterpart of
tests/_gang_worker.py).

    python -m torch_elastic_worker --numSplits=K --numRounds=T
        [--chkptDir=D --chkptIter=C] [--stepSeconds=S] [--algorithm=A]
        [--events=P] [--metrics=P] [--trace] --master=... --processId=i
        --numProcesses=n [--resume]
    python -m torch_elastic_worker --real=cocoa --numSplits=K
        --numRounds=T [--rowsPerShard=R --numFeatures=d --localIters=H
        --lambda=L --seed=s --gapTarget=g --debugIter=E --chkptDir=D
        --chkptIter=C --overlapComm=auto|on|off --staleRounds=S
        --stepSeconds=S --stepSkew=S --skewEvery=J --dtype=float64|float32
        --device=cpu|cuda] ...

Run under ``cocoa_torch.elastic.supervise(..., module=
"torch_elastic_worker")`` with ``tests/`` on ``PYTHONPATH``: it joins a
gloo gang through ``cocoa_torch.parallel.distributed`` (a real
rendezvous) and splits the K shards over the gang.  Its telemetry is the
CLI's: worker 0 owns ``<events>`` and ``<metrics>``, worker p streams to
``<events>.p<p>``, spans tagged with the worker.

Two modes:

- **toy** (default): one all-reduce a round of a deterministic per-shard
  increment, checkpointed through ``cocoa_torch.checkpoint``.  Each
  shard's increment is keyed to (round, shard) alone and each w[s] gets
  one nonzero addend a round, so a killed, shrunk and resumed run ends
  on the unfailed run's w bit for bit.  ``--algorithm`` names the
  checkpoints (``ToyGang``; ``CoCoA+`` for a ``--serve`` process to take
  them).
- **--real=cocoa**: a CoCoA+ gang over the store exchange, the JAX
  harness's real mode (tests/_gang_worker.py:223-437) with the same
  synthetic shards and draws, sigma' = K*gamma, gamma = 1, and the exact
  hinge duality gap at the ``--debugIter`` cadence.  Each round the rank
  solves its m shards in one call of the dense SDCA round
  (``ops/dense_sdca.py dense_sdca_round``, mode plus, sigma K: the B2
  kernel on ``--device=cuda``, its plain version on the CPU), where the
  JAX harness runs the numpy oracle shard by shard.  ``--overlapComm``
  posts the rank's dw as soon as its solve ends and collects its peers'
  on a collector thread (``distributed.async_host_allgather_bytes``);
  ``--staleRounds=S`` lets a peer's round-r dw join up to S rounds late
  (``solvers.cocoa.StaleJoinWindow``), draining at every eval and
  checkpoint, so the gap is certified on an exact w = w(alpha).  The
  contributions are applied in canonical (round, process) order,
  recomputed from their log, so every rank holds the same w bit for bit
  at a drained boundary and the trajectory is a function of round
  numbers alone, never of wall time.  Every exchange of this mode goes
  through the gang's store by key (``dw{t}``, ``ev{t}``, ``ck{t}``), none
  through a gloo collective.

Straggler fixtures: ``--stepSkew=S`` (worker i sleeps ``i*S`` more each
round) and ``--skewEvery=J`` (worker p sleeps S only on rounds with
``t % J == p % J``: a rotating straggler, which a staleness window can
absorb, where a constant one bounds the gang to its pace).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ALGORITHM = "ToyGang"
REAL_ALGORITHM = "GangCoCoA+"
# a dead peer must fail this worker well inside a test's time
TIMEOUT_S = 30.0
# the store's per-attempt wait in the real mode
KV_ATTEMPT_S = 2.0

# the phases a worker can block (or hide blocking) on in the gang's
# exchange: what the straggler slack of the A/B is summed over
# (tests/_gang_worker.py EXCHANGE_PHASES)
EXCHANGE_PHASES = ("kv_get", "kv_allgather", "kv_post", "exchange_join")


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
    from cocoa_torch.parallel import distributed
    from cocoa_torch.telemetry import events, recorder, tracing

    opts = parse(sys.argv[1:] if argv is None else argv)
    pid = int(opts.get("processId", 0))
    nproc = int(opts.get("numProcesses", 1))
    k = int(opts["numSplits"])

    stream = (recorder.worker_stream_path(opts["events"], pid)
              if opts.get("events") else None)
    metrics = opts.get("metrics") if pid == 0 else None
    if stream or metrics:
        events.get_bus().configure(jsonl_path=stream, metrics_path=metrics)
    if opts.get("trace"):
        tracing.configure(enabled=True, worker=pid)

    distributed.maybe_initialize(opts.get("master"), pid, nproc,
                                 timeout_s=TIMEOUT_S)
    try:
        if k % nproc != 0:
            print(f"error: K={k} shards cannot divide over {nproc} workers",
                  file=sys.stderr)
            return 2
        real = str(opts.get("real", "")).lower()
        if real in ("cocoa", "cocoa+"):
            return real_main(opts, pid, nproc)
        if real:
            print(f"error: --real takes 'cocoa', got {real!r}",
                  file=sys.stderr)
            return 2
        return toy_main(opts, pid, nproc)
    finally:
        distributed.shutdown()


def toy_main(opts, pid, nproc) -> int:
    import torch

    from cocoa_torch import checkpoint
    from cocoa_torch.parallel import distributed
    from cocoa_torch.telemetry import tracing

    k = int(opts["numSplits"])
    rounds = int(opts["numRounds"])
    ckdir = opts.get("chkptDir", "")
    ck_iter = int(opts.get("chkptIter", 5))
    step_s = float(opts.get("stepSeconds", 0.05))
    algorithm = opts.get("algorithm", ALGORITHM)
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
    print(f"{algorithm}: done at round {rounds}", flush=True)
    return 0


# --- the real-math CoCoA+ gang (--real=cocoa) --------------------------------


def shard_data(shard: int, n_rows: int, d: int, seed: int):
    """Synthetic (X, y) of one logical shard, keyed to the shard, never
    to its owner, so a shrunk gang makes the same data for the shards it
    inherits (tests/_gang_worker.py ``shard_data``, bit for bit)."""
    rng = np.random.default_rng(970_001 + 131 * shard + seed)
    X = rng.standard_normal((n_rows, d)) / np.sqrt(d)
    w_true = np.random.default_rng(7 + seed).standard_normal(d)
    y = np.where(X @ w_true >= 0.0, 1.0, -1.0)
    flips = rng.random(n_rows) < 0.08   # a non-separable margin band
    return X, np.where(flips, -y, y)


def round_idxs(t: int, shard: int, n_rows: int, h: int,
               seed: int) -> np.ndarray:
    """Round t's draws of one shard: a prefix of a fresh permutation,
    keyed to (round, shard) (tests/_gang_worker.py ``round_idxs``)."""
    rng = np.random.default_rng(seed * 1_000_003 + t * 9176 + shard)
    return rng.permutation(n_rows)[:h]


def skew_sleep(opts, pid, t) -> float:
    """The straggler fixture's extra sleep for worker ``pid`` at round
    ``t`` (see the module docstring)."""
    skew_s = float(opts.get("stepSkew", 0.0))
    every = int(opts.get("skewEvery", 0))
    if skew_s <= 0.0:
        return 0.0
    if every > 0:
        return skew_s if t % every == pid % every else 0.0
    return pid * skew_s


class GangCocoa:
    """One rank's state of the real-math gang (the JAX harness's
    ``_GangCocoa``): its m shards and alpha on ``device`` in ``dtype``,
    w and the contribution log on the host in float64."""

    def __init__(self, opts, pid, nproc, device, dtype):
        import torch

        self.pid = pid
        self.k = int(opts["numSplits"])
        self.m = self.k // nproc
        self.mine = range(pid * self.m, (pid + 1) * self.m)
        self.n_rows = int(opts.get("rowsPerShard", 48))
        self.d = int(opts.get("numFeatures", 24))
        self.h = int(opts.get("localIters", self.n_rows))
        self.lam = float(opts.get("lambda", 0.05))
        self.seed = int(opts.get("seed", 0))
        self.gamma = 1.0
        self.sigma = self.k * self.gamma      # the safe sigma' = K*gamma
        self.n = self.k * self.n_rows
        self.device, self.dtype = device, dtype
        data = [shard_data(s, self.n_rows, self.d, self.seed)
                for s in self.mine]
        # x.x as the JAX harness's oracle takes it, row by row
        sq = np.array([[float(x @ x) for x in X] for X, _ in data])
        self.X = torch.tensor(np.stack([X for X, _ in data]), dtype=dtype,
                              device=device)
        self.y = torch.tensor(np.stack([y for _, y in data]), dtype=dtype,
                              device=device)
        self.sq = torch.tensor(sq, dtype=dtype, device=device)
        self.alpha = torch.zeros((self.m, self.n_rows), dtype=dtype,
                                 device=device)
        # (round, process) -> gamma-unscaled dw; w is recomputed from it
        # in canonical (round, process) order on every change, so the
        # order of its float additions, and so w bit for bit, is the same
        # on every rank at a drained boundary, whenever each arrived
        self.contribs: dict = {}
        self.w_base = np.zeros(self.d)
        self.w = self.w_base.copy()

    def recompute_w(self):
        w = self.w_base.copy()
        for key in sorted(self.contribs):
            w = w + self.gamma * self.contribs[key]
        self.w = w

    def w_device(self):
        import torch

        return torch.tensor(self.w, dtype=self.dtype, device=self.device)

    def local_solve(self, t: int) -> np.ndarray:
        """Round t's H steps on the rank's m shards, one call of the dense
        SDCA round; returns the rank's dw on the host, the shards' dw
        summed in shard order.  alpha advances by gamma * dalpha, which
        at gamma = 1 is the round's own alpha."""
        import torch

        from cocoa_torch.ops.dense_sdca import dense_sdca_round

        idxs = torch.tensor(np.stack([
            round_idxs(t, s, self.n_rows, self.h, self.seed)
            for s in self.mine]), dtype=torch.int32, device=self.device)
        dw, self.alpha = dense_sdca_round(
            self.w_device(), self.alpha, self.X, self.y, self.sq, idxs,
            self.lam, self.n, mode="plus", sigma=self.sigma)
        # fetched on this thread, after the solve: the exchange carries
        # host bytes only
        dw = dw.cpu().numpy().astype(np.float64)
        dw_mine = np.zeros(self.d)
        for row in dw:
            dw_mine += row
        return dw_mine

    def absorb(self, r: int, parts: list):
        """Apply one joined round's peer contributions (the rank's own
        round-r dw was logged at solve time: an owner never sees its own
        progress late)."""
        for q, payload in enumerate(parts):
            if q == self.pid:
                continue
            self.contribs[(r, q)] = np.frombuffer(payload, np.float64)
        self.recompute_w()

    def partials(self):
        """The rank's share of the certificate's sums: the hinge losses
        of its rows and the sum of its alpha, shard by shard."""
        import torch

        margins = self.y * torch.einsum("knd,d->kn", self.X,
                                        self.w_device())
        hinge = torch.clamp(1.0 - margins, min=0.0)
        loss = 0.0
        a_sum = 0.0
        for j in range(self.m):
            loss += float(hinge[j].sum())
            a_sum += float(self.alpha[j].sum())
        return loss, a_sum

    def gap_from_totals(self, loss_total: float, alpha_total: float):
        """The exact hinge duality gap on the actual (w, alpha): P(w) -
        D(alpha) with w = w(alpha) at a drained boundary."""
        wsq = float(self.w @ self.w)
        primal = 0.5 * self.lam * wsq + loss_total / self.n
        dual = alpha_total / self.n - 0.5 * self.lam * wsq
        return primal, primal - dual

    def alpha_bytes(self) -> bytes:
        return self.alpha.cpu().numpy().astype(np.float64).tobytes()

    def alpha_full(self, parts: list) -> np.ndarray:
        """(K, rowsPerShard) alpha from the ranks' blocks."""
        out = np.zeros((self.k, self.n_rows))
        for q, payload in enumerate(parts):
            out[q * self.m:(q + 1) * self.m] = np.frombuffer(
                payload, np.float64).reshape(self.m, self.n_rows)
        return out


def real_main(opts, pid, nproc) -> int:
    import torch

    from cocoa_torch import checkpoint
    from cocoa_torch.device import resolve_device
    from cocoa_torch.parallel import distributed
    from cocoa_torch.solvers.cocoa import StaleJoinWindow
    from cocoa_torch.telemetry import events, tracing

    rounds = int(opts["numRounds"])
    ckdir = opts.get("chkptDir", "")
    ck_iter = int(opts.get("chkptIter", 0))
    debug_iter = int(opts.get("debugIter", 5))
    gap_target = (float(opts["gapTarget"]) if opts.get("gapTarget")
                  else None)
    step_s = float(opts.get("stepSeconds", 0.0))
    stale = int(opts.get("staleRounds", 0))
    overlap_flag = str(opts.get("overlapComm", "off")).lower()
    if overlap_flag not in ("auto", "on", "off", "true"):
        print(f"error: --overlapComm must be auto|on|off, got "
              f"{overlap_flag!r}", file=sys.stderr)
        return 2
    overlap = (overlap_flag in ("on", "true")
               or (overlap_flag == "auto" and nproc > 1))
    if ck_iter > 0 and debug_iter > 0 and ck_iter % debug_iter != 0:
        # checkpoints land on drained boundaries (w = w(alpha) exactly, so
        # a resumed generation never holds a half-joined round)
        print(f"error: --chkptIter ({ck_iter}) must be a multiple of "
              f"--debugIter ({debug_iter}) in --real=cocoa mode "
              f"(checkpoints land on drained eval boundaries)",
              file=sys.stderr)
        return 2
    dtypes = {"float64": torch.float64, "float32": torch.float32}
    if opts.get("dtype", "float64") not in dtypes:
        print(f"error: --dtype must be float64|float32, got "
              f"{opts['dtype']!r}", file=sys.stderr)
        return 2
    device = distributed.rank_device(pid, resolve_device(
        opts.get("device", "cuda")))

    gang = GangCocoa(opts, pid, nproc, device,
                     dtypes[opts.get("dtype", "float64")])
    window = StaleJoinWindow(stale, algorithm=REAL_ALGORITHM)
    bus = events.get_bus()
    kv = dict(timeout_s=TIMEOUT_S, attempt_s=KV_ATTEMPT_S)

    start = 1
    if "resume" in opts and ckdir:
        path = checkpoint.latest(ckdir, REAL_ALGORITHM)
        if path is not None:
            meta, w0, a0 = checkpoint.load(path)
            gang.w_base = np.array(w0, np.float64)
            gang.recompute_w()
            gang.alpha = torch.tensor(
                np.asarray(a0, np.float64)[gang.mine.start:gang.mine.stop],
                dtype=gang.dtype, device=device)
            start = meta["round"] + 1
            print(f"resuming {REAL_ALGORITHM} from round {meta['round']} "
                  f"({path})", flush=True)

    gap = None
    stopped = None
    t = start - 1
    for t in range(start, rounds + 1):
        with tracing.span("round", round=t):
            with tracing.span("local_solve", round=t):
                dw_mine = gang.local_solve(t)
                extra = step_s + skew_sleep(opts, pid, t)
                if extra > 0:
                    time.sleep(extra)
            # the rank's own contribution lands now (its view advances);
            # the posted payload frees the peers the moment the solve ends
            gang.contribs[(t, pid)] = dw_mine
            gang.recompute_w()
            payload = dw_mine.tobytes()
            if overlap:
                handle = distributed.async_host_allgather_bytes(
                    f"dw{t}", payload, trace_attrs={"round": t}, **kv)
            else:
                handle = distributed.kv_allgather_bytes(f"dw{t}", payload,
                                                        **kv)
            window.admit(t, handle)
            for r, parts, _late in window.join_due(t):
                gang.absorb(r, parts)

        if debug_iter > 0 and t % debug_iter == 0:
            # an eval boundary: drain first, so the certificate sees the
            # exact w = w(alpha) pair
            for r, parts, _late in window.drain(t):
                gang.absorb(r, parts)
            with tracing.span("eval", round=t):
                loss, a_sum = gang.partials()
                parts = distributed.kv_allgather_bytes(
                    f"ev{t}", np.array([loss, a_sum]).tobytes(), **kv)
                totals = np.sum([np.frombuffer(p, np.float64)
                                 for p in parts], axis=0)
                primal, gap = gang.gap_from_totals(totals[0], totals[1])
            bus.emit("round_eval", algorithm=REAL_ALGORITHM, t=t,
                     primal=primal, gap=gap, test_error=None, sigma=None,
                     stall=None)
            if pid == 0:
                print(f"{REAL_ALGORITHM}: round {t} gap {gap:.3e}",
                      flush=True)
            window.on_eval(gap)
            if ckdir and ck_iter > 0 and t % ck_iter == 0:
                parts = distributed.kv_allgather_bytes(
                    f"ck{t}", gang.alpha_bytes(), **kv)
                if pid == 0:
                    checkpoint.save(ckdir, REAL_ALGORITHM, t, gang.w,
                                    gang.alpha_full(parts), seed=gang.seed)
            if gap_target is not None and gap <= gap_target:
                stopped = "target"
                break

    # a fixed-round run may still hold joins for its last rounds: land
    # them, so the final state is drained
    for r, parts, _late in window.drain(t):
        gang.absorb(r, parts)
    joined = {(r, q) for r in range(start, t + 1) for q in range(nproc)}
    if set(gang.contribs) != joined:
        print(f"error: rounds that never joined: "
              f"{sorted(joined - set(gang.contribs))}", file=sys.stderr)
        return 1
    # every rank is past its last store read before rank 0, which hosts
    # the store, leaves
    if distributed.initialized():
        torch.distributed.barrier()
    bus.emit("run_end", algorithm=REAL_ALGORITHM, stopped=stopped,
             gap=gap, round=t)
    print(f"{REAL_ALGORITHM}: done at round {t}"
          + (f" (gap {gap:.3e})" if gap is not None else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
