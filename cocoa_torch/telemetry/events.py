"""The host-side event bus and the device rows' decoder (the port's copy
of cocoa_tpu/telemetry/events.py).

One process-global :class:`EventBus` carries every run's structured
telemetry: typed records appended to a JSONL sink (one JSON object per
line, ``seq``-ordered) and fanned out synchronously to subscribers (the
metrics writer, the round-windowed profiler, the flight recorder,
tests).  The bus is inert until configured — ``emit`` on an inactive bus
is a no-op costing one attribute read, so the training hot paths carry
no telemetry tax by default.

The device loop (``--deviceLoop``, solvers/base.py ``drive_device``)
computes one ``[primal, gap, test_err, sigma_stage, stall, theta_stage,
restarts]`` row per eval on the card and reads a super-block's rows
back in its one fetch.  There is no live bridge out of a super-block:
the host replays the fetched rows through a :class:`DeviceTap`, the
JAX package's fetch-fallback bridge, which emits the same events the
chunked loop's host evals do, at each super-block's fetch.  The tap
only reads rows the loop already fetched, so telemetry adds no read of
the card and cannot perturb the run.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import threading
import time

import numpy as np

EVENT_TYPES = (
    "run_start",        # manifest: full config + config hash + torch/device info
    "round_eval",       # one debugIter-cadence evaluation
    "sigma_backoff",    # the σ′ anneal schedule backed off a stage
    "checkpoint_write", # a round-stamped checkpoint landed on disk
    "restart",          # sigma=auto trial rerun, or an elastic gang restart
    "divergence",       # the stall watch bailed the run out
    "run_end",          # final summary (primal, gap, stopped reason)
    "compile",          # one CUDA graph capture or nvcc build
                        # (analysis/sanitize.py record_compile; the JAX
                        # package's are XLA compiles)
    "host_transfer",    # one sanctioned device→host fetch
                        # (analysis/sanitize.py intended_fetch: an eval's,
                        # a super-block's, the fleet's, a serving batch's)
    "momentum_restart", # --accel: a gap rise reset the outer momentum
    "theta_stage",      # --accel: the Θ local-accuracy ladder stepped up
    "ingest",           # one loaded LIBSVM file (data/ingest.IngestReport:
                        # mode, parse seconds, bytes read, rows/nnz this
                        # process materialized, peak host RSS, and the
                        # --ingestCache outcome: off|hit|partial|miss)
    "ingest_cache",     # one file's --ingestCache outcome in detail
                        # (data/slab_cache.py, docs/DESIGN.md §18):
                        # shards served warm vs total, bytes mapped,
                        # seconds the cache saved — what feeds
                        # cocoa_ingest_cache_hits_total /
                        # cocoa_ingest_cache_bytes
    "ingest_cache_corrupt",  # a cache artifact failed validation on
                        # load (torn/truncated/drifted file): the
                        # artifact is evicted and the shard falls back
                        # to a cold parse — never a crash, never a
                        # silently wrong slab
    "gang_resize",      # the elastic supervisor reformed the gang at
                        # P′ < P survivors (shrink-to-survivors,
                        # cocoa_tpu/elastic.py, docs/DESIGN.md §13)
    "checkpoint_corrupt",  # a checkpoint generation failed validation on
                        # load; the reader fell back to the previous one
                        # (checkpoint.latest)
    "span",             # one closed tracing span (telemetry/tracing.py):
                        # phase + worker + wall start + monotonic
                        # duration + call-site attributes — what
                        # trace_report.py assembles into the gang
                        # timeline / critical path / straggler table
    "events_rotate",    # the JSONL sink hit its size cap and rolled the
                        # full file to `<path>.1` (first event of the
                        # fresh file, so the rotation itself is in the
                        # machine-readable record)
    "comm_overlap",     # one joined overlapped exchange (--overlapComm,
                        # parallel/distributed.ExchangeHandle): hidden_s
                        # = exchange wall-clock that ran concurrently
                        # with the caller's compute, wait_s = the
                        # residual blocking wait at the join barrier
    "stale_join",       # a bounded-staleness contribution joined late
                        # (--staleRounds, solvers/cocoa.StaleJoinWindow):
                        # round r's Δw applied at round t = r +
                        # rounds_late, rounds_late <= S by construction
    "fleet_progress",   # one fleet eval boundary (--fleet,
                        # solvers/fleet.py): live tenant lanes +
                        # cumulative certifications; the final event of a
                        # fleet run also carries models_per_second —
                        # what feeds cocoa_fleet_tenants_active /
                        # cocoa_fleet_models_per_second
    "tenant_certified", # one tenant crossed its duality-gap target
                        # inside the fleet's vmapped loop — what feeds
                        # cocoa_tenants_certified_total
    "serve_request",    # one scored serving batch (--serve,
                        # serving/batcher.py): n real requests, the
                        # static bucket they padded into, fill ratio,
                        # queue vs device seconds, per-request latency
                        # max/mean, and the model round that answered —
                        # what feeds cocoa_serve_qps /
                        # cocoa_serve_latency_seconds /
                        # cocoa_serve_batch_fill_ratio
    "model_swap",       # the serving watcher published a new validated
                        # checkpoint generation into the live model slot
                        # (serving/watcher.py): round, path, certified
                        # gap, and the certificate's birth timestamp —
                        # what anchors cocoa_model_gap_age_seconds
    "model_quantize",   # one --serveDtype publish decision
                        # (serving/scorer.ModelSlots._publish): the
                        # configured serve dtype, the form actually
                        # published (== serve dtype, or f32 on a
                        # certificate fallback), the measured
                        # f32-vs-quantized margin-error bound over the
                        # calibration batch, its size, and the int8
                        # scale — what feeds
                        # cocoa_serve_margin_error_bound /
                        # cocoa_serve_dtype_fallbacks_total
    "serve_shed",       # the fleet router refused one request line at
                        # admission (serving/router.py): routing
                        # policy, the tenant (None when untagged), the
                        # best live replica's inflight depth and
                        # projected wait vs the SLA — what feeds
                        # cocoa_serve_shed_total
    "replica_state",    # one fleet replica liveness transition
                        # (serving/router.py / fleet.py): replica name,
                        # state (live / dead / requeue), live count
                        # after the transition, and whether a request
                        # line was requeued by it — what feeds
                        # cocoa_serve_replicas_live /
                        # cocoa_serve_requeue_total
    "query_trace",      # one sampled end-to-end query trace
                        # (--traceSample, docs/DESIGN.md §22): the
                        # client-chosen trace id plus per-hop seconds —
                        # router queue, forward (network + relay),
                        # replica admission queue, device dispatch,
                        # protocol parse/serialize — stamped with the
                        # answering model generation, its gap age, the
                        # serving dtype, the bucket, and how many times
                        # the line requeued.  Emitted by the router in
                        # fleet mode (it sees the whole lifecycle) and
                        # by the solo server otherwise — what feeds
                        # cocoa_query_traces_total and what
                        # trace_report --queries assembles into the
                        # per-hop waterfall
    "slo_status",       # one /slo evaluation (telemetry/aggregate.py):
                        # rolling SLA attainment over the fleet-wide
                        # latency histogram plus the fast/slow
                        # multi-window burn rates against the
                        # attainment objective — the ops plane's
                        # machine-readable answer to "is the fleet
                        # inside its SLA right now"
)


def _clean(v):
    """JSON-safe scalars: numpy numerics → python, NaN → None (JSON has no
    NaN; a NaN metric means 'not applicable' everywhere in this codebase)."""
    if isinstance(v, np.ndarray) and v.ndim == 0:
        v = v.item()
    if isinstance(v, np.floating):
        v = float(v)
    if isinstance(v, np.integer):
        v = int(v)
    if isinstance(v, float) and math.isnan(v):
        return None
    if isinstance(v, dict):
        return {k: _clean(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_clean(x) for x in v]
    return v


class EventBus:
    """Ordered, typed event stream with a JSONL sink and subscribers.

    ``emit`` is thread-safe (a metrics timer and the main thread may
    meet here).  Subscriber callbacks run inline under the lock — they
    must be cheap (the metrics writer's atomic rewrite at eval rates).
    """

    def __init__(self):
        self._lock = threading.RLock()
        self.jsonl_path = None
        self.metrics_path = None
        self.metrics_writer = None   # the MetricsWriter configure()
        # attached (None otherwise) — owners that need more than the
        # subscriber protocol (the serving loop's gap-age heartbeat)
        # reach it here instead of poking _subscribers
        self.max_bytes = None
        self._subscribers = []
        self._seq = 0

    def configure(self, jsonl_path=None, metrics_path=None,
                  max_bytes=None, metrics_interval_s=0.0):
        """Attach sinks; either may be None.  The metrics path attaches a
        :class:`cocoa_torch.telemetry.metrics.MetricsWriter` subscriber
        (``metrics_interval_s`` is its write-debounce window).  The
        capture watch's compile→event bridge is installed here too
        (analysis/sanitize.py ``install_compile_events``), so every run
        with a sink counts its captures and nvcc builds.

        ``max_bytes`` (``--eventsMaxMB``): size cap on the JSONL sink —
        when an append pushes the file past it, the full file atomically
        rolls to ``<path>.1`` (replacing any previous rollover) and the
        fresh file opens with a typed ``events_rotate`` event, so a
        long serving/elastic run holds at most ~2× the cap on disk
        instead of growing without bound."""
        from cocoa_torch.analysis import sanitize

        sanitize.install_compile_events(self)
        with self._lock:
            self.jsonl_path = jsonl_path or None
            if max_bytes is not None:
                self.max_bytes = int(max_bytes) or None
            if metrics_path and metrics_path != self.metrics_path:
                from cocoa_torch.telemetry.metrics import MetricsWriter

                self.metrics_writer = MetricsWriter(
                    metrics_path, flush_interval_s=metrics_interval_s)
                self.subscribe(self.metrics_writer)
                self.metrics_path = metrics_path
        return self

    def active(self) -> bool:
        return bool(self.jsonl_path or self._subscribers)

    def subscribe(self, fn):
        with self._lock:
            self._subscribers.append(fn)
        return fn

    def unsubscribe(self, fn):
        with self._lock:
            if fn in self._subscribers:
                self._subscribers.remove(fn)

    def reset(self):
        """Detach every sink and zero the sequence (tests)."""
        with self._lock:
            self.jsonl_path = None
            self.metrics_path = None
            if self.metrics_writer is not None:
                self.metrics_writer.stop_heartbeat()
            self.metrics_writer = None
            self.max_bytes = None
            self._subscribers = []
            self._seq = 0

    def saved(self) -> tuple:
        """What :meth:`configure` and :meth:`subscribe` change (the sinks,
        the cap, the subscribers), for :meth:`restore`: the CLI puts the
        bus back as it found it when a run returns, so a second run in
        the same process starts from the caller's bus."""
        with self._lock:
            return (self.jsonl_path, self.metrics_path, self.metrics_writer,
                    self.max_bytes, list(self._subscribers))

    def restore(self, saved: tuple):
        """Put back what :meth:`saved` returned; a metrics writer attached
        since then writes what it holds and stops its timers."""
        with self._lock:
            if (self.metrics_writer is not None
                    and self.metrics_writer is not saved[2]):
                self.metrics_writer.flush()
                self.metrics_writer.stop_heartbeat()
            (self.jsonl_path, self.metrics_path, self.metrics_writer,
             self.max_bytes, subscribers) = saved
            self._subscribers = list(subscribers)

    def emit(self, event: str, **fields):
        """Append one typed record; returns it (or None when inactive).

        The record is sanitized ONCE (numpy scalars → python, NaN → None)
        so the JSONL line and every subscriber see identical values."""
        if not self.active():
            return None
        if event not in EVENT_TYPES:
            raise ValueError(f"unknown event type {event!r}; "
                             f"expected one of {EVENT_TYPES}")
        reserved = {"event", "seq", "pid", "ts"} & fields.keys()
        if reserved:
            # a payload field named like the envelope would silently
            # overwrite it — the model_swap 'seq' collision class of bug
            raise ValueError(f"event field(s) {sorted(reserved)} collide "
                             f"with the record envelope; rename them")
        with self._lock:
            self._seq += 1
            # pid identifies the EMITTER: a supervised run interleaves
            # several processes' appends (elastic supervisor + worker
            # generations, each with its own seq counter) in one JSONL,
            # and the schema checker orders per emitter
            rec = {"event": event, "seq": self._seq, "pid": os.getpid(),
                   "ts": time.time(),
                   **{k: _clean(v) for k, v in fields.items()}}
            rotated = None
            if self.jsonl_path:
                # open-append per event: whole-line writes interleave
                # safely with other emitters of the same file (the elastic
                # supervisor appends restart events between generations)
                with open(self.jsonl_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                    size = f.tell()
                if (self.max_bytes and size >= self.max_bytes
                        and event != "events_rotate"):
                    rotated = self._rotate(size)
            for fn in list(self._subscribers):
                fn(rec)
            if rotated is not None:
                for fn in list(self._subscribers):
                    fn(rotated)
        return rec

    def _rotate(self, size: int):
        """Roll the full JSONL sink to ``<path>.1`` (atomic rename,
        replacing any previous rollover — the cap bounds disk at ~2×,
        it does not archive history) and open the fresh file with a
        typed ``events_rotate`` record.  Caller holds the lock.

        Concurrent emitters: each shared file has exactly ONE rotating
        owner (cli.py arms ``max_bytes`` on the workers only — the
        supervisor appends to worker 0's file uncapped), so the re-stat
        below is a belt-and-suspenders guard, not the coordination
        mechanism: if the file on disk is already below the cap, some
        other process rotated between our append and now — renaming
        again would clobber the just-archived ``.1`` with a near-empty
        fresh file."""
        rolled = self.jsonl_path + ".1"
        try:
            if os.path.getsize(self.jsonl_path) < self.max_bytes:
                return None
            os.replace(self.jsonl_path, rolled)
        except OSError:
            return None  # the file vanished under us — nothing to roll
        self._seq += 1
        rec = {"event": "events_rotate", "seq": self._seq,
               "pid": os.getpid(), "ts": time.time(),
               "path": self.jsonl_path, "rotated_to": rolled,
               "bytes": int(size)}
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec


_BUS = EventBus()


def get_bus() -> EventBus:
    """The process-global bus every emitter and sink shares."""
    return _BUS


def host_fetch(t, label: str) -> np.ndarray:
    """``t`` copied to the host as a numpy array, a deliberate read of
    the device through analysis/sanitize.py ``intended_fetch``: counted,
    with a ``host_transfer`` event labelled ``label`` when the bus is
    active, and open inside a guarded region.  The copy waits for the
    work queued before it."""
    from cocoa_torch.analysis import sanitize

    with sanitize.intended_fetch(label):
        return t.detach().cpu().numpy()


# --- run manifest -----------------------------------------------------------


def config_hash(config: dict) -> str:
    """Stable short hash of a config mapping (the run's identity in the
    manifest and the trajectory header)."""
    blob = json.dumps(_clean(config), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def environment_manifest(device=None, mesh=None) -> dict:
    """torch/device provenance for the run manifest and the trajectory
    header: ``device`` is the run's device; None reads the default CUDA
    device when there is one (``device_kind`` the card's name).  A gang's
    ``mesh`` (parallel/mesh.py) gives the process count and the device
    group's backend."""
    import torch

    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {
        "torch_version": torch.__version__,
        "backend": dev.type,
        "device_count": (torch.cuda.device_count() if dev.type == "cuda"
                         else 1),
        "device_kind": kind,
        "process_count": 1 if mesh is None else mesh.size,
        **({} if mesh is None else {"process_index": mesh.rank,
                                    "device_group": mesh.backend}),
    }


def run_manifest(config: dict, dataset=None, device=None,
                 mesh=None) -> dict:
    """The ``run_start`` payload: the full config, its hash, and the
    torch/device environment of ``device`` (and of the gang's ``mesh``)."""
    return {
        "dataset": dataset,
        "config": _clean(config),
        "config_hash": config_hash(config),
        **environment_manifest(device, mesh),
    }


# --- the device rows' decoder -------------------------------------------


class DeviceTap:
    """Decode device eval rows into bus events.

    The device loop replays each super-block's fetched rows through one
    tap (JAX's fetch-fallback bridge), so its events are those the JAX
    package's device loop emits, at each fetch.

    Row layout (solvers/base.py ``ROW_COLS``, ``ladder_step``):
    ``[primal, gap, test_err, sigma_stage, stall, theta_stage,
    restarts]`` — gap/test_err NaN when not applicable, sigma_stage NaN
    outside σ′-anneal runs, theta_stage/restarts NaN outside ``--accel``
    runs (and absent entirely on pre-widening 5-col rows, which decode
    unchanged).

    ``init_stage`` / ``init_theta_stage`` / ``init_restarts`` seed
    transition detection with the values the state ENTERED the super-block
    at (the previous super-block's last row, or the host's sched vector
    before the first), so a resumed or multi-block run never fabricates a
    backoff / Θ-step / restart event for its first eval.
    """

    def __init__(self, bus, algorithm: str, start_round: int, cadence: int,
                 sigma_levels=None, init_stage=None, theta_hs=None,
                 init_theta_stage=None, init_restarts=None):
        self.bus = bus
        self.algorithm = algorithm
        self.start_round = start_round
        self.cadence = cadence
        self.levels = sigma_levels
        self._prev_stage = init_stage
        self.theta_hs = theta_hs
        self._prev_theta = init_theta_stage
        self._prev_restarts = init_restarts
        self.count = 0

    def __call__(self, i, row):
        r = np.asarray(row, dtype=np.float64)
        t = self.start_round - 1 + (int(i) + 1) * self.cadence
        primal, gap, test_err, stage_f, stall = (float(v) for v in r[:5])
        stage = None if math.isnan(stage_f) else int(stage_f)
        sigma = (self.levels[stage]
                 if self.levels is not None and stage is not None else None)
        self.bus.emit(
            "round_eval", algorithm=self.algorithm, t=t, primal=primal,
            gap=gap, test_error=test_err, sigma=sigma, sigma_stage=stage,
            stall=None if math.isnan(stall) else int(stall),
        )
        if (stage is not None and self._prev_stage is not None
                and stage != self._prev_stage):
            self.bus.emit(
                "sigma_backoff", algorithm=self.algorithm, t=t,
                sigma=sigma, from_sigma=self.levels[self._prev_stage],
                stage=stage,
            )
        if stage is not None:
            self._prev_stage = stage
        if r.shape[0] >= 7:
            theta_f, restarts_f = float(r[5]), float(r[6])
            theta = None if math.isnan(theta_f) else int(theta_f)
            restarts = None if math.isnan(restarts_f) else int(restarts_f)
            if (restarts is not None and self._prev_restarts is not None
                    and restarts > self._prev_restarts):
                self.bus.emit("momentum_restart", algorithm=self.algorithm,
                              t=t, restarts_total=restarts)
            if restarts is not None:
                self._prev_restarts = restarts
            if (theta is not None and self._prev_theta is not None
                    and theta != self._prev_theta):
                self.bus.emit(
                    "theta_stage", algorithm=self.algorithm, t=t,
                    stage=theta,
                    h=(self.theta_hs[theta]
                       if self.theta_hs is not None else None))
            if theta is not None:
                self._prev_theta = theta
        self.count += 1
