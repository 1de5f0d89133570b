"""Prometheus-style textfile metrics, refreshed on every bus event (the
port's copy of cocoa_tpu/telemetry/metrics.py, every family; the port
emits no ``compile`` or ``host_transfer`` events, so their counters stay
0, and only a later supervisor writes the ``gang`` family).

The contract (docs/DESIGN.md §Observability): a single plain-text file in
the Prometheus exposition format, rewritten ATOMICALLY (temp + rename, the
node-exporter textfile-collector convention) on every event — or, with a
``flush_interval_s`` debounce, at most once per interval plus a trailing
timer flush (``--metricsInterval``; run boundaries and recovery
transitions always write immediately) — so the elastic supervisor's
stall watchdog and any external scraper can watch a run that is
otherwise one opaque device dispatch:

- ``cocoa_rounds_total``        counter — training rounds advanced
- ``cocoa_evals_total``         counter — debugIter-cadence evaluations
- ``cocoa_sigma_backoffs_total``counter — σ′ anneal backoffs
- ``cocoa_restarts_total``      counter — trial reruns + gang restarts
- ``cocoa_momentum_restarts_total`` counter — --accel gap-monitored
  momentum restarts (the extrapolation reset to the certified iterate)
- ``cocoa_theta_stage``         gauge   — --accel Θ local-accuracy ladder
  stage currently in effect (inner-step count rises with it)
- ``cocoa_compiles_total``      counter — finished XLA compiles (the
  analysis/sanitize.py bridge).  The sanitizer invariant made
  observable: after warmup this must flatline — growth mid-run means a
  shape or config is silently retracing every super-block
- ``cocoa_host_transfers_total``counter — sanctioned device→host fetch
  points (``intended_fetch``).  The drive loop's contract is ~1 per
  super-block; per-ROUND growth means a host sync leaked into the loop
- ``cocoa_ingest_seconds``      gauge   — cumulative data-ingest parse
  seconds this process spent (train + test files; the ``ingest`` event)
- ``cocoa_ingest_bytes``        gauge   — cumulative bytes this process
  read to ingest data (streamed runs read ~2/P of the file vs the whole
  of it — the streaming win, observable)
- ``cocoa_ingest_cache_hits_total`` counter — shards served warm from
  the ``--ingestCache`` slab cache (the ``ingest_cache`` event;
  rendered only once a cache-armed run reported).
  ``cocoa_ingest_cache_bytes`` gauge (cumulative artifact bytes mapped)
  and ``cocoa_ingest_cache_corrupt_total`` counter (artifacts evicted
  by load validation — any nonzero value deserves a disk look) ride
  alongside
- ``cocoa_gang_size``           gauge   — current elastic gang size after
  a shrink-to-survivors resize (the ``gang_resize`` event; absent until
  the first resize — the configured size is in the run manifest)
- ``cocoa_gang_generations_total`` counter — elastic gang generations
  launched (initial + every restart/resize; from the ``generation`` field
  the supervisor stamps on restart/resize events)
- ``cocoa_restart_backoff_seconds`` gauge — the backoff the supervisor
  slept before the most recent relaunch (exponential with jitter, reset
  on progress — a rising value means a crash loop, a reset means the run
  advanced)
- ``cocoa_checkpoint_corrupt_total`` counter — checkpoint generations
  rejected by validation on load (the reader fell back to the previous
  generation; any nonzero value deserves a disk/preemption look)
- ``cocoa_phase_seconds{phase=...}`` gauge — cumulative seconds this
  process spent in each traced phase (the ``span`` events of
  telemetry/tracing.py; present only on ``--trace`` runs).  The
  cross-worker straggler gauges (``cocoa_straggler_slack_seconds``)
  come from telemetry/trace_report.py, which merges every process's
  stream
- ``cocoa_overlap_hidden_seconds`` gauge — cumulative exchange
  wall-clock hidden behind the caller's compute by ``--overlapComm``
  (the ``comm_overlap`` events; present only once an overlapped
  exchange has joined).  ``cocoa_overlap_wait_seconds`` alongside it is
  the residual blocking wait the overlap did NOT hide — the pair is
  the overlap's measured win
- ``cocoa_stale_joins_total{rounds_late=...}`` counter — bounded-
  staleness contributions joined late, labeled by how many rounds late
  (``--staleRounds``; the ``stale_join`` events — never exceeds S by
  construction, which makes the label set finite)
- ``cocoa_fleet_tenants_active`` gauge — tenant lanes still training in
  the current ``--fleet`` run (the ``fleet_progress`` events; certified
  tenants mask out of the update, so this is the live-lane count)
- ``cocoa_tenants_certified_total`` counter — tenants whose duality gap
  crossed their target (the ``tenant_certified`` events)
- ``cocoa_fleet_models_per_second`` gauge — the fleet run's headline
  throughput: tenants certified per wall-clock second through the ONE
  compiled vmapped round (carried by the final ``fleet_progress``)
- ``cocoa_serve_qps``           gauge — serving throughput: requests
  answered per second, averaged over the lifetime of the serving run
  (the ``serve_request`` events; 1 s floor on the denominator so a
  single burst cannot render an absurd rate).  Present only once a
  serve run has answered.  ``cocoa_serve_requests_total`` /
  ``cocoa_serve_batches_total`` counters ride alongside
- ``cocoa_serve_latency_seconds`` histogram — per-batch WORST request
  latency (admission to answer).  Charging every batch its max is the
  conservative SLA accounting: the rendered p99 upper-bounds the true
  per-request p99
- ``cocoa_serve_batch_fill_ratio`` gauge — real requests / padded
  bucket slots, cumulative: how much of the compiled dispatch work is
  real.  Low fill under load means the bucket ladder or the admission
  window is mis-tuned
- ``cocoa_model_swaps_total``   counter — validated checkpoint
  generations hot-swapped into the live serving slot (``model_swap``)
- ``cocoa_serve_margin_error_bound`` gauge — the live ``--serveDtype``
  certificate: the measured f32-vs-quantized margin-error bound of the
  most recent publish over its calibration batch (the
  ``model_quantize`` events; present only once a quantized serve run
  published).  ``cocoa_serve_dtype_fallbacks_total`` counter rides
  alongside — publishes whose bound could flip the weakest calibrated
  margin's sign, so the swap served f32 instead; a steadily climbing
  value means the trained models stopped surviving quantization and
  the serve dtype should be revisited
- ``cocoa_serve_replicas_live`` gauge — fleet replicas currently
  routable (the ``replica_state`` events, serving/router.py); present
  only once a fleet router ran.  ``cocoa_serve_shed_total`` counter —
  request lines refused at admission because every live replica
  projected past the shed budget; ``cocoa_serve_requeue_total``
  counter — request lines replayed off a dead replica onto a live one
  (the requeue-never-fail recovery path, docs/DESIGN.md §21)
- ``cocoa_model_gap_age_seconds`` gauge — freshness of the SERVING
  model: seconds (at render time) since the live model's certificate —
  its checkpoint — was produced.  A healthy background trainer keeps
  this bounded by its checkpoint cadence; a climbing value is a dead or
  wedged trainer, visible long before anyone reads a stale margin.
  Because the value is computed at write time, the serving loop arms
  :meth:`MetricsWriter.start_heartbeat` — a periodic unconditional
  rewrite — so the gauge keeps climbing even when no events arrive
  (a dead trainer + an idle server is exactly the alert scenario)
- ``cocoa_last_gap``            gauge   — most recent duality gap
- ``cocoa_round_seconds``       histogram — observed per-round wall time
  (host-clock deltas between consecutive evals divided by the rounds
  between them; on the device-resident path these are the times the
  super-block's rows were decoded at its fetch — the only per-round
  timing that path can observe)

Counters are process-lifetime (a CLI invocation runs several algorithms;
their rounds accumulate).  The writer is a plain bus subscriber —
``EventBus.configure(metrics_path=...)`` attaches it.
"""

from __future__ import annotations

import os
import threading
import time

BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
           0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# events whose state change must be visible immediately regardless of the
# write debounce: run boundaries, bail-outs, and every supervisor-visible
# recovery transition (the stall watchdog reads this file as a progress
# token — a debounced restart/resize would blind it exactly when it
# matters)
_FLUSH_EVENTS = frozenset((
    "run_start", "run_end", "divergence", "restart", "gang_resize",
    "checkpoint_corrupt", "events_rotate",
))


class MetricsWriter:
    def __init__(self, path: str, families: str = "all",
                 flush_interval_s: float = 0.0):
        # families="gang": render ONLY the supervisor-owned gang families
        # (cocoa_gang_size / cocoa_gang_generations_total /
        # cocoa_restart_backoff_seconds) — the elastic supervisor's
        # sibling `<metrics>.gang` textfile must not duplicate worker
        # 0's series (a textfile collector globbing the directory
        # rejects duplicate families, and the counters would mean
        # different things in each file).  "all" (workers, single
        # process) renders everything, with the gang families gated on
        # having actually seen gang data for the same reason.
        # flush_interval_s > 0: coalesce textfile rewrites to at most one
        # per interval (plus a trailing timer flush, so the file always
        # converges to the final state within one interval even when the
        # event stream stops).  The default 0.0 keeps the original
        # behavior — one atomic rewrite per event — which is already
        # right at eval cadence; span-heavy or tight-cadence runs pass
        # --metricsInterval so a µs-scale event burst costs one rename,
        # not hundreds.  _FLUSH_EVENTS bypass the debounce either way.
        if families not in ("all", "gang"):
            raise ValueError(f"families must be all|gang, got {families!r}")
        self.families = families
        self.path = path
        self.flush_interval_s = float(flush_interval_s)
        self._lock = threading.RLock()
        self._last_write = 0.0
        self._dirty = False
        self._timer = None
        self._hb_timer = None       # start_heartbeat's repeating timer
        self._hb_interval = None
        self.rounds_total = 0
        self.evals_total = 0
        self.sigma_backoffs_total = 0
        self.restarts_total = 0
        self.momentum_restarts_total = 0
        self.gang_size = None
        self.gang_generations_total = 0
        self.restart_backoff_seconds = None
        self.checkpoint_corrupt_total = 0
        self.theta_stage = None
        self.compiles_total = 0
        self.host_transfers_total = 0
        self.ingest_seconds = 0.0
        self.ingest_bytes = 0
        self.ingest_cache_seen = False
        self.ingest_cache_hits_total = 0
        self.ingest_cache_bytes = 0
        self.ingest_cache_corrupt_total = 0
        self.phase_seconds: dict = {}   # span phase -> cumulative seconds
        self.overlap_hidden_seconds = 0.0
        self.overlap_wait_seconds = 0.0
        self.overlap_joins_total = 0
        self.stale_joins: dict = {}     # rounds_late -> count
        self.fleet_tenants_active = None
        self.tenants_certified_total = 0
        self.fleet_models_per_second = None
        self.serve_requests_total = 0
        self.serve_batches_total = 0
        self.serve_slots_total = 0      # Σ bucket — the fill denominator
        self.serve_first_ts = None
        self.serve_last_ts = None
        self.serve_lat_buckets = [0] * (len(BUCKETS) + 1)
        self.serve_lat_sum = 0.0
        self.serve_lat_count = 0
        self.model_swaps_total = 0
        self.model_birth_ts = None      # live model's certificate birth
        self.model_round = None         # live model's training round
        # per-tenant certification wall-clocks of a served catalogue
        # (model_swap tenant_cert_ts): the tenant-labeled gap-age series
        # renders from these at render time, like the unlabeled gauge
        self.tenant_cert_ts = None
        self.tenant_gaps = None
        self.query_traces_total = 0     # sampled query_trace events
        self.serve_quantize_seen = False
        self.serve_margin_error_bound = None
        self.serve_dtype_fallbacks_total = 0
        self.fleet_serve_seen = False   # any router event arrived
        self.serve_replicas_live = None
        self.serve_shed_total = 0
        self.serve_requeue_total = 0
        self.last_gap = None
        self.bucket_counts = [0] * (len(BUCKETS) + 1)  # +Inf tail
        self.hist_sum = 0.0
        self.hist_count = 0
        # per-algorithm (last round, last event ts) — the round_seconds
        # denominators; cleared on run_start so a restarted run's first
        # eval never spans the gap across generations
        self._prev = {}
        self.write()

    def _observe(self, seconds_per_round: float):
        self.hist_sum += seconds_per_round
        self.hist_count += 1
        for j, b in enumerate(BUCKETS):
            if seconds_per_round <= b:
                self.bucket_counts[j] += 1
                return
        self.bucket_counts[-1] += 1

    def __call__(self, rec: dict):
        with self._lock:
            self._update(rec)
            self._maybe_write(rec.get("event"))

    def _update(self, rec: dict):
        ev = rec.get("event")
        if ev == "run_start":
            self._prev.clear()
        elif ev == "round_eval":
            self.evals_total += 1
            if rec.get("gap") is not None:
                self.last_gap = float(rec["gap"])
            t = rec.get("t")
            alg = rec.get("algorithm")
            if isinstance(t, int):
                prev = self._prev.get(alg)
                if prev is not None and t > prev[0]:
                    dt_rounds = t - prev[0]
                    self.rounds_total += dt_rounds
                    self._observe((rec["ts"] - prev[1]) / dt_rounds)
                # no prev: the first observed eval anchors the counter but
                # adds nothing — a resumed run's t includes rounds a
                # PREVIOUS process (or generation) executed, and crediting
                # them here would re-count the whole history on every
                # elastic restart.  Cost: up to one eval cadence of rounds
                # per run goes uncounted — resume-safe beats exact-once.
                self._prev[alg] = (t, rec["ts"])
        elif ev == "sigma_backoff":
            self.sigma_backoffs_total += 1
        elif ev == "restart":
            self.restarts_total += 1
            # elastic supervisor restarts carry the gang bookkeeping the
            # σ′ trial rerun (same event type) does not
            if rec.get("gang_size") is not None:
                self.gang_size = int(rec["gang_size"])
            if rec.get("backoff_s") is not None:
                self.restart_backoff_seconds = float(rec["backoff_s"])
            if rec.get("generation") is not None:
                # generation = gangs spawned so far; the restart event
                # precedes the relaunch that makes it generation+1
                self.gang_generations_total = max(
                    self.gang_generations_total, int(rec["generation"]) + 1)
        elif ev == "gang_resize":
            self.gang_size = int(rec["new_size"])
            self.gang_generations_total = max(
                self.gang_generations_total, int(rec["generation"]) + 1)
        elif ev == "checkpoint_corrupt":
            self.checkpoint_corrupt_total += 1
        elif ev == "momentum_restart":
            self.momentum_restarts_total += 1
        elif ev == "theta_stage":
            self.theta_stage = rec.get("stage")
        elif ev == "compile":
            self.compiles_total += 1
        elif ev == "host_transfer":
            self.host_transfers_total += 1
        elif ev == "ingest":
            if rec.get("parse_seconds") is not None:
                self.ingest_seconds += float(rec["parse_seconds"])
            if rec.get("bytes_read") is not None:
                self.ingest_bytes += int(rec["bytes_read"])
        elif ev == "ingest_cache":
            self.ingest_cache_seen = True
            if rec.get("shards_cached") is not None:
                self.ingest_cache_hits_total += int(rec["shards_cached"])
            if rec.get("bytes_mapped") is not None:
                self.ingest_cache_bytes += int(rec["bytes_mapped"])
        elif ev == "ingest_cache_corrupt":
            self.ingest_cache_seen = True
            self.ingest_cache_corrupt_total += 1
        elif ev == "span":
            # per-phase wall-clock gauge (tracing.py spans): cumulative
            # seconds this process spent in each instrumented phase —
            # the single-process half of the straggler story (the
            # cross-worker slack gauges come from trace_report.py,
            # which sees every process's stream)
            phase = rec.get("phase")
            if phase is not None and rec.get("dur_s") is not None:
                self.phase_seconds[str(phase)] = (
                    self.phase_seconds.get(str(phase), 0.0)
                    + float(rec["dur_s"]))
        elif ev == "comm_overlap":
            self.overlap_joins_total += 1
            if rec.get("hidden_s") is not None:
                self.overlap_hidden_seconds += float(rec["hidden_s"])
            if rec.get("wait_s") is not None:
                self.overlap_wait_seconds += float(rec["wait_s"])
        elif ev == "stale_join":
            late = rec.get("rounds_late")
            if late is not None:
                self.stale_joins[int(late)] = (
                    self.stale_joins.get(int(late), 0) + 1)
        elif ev == "fleet_progress":
            if rec.get("active") is not None:
                self.fleet_tenants_active = int(rec["active"])
            if rec.get("models_per_second") is not None:
                self.fleet_models_per_second = float(
                    rec["models_per_second"])
        elif ev == "tenant_certified":
            self.tenants_certified_total += 1
        elif ev == "serve_request":
            n = int(rec.get("n") or 0)
            self.serve_requests_total += n
            self.serve_batches_total += 1
            self.serve_slots_total += int(rec.get("bucket") or 0)
            ts = rec.get("ts")
            if ts is not None:
                if self.serve_first_ts is None:
                    self.serve_first_ts = float(ts)
                self.serve_last_ts = float(ts)
            lat = rec.get("latency_max_s")
            if lat is not None:
                # per-batch WORST latency: conservative SLA accounting
                # (the rendered p99 upper-bounds the per-request p99)
                lat = float(lat)
                self.serve_lat_sum += lat
                self.serve_lat_count += 1
                for j, b in enumerate(BUCKETS):
                    if lat <= b:
                        self.serve_lat_buckets[j] += 1
                        break
                else:
                    self.serve_lat_buckets[-1] += 1
        elif ev == "model_swap":
            # swap_seq 0 is the server's INITIAL load (it anchors gap
            # age but is not a hot-swap) — counting it would disagree by
            # one with the watcher's swaps_total and the bench row
            if rec.get("swap_seq"):
                self.model_swaps_total += 1
            if rec.get("birth_ts") is not None:
                self.model_birth_ts = float(rec["birth_ts"])
            if rec.get("round") is not None:
                self.model_round = int(rec["round"])
            if rec.get("tenant_cert_ts") is not None:
                self.tenant_cert_ts = [float(t) for t
                                       in rec["tenant_cert_ts"]]
            if rec.get("tenant_gaps") is not None:
                self.tenant_gaps = [float(g) if g is not None else None
                                    for g in rec["tenant_gaps"]]
        elif ev == "model_quantize":
            self.serve_quantize_seen = True
            if rec.get("bound") is not None:
                # the LIVE certificate: the most recent publish's bound
                # (kept even on a fallback — it is why the fallback
                # happened, and the one number to look at when the
                # fallbacks counter climbs)
                self.serve_margin_error_bound = float(rec["bound"])
            if rec.get("fallback"):
                self.serve_dtype_fallbacks_total += 1
        elif ev == "serve_shed":
            self.fleet_serve_seen = True
            self.serve_shed_total += 1
        elif ev == "query_trace":
            self.query_traces_total += 1
        elif ev == "replica_state":
            self.fleet_serve_seen = True
            if rec.get("replicas_live") is not None:
                self.serve_replicas_live = int(rec["replicas_live"])
            self.serve_requeue_total += int(rec.get("requeued") or 0)

    def _maybe_write(self, ev):
        """The write debounce (caller holds the lock): flush-now events
        and elapsed intervals write; everything else marks dirty and arms
        a one-shot trailing timer for the remainder of the window."""
        self._dirty = True
        now = time.monotonic()
        if (self.flush_interval_s <= 0 or ev in _FLUSH_EVENTS
                or now - self._last_write >= self.flush_interval_s):
            self.write()
            return
        if self._timer is None:
            delay = self.flush_interval_s - (now - self._last_write)
            self._timer = threading.Timer(max(delay, 0.001), self.flush)
            self._timer.daemon = True
            self._timer.start()

    def flush(self):
        """Write the current state if anything changed since the last
        write (the trailing-timer target; also callable by owners at
        shutdown).  Best-effort on the timer path: the target directory
        may already be gone at process teardown — a late flush must not
        turn that into a thread-crash traceback."""
        with self._lock:
            if self._dirty:
                try:
                    self.write()
                except OSError:
                    pass

    def start_heartbeat(self, interval_s: float = 5.0):
        """Periodic UNCONDITIONAL rewrite, independent of events — the
        serving loop arms this because its render-time gauges
        (``cocoa_model_gap_age_seconds``) must keep moving when no
        events arrive: a dead trainer plus an idle server is exactly
        the scenario the climbing gauge exists to alert on, and an
        event-driven-only writer would freeze the textfile there.
        Best-effort like :meth:`flush`; idempotent; daemon timers."""
        with self._lock:
            self._hb_interval = float(interval_s)
            if self._hb_timer is None:
                self._arm_heartbeat()

    def stop_heartbeat(self):
        with self._lock:
            self._hb_interval = None
            if self._hb_timer is not None:
                self._hb_timer.cancel()
                self._hb_timer = None

    def _arm_heartbeat(self):
        t = threading.Timer(self._hb_interval, self._heartbeat)
        t.daemon = True
        t.start()
        self._hb_timer = t

    def _heartbeat(self):
        with self._lock:
            if self._hb_interval is None:
                return
            try:
                self.write()
            except OSError:
                pass
            self._arm_heartbeat()

    def _gang_lines(self) -> list:
        lines = ["# TYPE cocoa_gang_generations_total counter",
                 f"cocoa_gang_generations_total "
                 f"{self.gang_generations_total}"]
        if self.gang_size is not None:
            lines += ["# TYPE cocoa_gang_size gauge",
                      f"cocoa_gang_size {self.gang_size}"]
        if self.restart_backoff_seconds is not None:
            lines += ["# TYPE cocoa_restart_backoff_seconds gauge",
                      f"cocoa_restart_backoff_seconds "
                      f"{self.restart_backoff_seconds!r}"]
        return lines

    def render(self) -> str:
        if self.families == "gang":
            return "\n".join(self._gang_lines()) + "\n"
        lines = [
            "# TYPE cocoa_rounds_total counter",
            f"cocoa_rounds_total {self.rounds_total}",
            "# TYPE cocoa_evals_total counter",
            f"cocoa_evals_total {self.evals_total}",
            "# TYPE cocoa_sigma_backoffs_total counter",
            f"cocoa_sigma_backoffs_total {self.sigma_backoffs_total}",
            "# TYPE cocoa_restarts_total counter",
            f"cocoa_restarts_total {self.restarts_total}",
            "# TYPE cocoa_momentum_restarts_total counter",
            f"cocoa_momentum_restarts_total {self.momentum_restarts_total}",
            "# TYPE cocoa_compiles_total counter",
            f"cocoa_compiles_total {self.compiles_total}",
            "# TYPE cocoa_host_transfers_total counter",
            f"cocoa_host_transfers_total {self.host_transfers_total}",
            "# TYPE cocoa_ingest_seconds gauge",
            f"cocoa_ingest_seconds {self.ingest_seconds!r}",
            "# TYPE cocoa_ingest_bytes gauge",
            f"cocoa_ingest_bytes {self.ingest_bytes}",
            "# TYPE cocoa_checkpoint_corrupt_total counter",
            f"cocoa_checkpoint_corrupt_total {self.checkpoint_corrupt_total}",
        ]
        if self.ingest_cache_seen:
            # cache families render only once a --ingestCache run has
            # reported (uncached runs must not carry zero-valued series)
            lines += ["# TYPE cocoa_ingest_cache_hits_total counter",
                      f"cocoa_ingest_cache_hits_total "
                      f"{self.ingest_cache_hits_total}",
                      "# TYPE cocoa_ingest_cache_bytes gauge",
                      f"cocoa_ingest_cache_bytes "
                      f"{self.ingest_cache_bytes}",
                      "# TYPE cocoa_ingest_cache_corrupt_total counter",
                      f"cocoa_ingest_cache_corrupt_total "
                      f"{self.ingest_cache_corrupt_total}"]
        if self.gang_generations_total:
            # gang families appear in an "all" file only when this
            # process actually saw gang events (a worker never does —
            # its file must not shadow the supervisor's .gang series)
            lines += self._gang_lines()
        if self.phase_seconds:
            lines.append("# TYPE cocoa_phase_seconds gauge")
            lines += [f'cocoa_phase_seconds{{phase="{p}"}} '
                      f"{self.phase_seconds[p]!r}"
                      for p in sorted(self.phase_seconds)]
        if self.overlap_joins_total:
            lines += ["# TYPE cocoa_overlap_hidden_seconds gauge",
                      f"cocoa_overlap_hidden_seconds "
                      f"{self.overlap_hidden_seconds!r}",
                      "# TYPE cocoa_overlap_wait_seconds gauge",
                      f"cocoa_overlap_wait_seconds "
                      f"{self.overlap_wait_seconds!r}"]
        if self.stale_joins:
            lines.append("# TYPE cocoa_stale_joins_total counter")
            lines += [f'cocoa_stale_joins_total{{rounds_late="{late}"}} '
                      f"{self.stale_joins[late]}"
                      for late in sorted(self.stale_joins)]
        if self.fleet_tenants_active is not None:
            # fleet families appear only once a --fleet run has reported
            # (solo runs must not render zero-valued fleet series)
            lines += ["# TYPE cocoa_fleet_tenants_active gauge",
                      f"cocoa_fleet_tenants_active "
                      f"{self.fleet_tenants_active}",
                      "# TYPE cocoa_tenants_certified_total counter",
                      f"cocoa_tenants_certified_total "
                      f"{self.tenants_certified_total}"]
            if self.fleet_models_per_second is not None:
                lines += ["# TYPE cocoa_fleet_models_per_second gauge",
                          f"cocoa_fleet_models_per_second "
                          f"{self.fleet_models_per_second!r}"]
        if self.serve_batches_total:
            # serving families render only once a --serve run answered
            # (training runs must not carry zero-valued serve series)
            qps = self.serve_requests_total / max(
                (self.serve_last_ts or 0.0) - (self.serve_first_ts
                                               or 0.0), 1.0)
            fill = self.serve_requests_total / max(self.serve_slots_total,
                                                   1)
            lines += ["# TYPE cocoa_serve_requests_total counter",
                      f"cocoa_serve_requests_total "
                      f"{self.serve_requests_total}",
                      "# TYPE cocoa_serve_batches_total counter",
                      f"cocoa_serve_batches_total "
                      f"{self.serve_batches_total}",
                      "# TYPE cocoa_serve_qps gauge",
                      f"cocoa_serve_qps {qps!r}",
                      "# TYPE cocoa_serve_batch_fill_ratio gauge",
                      f"cocoa_serve_batch_fill_ratio {fill!r}",
                      "# TYPE cocoa_serve_latency_seconds histogram"]
            cum = 0
            for b, c in zip(BUCKETS, self.serve_lat_buckets):
                cum += c
                lines.append(
                    f'cocoa_serve_latency_seconds_bucket{{le="{b}"}} '
                    f"{cum}")
            lines.append(f'cocoa_serve_latency_seconds_bucket'
                         f'{{le="+Inf"}} '
                         f"{cum + self.serve_lat_buckets[-1]}")
            lines.append(f"cocoa_serve_latency_seconds_sum "
                         f"{self.serve_lat_sum!r}")
            lines.append(f"cocoa_serve_latency_seconds_count "
                         f"{self.serve_lat_count}")
        if self.model_birth_ts is not None:
            now = time.time()
            age = max(0.0, now - self.model_birth_ts)
            lines += ["# TYPE cocoa_model_swaps_total counter",
                      f"cocoa_model_swaps_total {self.model_swaps_total}",
                      "# TYPE cocoa_model_gap_age_seconds gauge",
                      f"cocoa_model_gap_age_seconds {age!r}"]
            if self.tenant_cert_ts:
                # the catalogue's per-tenant freshness (docs/DESIGN.md
                # §22): seconds since EACH tenant row's certificate was
                # produced — the labeled series sits under the same
                # family as the whole-catalogue gauge above
                lines += [f'cocoa_model_gap_age_seconds{{tenant="{t}"}} '
                          f"{max(0.0, now - ts)!r}"
                          for t, ts in enumerate(self.tenant_cert_ts)]
            if self.model_round is not None:
                lines += ["# TYPE cocoa_model_round gauge",
                          f"cocoa_model_round {self.model_round}"]
        if self.serve_quantize_seen:
            # quantized-serving families render only once a --serveDtype
            # run published (f32 serves must not carry zero-valued
            # quantization series)
            lines += ["# TYPE cocoa_serve_dtype_fallbacks_total counter",
                      f"cocoa_serve_dtype_fallbacks_total "
                      f"{self.serve_dtype_fallbacks_total}"]
            if self.serve_margin_error_bound is not None:
                lines += ["# TYPE cocoa_serve_margin_error_bound gauge",
                          f"cocoa_serve_margin_error_bound "
                          f"{self.serve_margin_error_bound!r}"]
        if self.fleet_serve_seen:
            # fleet-serving families render only once a router event
            # arrived (single-process serves must not carry zero-valued
            # fleet series)
            lines += ["# TYPE cocoa_serve_shed_total counter",
                      f"cocoa_serve_shed_total {self.serve_shed_total}",
                      "# TYPE cocoa_serve_requeue_total counter",
                      f"cocoa_serve_requeue_total "
                      f"{self.serve_requeue_total}"]
            if self.serve_replicas_live is not None:
                lines += ["# TYPE cocoa_serve_replicas_live gauge",
                          f"cocoa_serve_replicas_live "
                          f"{self.serve_replicas_live}"]
        if self.query_traces_total:
            # sampled tracing families render only once a --traceSample
            # run emitted (untraced serves must not carry zero series)
            lines += ["# TYPE cocoa_query_traces_total counter",
                      f"cocoa_query_traces_total "
                      f"{self.query_traces_total}"]
        if self.theta_stage is not None:
            lines += ["# TYPE cocoa_theta_stage gauge",
                      f"cocoa_theta_stage {self.theta_stage}"]
        if self.last_gap is not None:
            lines += ["# TYPE cocoa_last_gap gauge",
                      f"cocoa_last_gap {self.last_gap!r}"]
        lines.append("# TYPE cocoa_round_seconds histogram")
        cum = 0
        for b, c in zip(BUCKETS, self.bucket_counts):
            cum += c
            lines.append(f'cocoa_round_seconds_bucket{{le="{b}"}} {cum}')
        lines.append(f'cocoa_round_seconds_bucket{{le="+Inf"}} '
                     f"{cum + self.bucket_counts[-1]}")
        lines.append(f"cocoa_round_seconds_sum {self.hist_sum!r}")
        lines.append(f"cocoa_round_seconds_count {self.hist_count}")
        return "\n".join(lines) + "\n"

    def write(self):
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            self._dirty = False
            self._last_write = time.monotonic()
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(self.render())
            os.replace(tmp, self.path)
