"""JSONL schema checker for the telemetry artifacts (the port's own copy
of cocoa_tpu/telemetry/schema.py, every dialect; the card's machine has
no JAX, so chip_smoke.py validates its streams with this one).

One dependency-free validator, covering the six JSONL dialects the two
packages emit:

- **event streams** (``--events``, telemetry/events.py): every line has
  ``event``/``seq``/``ts``, per-type required fields, and ``seq`` is
  strictly increasing — the ordering guarantee the ordered io_callback
  bridge provides;
- **trajectory dumps** (``--trajOut``, utils/logging.Trajectory): a
  manifest header line followed by per-round records, ``stopped`` carried
  on the final record;
- **benchmark results** (benchmarks/results.jsonl): one config row per
  line.
- **analysis reports** (``python -m cocoa_tpu.analysis --report=...``):
  an ``analysis_manifest`` header plus one finding per line, unique
  fingerprints (what the jaxlint baseline keys on).
- **flight-recorder dumps** (``<events>.flightrec``,
  telemetry/recorder.py): a ``flightrec_manifest`` header (dump reason,
  victim pid, ring size) followed by the last-N event records the ring
  held when the dump fired.
- **fleet manifests** (``--fleet``, data/fleet.py): a ``fleet_manifest``
  header followed by one tenant per line (dataset ref, λ, gap target) —
  the loader validates through this checker before building anything.

Usage: ``python -m cocoa_torch.telemetry.schema FILE...`` — the dialect is
sniffed per file from its first line; exit code 1 on any violation.
"""

from __future__ import annotations

import json
import sys

_NUM = (int, float)
_OPT_NUM = (int, float, type(None))

# the run_start manifest's layout-split record (--hotCols provenance,
# data/hybrid.resolve_hot_cols): present on sparse-layout svm runs so
# benchmark provenance is machine-readable — which panel the run trained
# on, what it covered, and what the residual streams still pay
LAYOUT_SPLIT_FIELDS = {
    "spec": (str,),
    "hot_cols": (int,),
    "coverage": _NUM,
    "residual_mean_nnz": _NUM,
    "residual_max_nnz": (int,),
    "panel_bytes": (int,),
}

# the run_start manifest's ingest record (--ingest provenance,
# data/ingest.IngestReport): how the training data reached the device —
# which mode, what this process parsed, and what it cost (the same fields
# ride the typed ``ingest`` event)
INGEST_FIELDS = {
    "mode": (str,),
    "path": (str,),
    "file_bytes": (int,),
    "processes": (int,),
    "parse_seconds": _NUM,
    "bytes_read": (int,),
    "rows": (int,),
    "nnz": (int,),
    "n": (int,),
    "total_nnz": (int,),
    "peak_rss_bytes": (int,),
    "cache": (str,),     # --ingestCache outcome: off|hit|partial|miss
}

# event type -> {field: allowed types}; every event also needs seq/ts
EVENT_FIELDS = {
    "run_start": {"manifest": (dict,)},
    "round_eval": {"algorithm": (str,), "t": (int,), "primal": _NUM,
                   "gap": _OPT_NUM, "test_error": _OPT_NUM,
                   "sigma": _OPT_NUM, "stall": _OPT_NUM},
    "sigma_backoff": {"algorithm": (str,), "t": (int,), "sigma": _NUM,
                      "from_sigma": _NUM},
    "checkpoint_write": {"algorithm": (str,), "round": (int,),
                         "path": (str,)},
    "restart": {"reason": (str,)},
    "divergence": {"algorithm": (str,), "t": (int,), "n_evals": (int,)},
    "run_end": {"algorithm": (str,), "stopped": (str, type(None))},
    # the sanitizer bridge (analysis/sanitize.py): one per finished XLA
    # compile / per sanctioned device→host fetch — what feeds the
    # cocoa_compiles_total / cocoa_host_transfers_total counters
    "compile": {"name": (str,), "seconds": _NUM},
    "host_transfer": {"label": (str,)},
    # the accelerated outer loop (--accel, solvers/base.py): a
    # gap-monitored momentum restart / a Θ local-accuracy ladder step —
    # emitted identically by the live io_callback stream and the fetch
    # replay (DeviceTap) and by the host-stepped drivers' twin
    "momentum_restart": {"algorithm": (str,), "t": (int,),
                         "restarts_total": (int,)},
    "theta_stage": {"algorithm": (str,), "t": (int,), "stage": (int,),
                    "h": (int, type(None))},
    # streaming/whole ingest of one LIBSVM file (data/ingest.py): what
    # feeds cocoa_ingest_seconds / cocoa_ingest_bytes in --metrics
    "ingest": INGEST_FIELDS,
    # one file's --ingestCache outcome (data/slab_cache.py, DESIGN.md
    # §18): what feeds cocoa_ingest_cache_hits_total /
    # cocoa_ingest_cache_bytes in --metrics
    "ingest_cache": {"path": (str,), "status": (str,),
                     "shards_cached": (int,), "shards_total": (int,),
                     "bytes_mapped": (int,), "seconds_saved": _NUM},
    # a cache artifact failed validation on load and was evicted; the
    # shard fell back to a cold parse (the torn/truncated-file recovery
    # path, pinned with the tests/_faults.py truncate fault)
    "ingest_cache_corrupt": {"path": (str,), "artifact": (str,),
                             "reason": (str,)},
    # the elastic supervisor reformed the gang at P′ < P survivors
    # (cocoa_tpu/elastic.py shrink-to-survivors): what feeds the
    # cocoa_gang_size gauge.  ``restart`` events additionally carry
    # gang_size / backoff_s (not required here: the σ′ trial rerun emits
    # restarts too, without a gang)
    "gang_resize": {"reason": (str,), "old_size": (int,),
                    "new_size": (int,), "generation": (int,)},
    # a checkpoint generation failed validation on load and the reader
    # fell back (checkpoint.latest) — the torn/corrupt-file recovery path
    "checkpoint_corrupt": {"algorithm": (str,), "path": (str,),
                           "reason": (str,)},
    # one closed tracing span (telemetry/tracing.py): the per-phase,
    # per-worker timing record trace_report.py assembles into the gang
    # timeline / per-round critical path / straggler table.  parent_id
    # None = a top-level span; worker None = tracer configured without a
    # process index (single-process runs)
    "span": {"phase": (str,), "span_id": (int,),
             "parent_id": (int, type(None)),
             "worker": (int, type(None)),
             "start_ts": _NUM, "dur_s": _NUM},
    # the JSONL sink hit its --eventsMaxMB cap and rolled to `.1`
    # (events.EventBus._rotate) — always the first event of a fresh file
    "events_rotate": {"path": (str,), "rotated_to": (str,),
                      "bytes": (int,)},
    # one joined overlapped exchange (--overlapComm,
    # parallel/distributed.ExchangeHandle): what feeds the
    # cocoa_overlap_hidden_seconds gauge
    "comm_overlap": {"tag": (str,), "hidden_s": _NUM, "wait_s": _NUM},
    # a bounded-staleness contribution joined rounds_late rounds after
    # its own round (--staleRounds, solvers/cocoa.StaleJoinWindow):
    # what feeds cocoa_stale_joins_total{rounds_late=}
    "stale_join": {"algorithm": (str,), "t": (int,), "round": (int,),
                   "rounds_late": (int,),
                   "workers": (int, type(None))},
    # one fleet eval boundary (--fleet, solvers/fleet.py): how many
    # tenant lanes are still live and how many have certified — what
    # feeds cocoa_fleet_tenants_active / cocoa_fleet_models_per_second
    # (models_per_second rides only the final event, once the wall-clock
    # denominator exists)
    "fleet_progress": {"algorithm": (str,), "t": (int,),
                       "active": (int,), "certified_total": (int,),
                       "models_per_second": _OPT_NUM},
    # one tenant crossed its duality-gap target inside the fleet loop —
    # what feeds cocoa_tenants_certified_total
    "tenant_certified": {"algorithm": (str,), "tenant": (str,),
                         "t": (int,), "gap": _OPT_NUM},
    # one scored serving batch (--serve, serving/batcher.py): what feeds
    # cocoa_serve_qps / cocoa_serve_latency_seconds /
    # cocoa_serve_batch_fill_ratio.  model_round is None only before the
    # first checkpoint carried a round (never in practice — the server
    # refuses to start without a validated generation)
    "serve_request": {"algorithm": (str,), "n": (int,), "bucket": (int,),
                      "fill_ratio": _NUM, "queue_s": _NUM,
                      "device_s": _NUM, "latency_max_s": _NUM,
                      "latency_mean_s": _NUM, "model_round": _OPT_NUM},
    # the serving watcher hot-swapped a new validated generation into
    # the live slot (serving/watcher.py): what anchors
    # cocoa_model_gap_age_seconds (birth_ts = the checkpoint's mtime =
    # when its certificate was produced); gap is the certified duality
    # gap the checkpoint meta recorded (None on pre-gap metas)
    # tenant_gaps / tenant_cert_ts ride the stacked catalogue's
    # per-tenant certification metadata (checkpoint meta, docs/DESIGN.md
    # §21-22): one certified gap and one certification wall-clock per
    # tenant row, None on single-model checkpoints — what feeds the
    # tenant-labeled cocoa_model_gap_age_seconds series
    "model_swap": {"algorithm": (str,), "round": (int, type(None)),
                   "path": (str,), "birth_ts": _NUM, "gap": _OPT_NUM,
                   "gap_age_s": _NUM, "swap_seq": (int,),
                   "tenant_gaps": (list, type(None)),
                   "tenant_cert_ts": (list, type(None))},
    # one --serveDtype publish decision (serving/scorer.ModelSlots):
    # served == serve_dtype when the generation certified, "f32" on a
    # certificate fallback (fallback=1); bound is the measured
    # f32-vs-quantized margin-error bound over calib_n calibration
    # queries (None when no calibration source is wired), flips how
    # many calibration margins actually changed sign, scale the int8
    # symmetric per-model scale (None for bf16).  swap_seq mirrors
    # model_swap ("seq" would collide with the record envelope)
    "model_quantize": {"algorithm": (str,), "serve_dtype": (str,),
                       "served": (str,), "round": (int, type(None)),
                       "swap_seq": (int,), "bound": _OPT_NUM,
                       "calib_n": (int,), "flips": (int,),
                       "fallback": (int,), "scale": _OPT_NUM},
    # the fleet router refused one request line at admission
    # (serving/router.py): the best live replica still projected past
    # the shed budget, so the line was refused instead of queued into
    # an SLA violation.  tenant None = an untagged line; inflight /
    # est_s describe the BEST live replica at the decision — what feeds
    # cocoa_serve_shed_total
    # trace_id: the exemplar — when the refused line carried a trace
    # context, the shed counter names a concrete query to go look at
    "serve_shed": {"algorithm": (str,), "route": (str,),
                   "tenant": (int, type(None)), "inflight": (int,),
                   "est_s": _NUM, "sla_s": _NUM,
                   "trace_id": (str, type(None))},
    # one fleet replica liveness transition (serving/router.py /
    # fleet.py): state "dead" (connection or process died), "requeue"
    # (a request line replayed off the dead replica, requeued=1), or
    # "live" (the monitor respawned it).  replicas_live is the live
    # count AFTER the transition — what feeds
    # cocoa_serve_replicas_live / cocoa_serve_requeue_total
    # trace_id: the requeue exemplar — the trace context of the line
    # that was replayed off the dead replica (None on live/dead
    # transitions and untraced requeues)
    "replica_state": {"algorithm": (str,), "replica": (str,),
                      "state": (str,), "replicas_live": (int,),
                      "requeued": (int,),
                      "trace_id": (str, type(None))},
    # one sampled end-to-end query trace (--traceSample, docs/DESIGN.md
    # §22).  Hop seconds are None where the hop does not exist: a solo
    # server has no router_queue/forward hop, a line the replica
    # rejected at parse has no replica-side hops.  requeues counts how
    # many dead replicas the line replayed past before answering;
    # replica names the answerer (None solo).  The model stamp (round,
    # gap age, dtype, bucket) is the generation that ANSWERED — how a
    # trace correlates a slow query with a stale or quantized model
    "query_trace": {"algorithm": (str,), "trace_id": (str,),
                    "tenant": (int, type(None)),
                    "replica": (str, type(None)),
                    "router_queue_s": _OPT_NUM,
                    "forward_s": _OPT_NUM,
                    "replica_queue_s": _OPT_NUM,
                    "device_s": _OPT_NUM,
                    "serialize_s": _OPT_NUM,
                    "total_s": _NUM,
                    "bucket": (int, type(None)),
                    "model_round": (int, type(None)),
                    "gap_age_s": _OPT_NUM,
                    "dtype": (str, type(None)),
                    "requeues": (int,)},
    # one /slo evaluation (telemetry/aggregate.py): attainment = the
    # fraction of served lines inside the SLA over the rolling window
    # (None until the histogram has data); burn_fast / burn_slow = the
    # multi-window error-budget burn rates ((1 - attainment) / (1 -
    # objective)) over the fast and slow windows — a burn > 1 on BOTH
    # is the page-worthy signal (fast-only = a blip, slow-only = an
    # old incident draining out)
    "slo_status": {"algorithm": (str,), "sla_ms": _NUM,
                   "objective": _NUM, "window_fast_s": _NUM,
                   "window_slow_s": _NUM, "attainment": _OPT_NUM,
                   "burn_fast": _OPT_NUM, "burn_slow": _OPT_NUM,
                   "served_total": (int,), "over_sla_total": (int,),
                   "replicas_live": (int, type(None))},
}

# --fleet manifest dialect (data/fleet.py): a ``fleet_manifest`` header
# line, then one tenant per line.  tenant/dataset/lam are required; the
# optional columns are type-checked when present (file-backed datasets
# carry num_features, non-hinge fleets a loss/smoothing pair)
FLEET_TENANT_REQUIRED = {
    "tenant": (str,),
    "dataset": (str,),
    "lam": _NUM,
}
FLEET_TENANT_OPTIONAL = {
    "gap_target": _OPT_NUM,
    "num_features": (int,),
    "loss": (str,),
    "smoothing": _NUM,
}

TRAJ_RECORD_FIELDS = {
    "algorithm": (str,),
    "round": (int,),
    "wall_time": _OPT_NUM,
    "primal": _OPT_NUM,
    "gap": _OPT_NUM,
    "test_error": _OPT_NUM,
    "sigma": _OPT_NUM,
}

# jaxlint JSONL reports (python -m cocoa_tpu.analysis --report=...):
# one analysis_manifest header line, then one line per finding
ANALYSIS_FINDING_FIELDS = {
    "rule": (str,),
    "severity": (str,),
    "path": (str,),
    "line": (int,),
    "col": (int,),
    "message": (str,),
    "fingerprint": (str,),
}

ANALYSIS_SEVERITIES = ("error", "warning", "inventory")


# benchmarks/results.jsonl: "config" identifies the row; every OTHER known
# key is type-checked when present (rows carry different column subsets —
# svm vs lasso vs perf-accounting)
RESULTS_FIELDS = {
    "config": (str,), "n": (int,), "d": (int,), "k": (int,),
    "lam": _NUM, "rounds": (int,), "gap": _NUM, "primal": _NUM,
    "wallclock_s": _NUM, "fixed_s": _NUM, "l2": _NUM,
    "vs_oracle": _NUM, "vs_oracle_same_gap": _NUM, "oracle_basis": (str,),
    "type": (str,), "device": (str,), "ms_per_round": _NUM,
    "us_per_step": _NUM, "useful_gflops": _NUM, "physical_gflops": _NUM,
    "mfu_pct": _NUM, "physical_mfu_pct": _NUM, "hbm_floor_ms": _NUM,
    "hbm_bound_pct": _NUM, "bound": (str,),
    # h / gap_target are numeric but legacy rows carry e.g. "n/a"
    "h": (int, str), "gap_target": (int, float, str),
    # the accelerated outer loop A/B row (--accel, benchmarks/run.py):
    # control rounds, measured ratio, and the theoretical Nesterov floor
    # (perf.predict_accel_rounds)
    "control_rounds": (int,), "rounds_ratio": _NUM,
    "accel_floor_rounds": (int,), "stopped": (str, type(None)),
    "sigma_ladder": (str,),
    # the fleet rows (--fleet / benchmarks/fleet_bench.py): tenants
    # certified per second through the one compiled vmapped round, with
    # the serial solo control and the measured speedup alongside
    "tenants": (int,), "certified": (int,), "models_per_second": _NUM,
    "serial_models_per_second": _NUM, "speedup": _NUM, "compiles": (int,),
    "lam_lo": _NUM, "lam_hi": _NUM, "drive_mode": (str,),
    "lane_exec": (str,),
    # the ingest A/B rows (benchmarks/run.py bench_ingest): per-process
    # parse wallclock / bytes / peak host RSS, stream vs whole, with the
    # perf.ingest_model predictions alongside
    "mode": (str,), "processes": (int,), "file_mb": _NUM,
    "parse_s": _NUM, "bytes_read_mb": _NUM, "peak_rss_mb": _NUM,
    "rss_delta_mb": _NUM, "rss_vs_whole": _NUM,
    "predicted_parse_s": _NUM, "predicted_csr_mb": _NUM,
    # the warm-ingest rows (--ingestCache, benchmarks/run.py
    # bench_ingest "warm" mode): zero-parse slab mapping vs the streamed
    # cold parse of the same file/geometry
    "warm_speedup": _NUM, "bytes_mapped_mb": _NUM,
    # the serving rows (--serve / benchmarks/serve_bench.py): queries/s
    # under a pinned p99 SLA plus the model-freshness (gap age) the run
    # observed; buckets is the static bucket ladder ("64/256"), compiles
    # the measured XLA compile count (== bucket count, the
    # one-compile-per-bucket pin), swaps the hot-swaps served through
    "qps": _NUM, "p50_ms": _NUM, "p99_ms": _NUM, "sla_ms": _NUM,
    "gap_age_s": _NUM, "buckets": (str,), "queries": (int,),
    "swaps": (int,), "fill": _NUM, "threads": (int,),
    # the low-precision serving A/B rows (--serveDtype,
    # benchmarks/serve_bench.py): compiled-path throughput of the
    # packed bf16/int8 model vs the SAME-harness f32 control at a
    # geometry where the f32 model spills the cache level the packed
    # form fits (the honest mechanism: the gather stream halves);
    # margin_err_bound is the per-swap certificate, flips the sign
    # flips observed beyond it (gated == 0), calib_n the calibration
    # batch size the bound was measured over
    "serve_dtype": (str,), "f32_qps": _NUM, "qps_ratio": _NUM,
    "margin_err_bound": _NUM, "flips": (int,), "flip_checked": (int,),
    "calib_n": (int,),
    # the fleet-serving rows (--serveReplicas,
    # benchmarks/serve_bench.py): aggregate open-loop qps of R replicas
    # behind the router vs the SAME-harness 1-replica control
    # (control_qps), scaling_eff = qps / (replicas × control_qps);
    # shed / requeued / failed are the router's admission + recovery
    # accounting (failed is pinned 0 — a SIGKILLed replica requeues,
    # never fails), rate_qps the open-loop offered rate
    "replicas": (int,), "route": (str,), "rate_qps": _NUM,
    "control_qps": _NUM, "scaling_eff": _NUM, "shed": (int,),
    "requeued": (int,), "failed": (int,), "killed": (int,),
    # the per-query tracing A/B riding the fleet row (--serveReplicas,
    # docs/DESIGN.md §22): closed-loop qps with every line
    # trace=-prefixed (1-in-N sampled into query_trace events) vs the
    # same-shape untraced window, the measured overhead percentage
    # (gated ≤5% on the committed row), the sampled-trace count, the
    # trace stream's schema-violation count (gated 0), and the
    # waterfall's dominant hop over the run's sampled traces
    "traced_qps": _NUM, "trace_overhead_pct": _NUM,
    "trace_sampled": (int,), "trace_schema_errors": (int,),
    "dominant_hop": (str, type(None)),
}


def _typecheck(obj, fields, where, errors, required=True):
    for name, types in fields.items():
        if name not in obj:
            if required:
                errors.append(f"{where}: missing field {name!r}")
            continue
        v = obj[name]
        if isinstance(v, bool) or not isinstance(v, types):
            errors.append(f"{where}: field {name!r} has type "
                          f"{type(v).__name__}, expected "
                          f"{'/'.join(t.__name__ for t in types)}")


def check_event_lines(objs) -> list:
    """Validate an event stream; returns a list of error strings.

    ``seq`` must be strictly increasing PER EMITTER (``pid``): a
    supervised run interleaves several processes' whole-line appends in
    one file — the elastic supervisor's restart events between worker
    generations, each generation's fresh EventBus — and each emitter
    counts its own seq from 1.  The ordering guarantee (the ordered
    io_callback bridge) is per run, which is per emitter."""
    errors = []
    prev_seq = {}
    for ln, obj in objs:
        where = f"line {ln}"
        ev = obj.get("event")
        if ev not in EVENT_FIELDS:
            errors.append(f"{where}: unknown event type {ev!r}")
            continue
        seq = obj.get("seq")
        if not isinstance(seq, int) or isinstance(seq, bool):
            errors.append(f"{where}: missing/invalid seq")
        else:
            # pre-pid streams validate as one emitter (pid None); a
            # restarted worker generation is a NEW process with a new
            # pid, so per-pid strict ordering covers supervised runs too
            pid = obj.get("pid")
            prev = prev_seq.get(pid, 0)
            if seq <= prev:
                errors.append(f"{where}: seq {seq} not increasing "
                              f"(prev {prev} for pid {pid}) — event order "
                              f"violated")
            prev_seq[pid] = seq
        if not isinstance(obj.get("ts"), _NUM):
            errors.append(f"{where}: missing/invalid ts")
        _typecheck(obj, EVENT_FIELDS[ev], where, errors)
        if ev == "run_start":
            man = obj.get("manifest")
            split = man.get("layout_split") if isinstance(man, dict) else None
            if split is not None:
                if not isinstance(split, dict):
                    errors.append(f"{where}: layout_split must be an object")
                else:
                    _typecheck(split, LAYOUT_SPLIT_FIELDS,
                               f"{where}: layout_split", errors)
            ing = man.get("ingest") if isinstance(man, dict) else None
            if ing is not None:
                if not isinstance(ing, dict):
                    errors.append(f"{where}: ingest must be an object")
                else:
                    _typecheck(ing, INGEST_FIELDS,
                               f"{where}: ingest", errors)
    return errors


def check_trajectory_lines(objs) -> list:
    """Validate a --trajOut dump: manifest header, per-round records,
    ``stopped`` on the final record."""
    errors = []
    if not objs:
        return ["empty trajectory file"]
    ln0, head = objs[0]
    man = head.get("manifest")
    if not isinstance(man, dict):
        errors.append(f"line {ln0}: first line must carry the run manifest")
    else:
        for name in ("algorithm", "config_hash", "backend"):
            if name not in man:
                errors.append(f"line {ln0}: manifest missing {name!r}")
        # the framework's version: the JAX package's manifest carries
        # jax_version, the port's torch_version
        if "jax_version" not in man and "torch_version" not in man:
            errors.append(f"line {ln0}: manifest missing 'jax_version' "
                          f"(or 'torch_version')")
    for j, (ln, obj) in enumerate(objs[1:]):
        _typecheck(obj, TRAJ_RECORD_FIELDS, f"line {ln}", errors)
    if len(objs) > 1:
        ln, last = objs[-1]
        if "stopped" not in last:
            errors.append(f"line {ln}: final record must carry 'stopped' "
                          f"(null = ran its full round budget)")
        elif not isinstance(last["stopped"], (str, type(None))):
            errors.append(f"line {ln}: 'stopped' must be a string or null")
    return errors


def check_results_lines(objs) -> list:
    """Validate benchmarks/results.jsonl rows."""
    errors = []
    for ln, obj in objs:
        where = f"line {ln}"
        if not isinstance(obj.get("config"), str):
            errors.append(f"{where}: missing/invalid 'config'")
        _typecheck(obj, RESULTS_FIELDS, where, errors, required=False)
    return errors


def check_analysis_lines(objs) -> list:
    """Validate a jaxlint JSONL report: the manifest header, per-finding
    required fields, legal severities, and fingerprint uniqueness (the
    baseline keys on fingerprints — a collision would silently merge two
    findings)."""
    errors = []
    if not objs:
        return ["empty analysis report"]
    ln0, head = objs[0]
    man = head.get("analysis_manifest")
    if not isinstance(man, dict):
        errors.append(f"line {ln0}: first line must carry the "
                      f"analysis_manifest header")
    else:
        for name in ("tool", "version", "files_scanned", "rules"):
            if name not in man:
                errors.append(f"line {ln0}: analysis_manifest missing "
                              f"{name!r}")
    seen = {}
    for ln, obj in objs[1:]:
        where = f"line {ln}"
        _typecheck(obj, ANALYSIS_FINDING_FIELDS, where, errors)
        sev = obj.get("severity")
        if isinstance(sev, str) and sev not in ANALYSIS_SEVERITIES:
            errors.append(f"{where}: severity {sev!r} not in "
                          f"{ANALYSIS_SEVERITIES}")
        fp = obj.get("fingerprint")
        if isinstance(fp, str):
            if fp in seen:
                errors.append(f"{where}: fingerprint {fp} duplicates "
                              f"line {seen[fp]}")
            seen[fp] = ln
    return errors


def check_flightrec_lines(objs) -> list:
    """Validate a flight-recorder dump (``<events>.flightrec``,
    telemetry/recorder.py — the 5th dialect): a ``flightrec_manifest``
    header naming the dump reason, then the ring's last-N event records,
    each a valid typed event (per-emitter seq ordering holds — the ring
    preserves emission order, and a victim-tail dump is one emitter)."""
    errors = []
    if not objs:
        return ["empty flight-recorder dump"]
    ln0, head = objs[0]
    man = head.get("flightrec_manifest")
    if not isinstance(man, dict):
        errors.append(f"line {ln0}: first line must carry the "
                      f"flightrec_manifest header")
    else:
        for name in ("reason", "ts", "n_events"):
            if name not in man:
                errors.append(f"line {ln0}: flightrec_manifest missing "
                              f"{name!r}")
        n = man.get("n_events")
        if isinstance(n, int) and n != len(objs) - 1:
            errors.append(f"line {ln0}: manifest says n_events={n} but "
                          f"the dump carries {len(objs) - 1} records "
                          f"(torn dump?)")
    return errors + check_event_lines(objs[1:])


def check_fleet_lines(objs) -> list:
    """Validate a --fleet manifest (the 6th dialect, data/fleet.py): a
    ``fleet_manifest`` header naming the dialect version, then one tenant
    object per line — required tenant/dataset/lam, optional columns
    type-checked when present, tenant ids unique (the fleet's per-tenant
    events and metrics key on them)."""
    errors = []
    if not objs:
        return ["empty fleet manifest"]
    ln0, head = objs[0]
    man = head.get("fleet_manifest")
    if not isinstance(man, dict):
        errors.append(f"line {ln0}: first line must carry the "
                      f"fleet_manifest header")
    elif "version" not in man:
        errors.append(f"line {ln0}: fleet_manifest missing 'version'")
    seen = {}
    known = set(FLEET_TENANT_REQUIRED) | set(FLEET_TENANT_OPTIONAL)
    for ln, obj in objs[1:]:
        where = f"line {ln}"
        _typecheck(obj, FLEET_TENANT_REQUIRED, where, errors)
        _typecheck(obj, FLEET_TENANT_OPTIONAL, where, errors,
                   required=False)
        # manifests are USER-authored input (unlike the machine-emitted
        # dialects): a typoed optional column ('gap_taget') must fail
        # here, not silently train a different fleet
        for key in sorted(set(obj) - known):
            errors.append(f"{where}: unknown field {key!r} (known tenant "
                          f"columns: {sorted(known)})")
        tid = obj.get("tenant")
        if isinstance(tid, str):
            if tid in seen:
                errors.append(f"{where}: tenant {tid!r} duplicates "
                              f"line {seen[tid]}")
            seen[tid] = ln
    if len(objs) == 1:
        errors.append("fleet manifest names no tenants")
    return errors


def sniff(objs) -> str:
    """Dialect from the first line: 'events' | 'trajectory' | 'results'
    | 'analysis' | 'flightrec' | 'fleet'."""
    if not objs:
        return "events"
    head = objs[0][1]
    if "event" in head:
        return "events"
    if "analysis_manifest" in head:
        return "analysis"
    if "flightrec_manifest" in head:
        return "flightrec"
    if "fleet_manifest" in head:
        return "fleet"
    if "manifest" in head:
        return "trajectory"
    return "results"


_CHECKERS = {"events": check_event_lines,
             "trajectory": check_trajectory_lines,
             "results": check_results_lines,
             "analysis": check_analysis_lines,
             "flightrec": check_flightrec_lines,
             "fleet": check_fleet_lines}


def check_file(path: str, kind: str = "auto") -> list:
    """Parse + validate one JSONL file; returns a list of error strings."""
    objs = []
    errors = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError as e:
                errors.append(f"line {ln}: invalid JSON ({e})")
                continue
            if not isinstance(obj, dict):
                errors.append(f"line {ln}: expected a JSON object")
                continue
            objs.append((ln, obj))
    if kind == "auto":
        kind = sniff(objs)
    if kind not in _CHECKERS:
        raise ValueError(f"unknown dialect {kind!r}")
    return errors + _CHECKERS[kind](objs)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m cocoa_torch.telemetry.schema FILE...",
              file=sys.stderr)
        return 2
    bad = 0
    for path in argv:
        errs = check_file(path)
        if errs:
            bad += 1
            print(f"{path}: {len(errs)} schema violation(s)")
            for e in errs[:20]:
                print(f"  {e}")
        else:
            print(f"{path}: ok")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
