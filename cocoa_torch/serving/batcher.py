"""Adaptive micro-batching: admit under a latency budget, pad to a
static bucket, score once (counterpart of cocoa_tpu/serving/batcher.py).

A request's latency is admission wait plus device time, and throughput
is real rows a batch.  The batcher therefore

- **waits only while the SLA can afford it**: a batch's admission window
  closes at ``oldest.t_enq + (sla - device_est - margin)``, where
  ``device_est`` is a per-bucket EWMA of measured score-and-fetch time.
  Bursts fill big buckets; a lone request ships almost at once.
- **picks the tightest bucket**: the smallest static bucket that holds
  the admitted requests.

Instrumentation: the admission wait and the scoring are separate spans
(``serve_admit`` / ``serve_score``), every batch emits one
``serve_request`` event, and its margins cross to the host exactly once,
through events.py ``host_fetch`` (a ``host_transfer`` event labelled
``serve_fetch``): that fetch is the batch's only wait on the device.

Swap interaction: the batcher reads ``slots.current()`` once a batch, so
a whole bucket is answered by one model generation and a swap takes
effect at the next batch boundary; the batch holds its model tensor
until its fetch has returned.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

from cocoa_torch.serving.scorer import pick_bucket
from cocoa_torch.telemetry import events as tele_events
from cocoa_torch.telemetry import tracing

# fraction of the SLA reserved against estimate error and fetch jitter
_SLA_SAFETY = 0.25
_EWMA = 0.3
# early ship: once the queue has been idle this long, stop waiting for
# stragglers (a burst keeps admitting until the bucket or the SLA window
# closes)
_IDLE_GAP_S = 0.002


class PendingQuery:
    """One in-flight request: parsed arrays in, margin (or error) out."""

    __slots__ = ("idx", "val", "tenant", "t_enq", "done", "margin",
                 "error", "model_round", "served_dtype", "traced",
                 "queue_s", "device_s", "bucket", "gap_age_s")

    def __init__(self, idx, val, tenant=None, traced=False):
        self.idx = idx
        self.val = val
        self.tenant = tenant
        self.t_enq = time.monotonic()
        self.done = threading.Event()
        self.margin = None
        self.error = None
        self.model_round = None
        self.served_dtype = None
        # a sampled query (--traceSample) gets its batch's hop breakdown
        # stamped at completion
        self.traced = traced
        self.queue_s = None
        self.device_s = None
        self.bucket = None
        self.gap_age_s = None

    def result(self, timeout: Optional[float] = None) -> float:
        if not self.done.wait(timeout):
            raise TimeoutError("serving batch never completed")
        if self.error is not None:
            raise self.error
        return self.margin


class MicroBatcher:
    """Owns the scoring thread: drains the request queue into padded
    buckets and scores them."""

    def __init__(self, scorer, slots, sla_s: float = 0.05,
                 algorithm: str = "serve", calibration=None):
        slots_sd = getattr(slots, "serve_dtype", "f32")
        scorer_sd = getattr(scorer, "serve_dtype", "f32")
        if slots_sd != scorer_sd:
            raise ValueError(
                f"serve dtype mismatch: ModelSlots publishes "
                f"{slots_sd} model forms but BatchScorer compiled for "
                f"{scorer_sd} — construct both with the same dtype= "
                f"(the CLI wires --serveDtype={slots_sd!s} into both)")
        self.scorer = scorer
        self.slots = slots
        self.sla_s = float(sla_s)
        self.algorithm = algorithm
        # ring of recent queries the quantization certificate reads
        self._calibration = calibration
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._device_est = {b: 0.0 for b in scorer.buckets}
        self.batches_total = 0
        self.requests_total = 0
        self.slots_total = 0    # sum of buckets: the fill denominator
        self.failed_total = 0   # requests whose batch raised
        self.fetches_total = 0  # device reads: one a scored batch
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="cocoa-serve-batcher")
        self._thread.start()

    def submit(self, idx, val, tenant=None, traced=False) -> PendingQuery:
        """Enqueue one parsed query; returns its pending handle.
        ``tenant`` is the catalogue row it scores against (None on a
        single-model scorer); ``traced`` marks a sampled query."""
        if self._calibration is not None:
            self._calibration.record(idx, val)
        pend = PendingQuery(idx, val, tenant, traced=traced)
        self._q.put(pend)
        return pend

    def score_sync(self, idx, val, timeout: Optional[float] = None,
                   tenant=None):
        """Submit and wait: the in-process client."""
        return self.submit(idx, val, tenant=tenant).result(timeout)

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        self._q.put(None)   # wake the blocking get
        self._thread.join(timeout)

    # --- the scoring thread --------------------------------------------------

    def _admit(self, first) -> list:
        """Gather requests behind ``first`` while the SLA affords it."""
        max_bucket = self.scorer.buckets[-1]
        batch = [first]
        est = max(self._device_est.values())
        window = max(0.0, self.sla_s * (1.0 - _SLA_SAFETY) - est)
        deadline = first.t_enq + window
        while len(batch) < max_bucket:
            remaining = deadline - time.monotonic()
            try:
                nxt = (self._q.get_nowait() if remaining <= 0
                       else self._q.get(timeout=min(remaining,
                                                    _IDLE_GAP_S)))
            except queue.Empty:
                break   # idle queue or closed window
            if nxt is None:   # stop sentinel: score what we hold
                self._q.put(None)
                break
            batch.append(nxt)
        return batch

    def _run(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is None:
                continue
            with tracing.span("serve_admit"):
                batch = self._admit(first)
            bucket = pick_bucket(len(batch), self.scorer.buckets)
            # one model a batch; the tensor stays referenced here until
            # the fetch below has returned
            w_dev, scale, info, served = self.slots.current()
            t_score = time.monotonic()
            queue_s = t_score - first.t_enq
            try:
                with tracing.span("serve_score", bucket=bucket,
                                  n=len(batch)):
                    idx, val, hot = self.scorer.assemble(
                        [(p.idx, p.val) for p in batch], bucket)
                    # catalogue scorer: each query carries its tenant row
                    # (the server checked its range); padded rows gather
                    # tenant 0 against all-zero values
                    tenant = None
                    if getattr(self.scorer, "n_tenants", None) \
                            is not None:
                        tenant = self.scorer.assemble_tenants(
                            [p.tenant or 0 for p in batch], bucket)
                    out = self.scorer.score(w_dev, idx, val, hot,
                                            scale, tenant, served)
                    margins = tele_events.host_fetch(out, "serve_fetch")
                    self.fetches_total += 1
            except Exception as e:   # answer the callers, keep serving
                self.failed_total += len(batch)
                for p in batch:
                    p.error = e
                    p.done.set()
                continue
            device_s = time.monotonic() - t_score
            est = self._device_est[bucket]
            self._device_est[bucket] = (device_s if est == 0.0
                                        else (1 - _EWMA) * est
                                        + _EWMA * device_s)
            done = time.monotonic()
            lats = [done - p.t_enq for p in batch]
            gap_age = None   # computed once a batch, only if traced
            for r, p in enumerate(batch):
                p.margin = float(margins[r])
                p.model_round = info.round
                p.served_dtype = served
                if p.traced:
                    if gap_age is None:
                        gap_age = max(0.0, time.time()
                                      - info.birth_ts)
                    p.queue_s = t_score - p.t_enq
                    p.device_s = device_s
                    p.bucket = bucket
                    p.gap_age_s = gap_age
                p.done.set()
            self.batches_total += 1
            self.requests_total += len(batch)
            self.slots_total += bucket
            bus = tele_events.get_bus()
            if bus.active():
                bus.emit(
                    "serve_request", algorithm=self.algorithm,
                    n=len(batch), bucket=bucket,
                    fill_ratio=len(batch) / bucket, queue_s=queue_s,
                    device_s=device_s, latency_max_s=max(lats),
                    latency_mean_s=sum(lats) / len(lats),
                    model_round=info.round)
