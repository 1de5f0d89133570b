"""Gang-wide span tracing: what phase, on which worker, burned the time
(the port's copy of cocoa_tpu/telemetry/tracing.py).

The event bus (telemetry/events.py) answers *what happened* — evals,
backoffs, resizes.  This module answers *where the wall-clock went*: a
span is one timed phase execution (an ingest pass, a KV exchange, a
local-solve super-block, an eval window, a checkpoint save, a supervisor
generation), emitted through the bus as a typed ``span`` event when it
CLOSES.  The offline assembler (telemetry/trace_report.py) merges the
per-process span streams of a gang run into one timeline, exports a
Perfetto/Chrome trace, and attributes stragglers per worker × phase.

Design constraints, in order:

- **Zero perturbation.**  Spans are host-side bookkeeping around code
  that is already host-side (dispatch boundaries, file IO, KV waits);
  nothing a span does reads or writes device values, so a traced run's
  ``(w, α)`` and sched vector are bit-identical to an untraced run
  (tests/test_torch_tracing.py).  The corollary: a span enter/exit
  never sits inside a captured CUDA graph's body (solvers/base.py
  ``ChunkRunner._capture``, ``DeviceLoopRunner._capture``), where it
  would run once at capture and never at replay.
- **Inert by default.**  ``span()`` on a disabled tracer yields a shared
  null context — one attribute read and no allocation beyond the
  contextmanager frame — so the instrumented call sites cost nothing on
  untraced runs.
- **Clock model** (docs/DESIGN.md "Observability"): durations come from
  ``time.monotonic()`` (immune to NTP steps mid-span); the placement of
  a span on the merged timeline comes from its wall-clock ``start_ts``
  (``time.time()`` at enter).  Cross-process alignment is therefore
  wall-clock-grade (NTP skew bounds it); per-span durations — what the
  critical path and straggler slack are computed from — are exact per
  process.  Within one process, nesting is tracked by a thread-local
  stack, so a span's ``parent_id`` names the span it ran inside (the
  KV gets inside an allgather inside a round).
- **Where the card's time lands.**  A span adds no synchronize, no
  ``.item()`` and no fetch: around a CUDA-graph replay it measures the
  launch, and the device time it queued lands in the next span that
  waits on the stream — the ``eval`` span, whose metrics fetch is the
  host's one read of the card per eval (on ``--deviceLoop``, the
  super-block's ``local_solve`` span, which holds its fetch).

Span event fields: ``phase`` (the instrument point's name), ``span_id``
/ ``parent_id`` (per-process, thread-safe counter), ``worker`` (the
process index the tracer was configured with), ``start_ts`` (wall),
``dur_s`` (monotonic), plus free-form attributes (``round``, ``path``,
``key``, ``generation``, ...) the call site tags on.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time


class Tracer:
    """Process-global span source.  ``configure(enabled=True, worker=i)``
    arms it (the CLI does this under ``--trace``); ``span``/``traced``
    are the two instrumentation forms.  Spans are emitted through the
    process-global EventBus, so they ride the same JSONL sink, metrics
    writer, and flight-recorder ring as every other event — and an
    armed tracer with an inert bus emits nothing (one more cheap guard).
    """

    def __init__(self):
        self.enabled = False
        self.worker = None
        self._ids = itertools.count(1)
        self._local = threading.local()

    def configure(self, enabled: bool = True, worker=None) -> "Tracer":
        self.enabled = bool(enabled)
        if worker is not None:
            self.worker = int(worker)
        return self

    def reset(self):
        """Disarm and forget the worker tag + id counter (tests)."""
        self.enabled = False
        self.worker = None
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, phase: str, **attrs):
        """Time one phase execution; emits the ``span`` event at exit.

        Yields the span id (or None when disabled).  The event is
        emitted even when the body raises — a phase that died mid-way
        is exactly what the flight recorder wants on its ring — with
        an ``error`` attribute naming the exception type.
        """
        if not self.enabled:
            yield None
            return
        from cocoa_torch.telemetry import events as _events

        bus = _events.get_bus()
        if not bus.active():
            yield None
            return
        sid = next(self._ids)
        stack = self._stack()
        parent = stack[-1] if stack else None
        stack.append(sid)
        start_ts = time.time()
        t0 = time.monotonic()
        err = None
        try:
            yield sid
        except BaseException as e:
            err = type(e).__name__
            raise
        finally:
            dur = time.monotonic() - t0
            stack.pop()
            fields = dict(phase=str(phase), span_id=sid, parent_id=parent,
                          worker=self.worker, start_ts=start_ts,
                          dur_s=dur, **attrs)
            if err is not None:
                fields["error"] = err
            bus.emit("span", **fields)

    def traced(self, phase: str, **attrs):
        """Decorator form: ``@tracer.traced("checkpoint_save")``."""
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                with self.span(phase, **attrs):
                    return fn(*args, **kwargs)
            return wrapper
        return deco


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer every instrument point shares."""
    return _TRACER


def configure(enabled: bool = True, worker=None) -> Tracer:
    return _TRACER.configure(enabled=enabled, worker=worker)


def span(phase: str, **attrs):
    """Module-level convenience: ``with tracing.span("eval", round=t):``"""
    return _TRACER.span(phase, **attrs)


def traced(phase: str, **attrs):
    """Module-level convenience decorator."""
    return _TRACER.traced(phase, **attrs)


def reset():
    """Disarm the process-global tracer (tests)."""
    _TRACER.reset()
