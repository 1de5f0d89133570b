"""Crash flight recorder: the last N events, saved when a run dies (the
port's copy of cocoa_tpu/telemetry/recorder.py, with
:meth:`FlightRecorder.uninstall`, which puts the process's hooks back).

The event JSONL answers postmortems only when the events that explain a
death actually reached disk — and the most interesting deaths are
exactly the ones that interrupt the story: an unhandled exception mid
phase, a SIGTERM from a preempting scheduler, a SIGKILL the process
never sees.  This module closes that gap from both sides:

- **In-process** (:class:`FlightRecorder`): a bounded ring of the most
  recent events + spans, kept as a plain bus subscriber.  On a
  ``divergence`` event, an unhandled exception (``sys.excepthook``), or
  SIGTERM, the ring is dumped ATOMICALLY (temp + rename) to
  ``<events>.flightrec`` — one ``flightrec_manifest`` header line
  (reason, pid, ring size) plus the ring's records, validated by
  ``telemetry/schema.py`` as its own dialect.  The ring works even when
  no JSONL sink is configured (subscribing it activates the bus), so
  every worker of a gang has a recorder regardless of which worker owns
  the shared event file.
- **Supervisor-side** (:func:`dump_victim`): a SIGKILLed worker cannot
  dump anything — but its events were streaming to its per-process
  JSONL the whole time.  When the elastic supervisor observes a worker
  exit nonzero (cocoa_tpu/elastic.py), it reads the tail of the
  victim's stream and writes the same ``.flightrec`` artifact on the
  victim's behalf: a chaos kill yields an explanation (which phase,
  which round, what the last exchanges were), not just a ``gang_resize``
  event.

The dump path convention: ``<stream>.flightrec`` next to the stream it
explains.  Dumps overwrite (atomic replace): the recorder keeps the
LATEST explanation, it does not archive history — the events JSONL is
the archive.
"""

from __future__ import annotations

import collections
import json
import os
import signal
import sys
import time
from typing import Optional

# ring capacity: enough to hold several rounds of a traced gang run
# (round span + KV exchanges + checkpoint writes per round) while keeping
# the dump a glance-sized artifact
DEFAULT_CAPACITY = 256


def _atomic_write_jsonl(path: str, records) -> str:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    os.replace(tmp, path)
    return path


class FlightRecorder:
    """Bounded ring of recent bus events; ``dump()`` writes the
    postmortem artifact.  Subscribe it to the bus (``install`` does, and
    wires the dump triggers)."""

    def __init__(self, path: str, capacity: int = DEFAULT_CAPACITY):
        self.path = path
        self.capacity = int(capacity)
        self.ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self.dumps: list = []          # (reason, path) of every dump fired
        # what install() replaced, for uninstall(): the bus, the previous
        # excepthook and our hook, the previous SIGTERM disposition and
        # our handler (None where install did not replace it)
        self._bus = None
        self._hook = None
        self._term = None

    def __call__(self, rec: dict):
        """Bus subscriber: every event rides the ring; a ``divergence``
        event triggers an immediate dump (the run is about to bail out
        with the console possibly silenced — the ring IS the context)."""
        self.ring.append(dict(rec))
        if rec.get("event") == "divergence":
            self.dump("divergence")

    def dump(self, reason: str, **extra) -> Optional[str]:
        """Write the ring to ``self.path`` (atomic; overwrites the
        previous dump — latest explanation wins).  Never raises: the
        recorder must not turn a crash into a different crash."""
        try:
            records = list(self.ring)
            head = {"flightrec_manifest": {
                "reason": str(reason), "pid": os.getpid(),
                "ts": time.time(), "n_events": len(records),
                "capacity": self.capacity, **extra,
            }}
            _atomic_write_jsonl(self.path, [head] + records)
            self.dumps.append((reason, self.path))
            return self.path
        except Exception:
            return None

    def uninstall(self):
        """Undo :func:`install`: unsubscribe from the bus and put back the
        excepthook and the SIGTERM disposition it replaced, each only
        while it is still ours (a later installer's stays), so a second
        run in the same process does not stack handlers."""
        if self._bus is not None:
            self._bus.unsubscribe(self)
            self._bus = None
        if self._hook is not None:
            prev, ours = self._hook
            if sys.excepthook is ours:
                sys.excepthook = prev
            self._hook = None
        if self._term is not None:
            prev, ours = self._term
            try:
                if signal.getsignal(signal.SIGTERM) is ours:
                    signal.signal(signal.SIGTERM, signal.SIG_DFL
                                  if prev is None else prev)
            except ValueError:
                pass  # not the main thread
            self._term = None


def install(bus, events_path: str,
            capacity: int = DEFAULT_CAPACITY,
            signals: bool = True) -> FlightRecorder:
    """Wire a :class:`FlightRecorder` into ``bus`` and the process:

    - subscribes the ring (activating the bus if it was inert);
    - chains ``sys.excepthook`` so an unhandled exception dumps
      (reason ``unhandled_exception``, the exception named) before the
      original hook prints the traceback;
    - installs a SIGTERM handler (``signals=True``, main thread only)
      that dumps and then re-delivers the signal to the previous
      disposition, so the process still dies with the termination
      status its supervisor expects.

    Returns the recorder (callers keep it to ``dump()`` on their own
    triggers, and to :meth:`~FlightRecorder.uninstall` it).  The dump
    lands at ``<events_path>.flightrec``.
    """
    rec = FlightRecorder(flightrec_path(events_path), capacity=capacity)
    bus.subscribe(rec)
    rec._bus = bus

    prev_hook = sys.excepthook

    def hook(exc_type, exc, tb):
        rec.dump("unhandled_exception", error=exc_type.__name__)
        prev_hook(exc_type, exc, tb)

    sys.excepthook = hook
    rec._hook = (prev_hook, hook)

    if signals:
        try:
            prev_term = signal.getsignal(signal.SIGTERM)

            def on_term(signum, frame):
                rec.dump("sigterm")
                if callable(prev_term):
                    prev_term(signum, frame)
                elif prev_term is signal.SIG_IGN:
                    # the process deliberately ignored SIGTERM before the
                    # recorder installed; keep ignoring — dump and live
                    return
                else:
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

            signal.signal(signal.SIGTERM, on_term)
            rec._term = (prev_term, on_term)
        except ValueError:
            pass  # not the main thread — the excepthook path still works
    return rec


def flightrec_path(stream_path: str) -> str:
    """``<stream>.flightrec`` — the dump next to the stream it explains."""
    return stream_path + ".flightrec"


def worker_stream_path(events_path: str, worker: int) -> str:
    """The per-process event stream convention (cli.py): worker 0 (and
    single-process runs) own ``<events>``; worker p > 0 streams to
    ``<events>.p<p>`` — distinct from the rotation suffix ``.1``."""
    return events_path if worker == 0 else f"{events_path}.p{worker}"


def _tail_events(stream_path: str, last_n: int, pid=None) -> list:
    """The last ``last_n`` parseable event records of a stream (and, if
    the stream was rotated, of its ``.1`` predecessor), optionally
    filtered to one emitter pid."""
    records = []
    for path in (stream_path + ".1", stream_path):
        if not os.path.exists(path):
            continue
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        obj = json.loads(line)
                    except ValueError:
                        continue  # a torn final line is expected on kills
                    if isinstance(obj, dict) and "event" in obj and (
                            pid is None or obj.get("pid") == pid):
                        records.append(obj)
        except OSError:
            continue
    return records[-last_n:]


def dump_victim(events_path: str, victim_index: int, reason: str,
                exit_code=None, generation=None, victim_pid=None,
                last_n: int = DEFAULT_CAPACITY) -> Optional[str]:
    """Supervisor-side dump for a worker that died without the chance to
    dump itself (SIGKILL, OOM): read the tail of the victim's
    per-process stream (``worker_stream_path``) and write
    ``<victim stream>.flightrec`` naming the reason and exit code.

    ``victim_pid`` (the dead Popen's pid) scopes the tail to the victim
    generation's own records: worker 0's stream is shared with the
    supervisor's appends, and every stream accumulates earlier
    generations' records (different pids) — without the filter the
    "victim's last-N events" would misattribute those.  The filter
    falls back to the unscoped tail when the victim pid left no records
    (killed before its first event) so the dump still carries the
    stream's last-known state, labeled accordingly.

    Returns the dump path, or None when the victim left no stream (the
    run was launched without ``--events`` — nothing to explain from).
    Never raises (supervisor teardown must proceed regardless).
    """
    try:
        stream = worker_stream_path(events_path, victim_index)
        scoped = victim_pid is not None
        records = _tail_events(stream, last_n,
                               pid=victim_pid if scoped else None)
        if not records and scoped:
            scoped = False
            records = _tail_events(stream, last_n)
        if not records:
            return None
        head = {"flightrec_manifest": {
            "reason": str(reason), "pid": os.getpid(),
            "ts": time.time(), "n_events": len(records),
            "source": "supervisor", "victim_index": int(victim_index),
            "victim_stream": stream,
            # scope="victim": every record below is the dead process's
            # own; scope="stream": the victim left nothing (or its pid
            # is unknown) and this is the stream's last-known state,
            # possibly multi-emitter
            "scope": "victim" if scoped else "stream",
            **({"victim_pid": int(victim_pid)} if victim_pid is not None
               else {}),
            **({"exit_code": int(exit_code)} if exit_code is not None
               else {}),
            **({"generation": int(generation)} if generation is not None
               else {}),
        }}
        return _atomic_write_jsonl(flightrec_path(stream), [head] + records)
    except Exception:
        return None
