"""The live fleet ops plane (counterpart of
cocoa_tpu/telemetry/aggregate.py): merge per-process metrics textfiles
and serve ``/metrics``, ``/healthz``, ``/slo`` over HTTP
(``--statusPort``, docs/DESIGN.md §22).

A serving fleet already writes N+1 Prometheus textfiles — the front
door's own plus one ``<metrics>.r<N>`` per replica (cli.py wires the
suffix, the same ``.rN`` slot convention as the event streams).  Nothing
aggregated them while the system ran: answering "is the fleet inside
its SLA right now" meant hand-merging files.  This module is that
aggregation, deliberately built ON the textfiles rather than on a new
IPC channel: the files are the crash-safe, atomically-renamed artifacts
every process already owns, a scrape is a handful of reads, and a dead
replica keeps its last file on disk — visible as a frozen round and a
climbing gap age rather than a hole in the data.

Endpoints (stdlib ``http.server``, no new dependencies):

- ``/metrics`` — one merged Prometheus exposition: every sample from
  every source file re-labeled with ``replica="<label>"``, families
  grouped under one ``# TYPE`` line each, so a single scrape target
  covers the whole fleet with per-replica attribution.
- ``/healthz`` — JSON liveness + freshness: per replica the router's
  live bit, the newest generation it serves (``cocoa_model_round``)
  and its certificate age (``cocoa_model_gap_age_seconds``), plus the
  fleet-wide live count and newest round.  ``status`` is "ok" only
  when every replica is live — the SIGKILL drill shows "degraded" with
  the victim's live=false, then "ok" again after the respawn.
- ``/slo`` — rolling SLA attainment and multi-window burn rate over
  the fleet-wide ``cocoa_serve_latency_seconds`` histogram: each
  evaluation snapshots the cumulative (served, over-SLA) totals, and
  attainment/burn are computed from deltas inside the fast/slow
  windows — cumulative counters make the rolling math exact across
  scrapes, no per-request state needed.  Each evaluation also emits a
  typed ``slo_status`` event, so the SLO verdicts land in the same
  machine-readable stream as everything else.

The latency histogram's per-batch observations are worst-of-batch
(metrics.py), so the attainment reported here lower-bounds the true
per-request attainment — conservative in the direction an SLO should
be.  Burn rate is the standard error-budget form: ``(1 - attainment) /
(1 - objective)`` over a window; > 1 on both the fast and slow windows
means the budget is burning faster than it refills — the page-worthy
signal — while fast-only is a blip and slow-only an old incident
draining out.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from cocoa_torch.telemetry import events as tele_events

# SLA attainment objective: the p99 budget — 1% of lines may breach
DEFAULT_OBJECTIVE = 0.99
# burn-rate windows (seconds): the fast window catches a live incident,
# the slow window filters blips — the classic multi-window pair scaled
# to a serving loop's cadence rather than a month-long budget
FAST_WINDOW_S = 60.0
SLOW_WINDOW_S = 300.0


# --- exposition parsing ------------------------------------------------------


def split_sample(line: str):
    """One textfile sample line -> ``(name, labels, value)`` strings
    (labels without braces, "" when unlabeled); (None, None, None) on
    comments/blank/garbage — a scraper never throws on a torn file."""
    rest = line.strip()
    if not rest or rest.startswith("#"):
        return None, None, None
    brace = rest.find("{")
    if brace >= 0:
        end = rest.rfind("}")
        if end < brace:
            return None, None, None
        name = rest[:brace]
        labels = rest[brace + 1:end]
        value = rest[end + 1:].strip()
    else:
        name, _, value = rest.partition(" ")
        labels = ""
    if not name or not value:
        return None, None, None
    try:
        float(value)
    except ValueError:
        return None, None, None
    return name, labels, value


def family(name: str) -> str:
    """The family a sample belongs to: histogram member suffixes fold
    into their base name, everything else is its own family."""
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            return name[:-len(suffix)]
    return name


def merge_expositions(sources: Dict[str, str]) -> str:
    """Merge per-process textfiles into ONE exposition: every sample
    re-labeled with ``replica="<label>"`` (prepended, existing labels
    kept), families grouped under a single ``# TYPE`` line each (first
    seen wins), sources in sorted-label order so the merge is
    deterministic."""
    fam_order, fam_type, fam_samples = [], {}, {}

    def _fam(f, type_line=None):
        if f not in fam_type:
            fam_type[f] = type_line or f"# TYPE {f} untyped"
            fam_order.append(f)
        elif type_line and fam_type[f].endswith(" untyped"):
            fam_type[f] = type_line

    for label in sorted(sources):
        for ln in sources[label].splitlines():
            if ln.startswith("# TYPE "):
                parts = ln.split()
                if len(parts) >= 3:
                    _fam(parts[2], ln)
                continue
            name, labels, value = split_sample(ln)
            if name is None:
                continue
            f = family(name)
            _fam(f)
            merged = f'replica="{label}"' + (
                "," + labels if labels else "")
            fam_samples.setdefault(f, []).append(
                f"{name}{{{merged}}} {value}")
    lines = []
    for f in fam_order:
        lines.append(fam_type[f])
        lines += fam_samples.get(f, [])
    return "\n".join(lines) + "\n"


def read_sources(paths: Dict[str, str]) -> Dict[str, str]:
    """label -> textfile content for every source that exists; missing
    or unreadable files are skipped (a replica that never wrote is not
    an aggregator crash)."""
    out = {}
    for label, path in paths.items():
        try:
            with open(path) as f:
                out[label] = f.read()
        except OSError:
            continue
    return out


def scrape_gauge(text: str, name: str) -> Optional[float]:
    """The UNLABELED sample of one family (the whole-process gauge);
    None when absent."""
    for ln in text.splitlines():
        n, labels, value = split_sample(ln)
        if n == name and not labels:
            return float(value)
    return None


def latency_totals(sources: Dict[str, str], sla_s: float):
    """Fleet-wide ``(served_total, over_sla_total)`` from the
    cumulative ``cocoa_serve_latency_seconds`` histogram: within-SLA is
    the cumulative bucket at the largest edge <= sla_s, so latencies in
    (edge, sla] count as over — conservative, never optimistic."""
    total = over = 0
    for text in sources.values():
        count, best_edge, best_cum = 0, -1.0, 0.0
        for ln in text.splitlines():
            name, labels, value = split_sample(ln)
            if name == "cocoa_serve_latency_seconds_count" \
                    and not labels.startswith("replica="):
                count = int(float(value))
            elif name == "cocoa_serve_latency_seconds_bucket":
                le = dict(
                    kv.split("=", 1) for kv in labels.split(",")
                    if "=" in kv).get("le", "").strip('"')
                if le in ("", "+Inf"):
                    continue
                edge = float(le)
                if best_edge < edge <= sla_s:
                    best_edge, best_cum = edge, float(value)
        total += count
        over += count - min(int(best_cum), count)
    return total, over


# --- the rolling SLO math ----------------------------------------------------


class SloTracker:
    """Cumulative-counter snapshots -> rolling attainment + burn.

    Pure bookkeeping (no IO, injectable clock): ``observe`` appends one
    ``(ts, served_total, over_sla_total)`` snapshot, ``status`` computes
    attainment over the slow window (lifetime until the window has two
    snapshots) and the fast/slow burn rates from in-window deltas.
    Counters are monotone (the histogram is cumulative), so a delta is
    exactly the traffic inside the window."""

    def __init__(self, sla_s: float, objective: float = DEFAULT_OBJECTIVE,
                 fast_s: float = FAST_WINDOW_S,
                 slow_s: float = SLOW_WINDOW_S):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got "
                             f"{objective!r}")
        self.sla_s = float(sla_s)
        self.objective = float(objective)
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self._snaps = []   # (ts, served_total, over_sla_total)
        self._lock = threading.Lock()

    def observe(self, served_total: int, over_sla_total: int,
                now: Optional[float] = None):
        now = time.time() if now is None else now
        with self._lock:
            self._snaps.append((now, int(served_total),
                                int(over_sla_total)))
            horizon = now - 2 * self.slow_s
            while len(self._snaps) > 2 and self._snaps[1][0] < horizon:
                self._snaps.pop(0)

    def _window(self, now: float, window_s: float):
        """Attainment over ``[now - window_s, now]`` from the earliest
        in-window snapshot to the latest; None until the window holds a
        delta with traffic in it."""
        last = self._snaps[-1]
        base = None
        for snap in self._snaps:
            if snap[0] >= now - window_s:
                base = snap
                break
        if base is None or base is last:
            return None
        served = last[1] - base[1]
        over = last[2] - base[2]
        if served <= 0:
            return None
        return 1.0 - over / served

    def status(self, now: Optional[float] = None) -> dict:
        now = time.time() if now is None else now
        with self._lock:
            if not self._snaps:
                served = over = 0
                attain = burn_fast = burn_slow = None
            else:
                _, served, over = self._snaps[-1]
                attain = self._window(now, self.slow_s)
                if attain is None and served > 0:
                    attain = 1.0 - over / served   # lifetime fallback
                budget = 1.0 - self.objective
                af = self._window(now, self.fast_s)
                aslow = self._window(now, self.slow_s)
                burn_fast = (None if af is None
                             else (1.0 - af) / budget)
                burn_slow = (None if aslow is None
                             else (1.0 - aslow) / budget)
        return {"sla_ms": self.sla_s * 1e3,
                "objective": self.objective,
                "window_fast_s": self.fast_s,
                "window_slow_s": self.slow_s,
                "attainment": attain,
                "burn_fast": burn_fast, "burn_slow": burn_slow,
                "served_total": served, "over_sla_total": over}


# --- the HTTP plane ----------------------------------------------------------


class StatusServer:
    """``/metrics`` + ``/healthz`` + ``/slo`` over the per-process
    textfiles the fleet already writes.

    ``sources_fn`` returns the label -> path map to scrape (called per
    request, so a respawned replica's slot file is always current);
    ``liveness_fn`` (optional) returns the router's name -> live map —
    without it every scraped source counts as live (the solo server
    case).  Pure stdlib, daemon-threaded, port 0 = ephemeral."""

    def __init__(self, sources_fn: Callable[[], Dict[str, str]],
                 sla_s: float, host: str = "127.0.0.1", port: int = 0,
                 algorithm: str = "serve",
                 liveness_fn: Optional[Callable[[], Dict[str, bool]]]
                 = None,
                 objective: float = DEFAULT_OBJECTIVE):
        self.sources_fn = sources_fn
        self.liveness_fn = liveness_fn
        self.algorithm = algorithm
        self.tracker = SloTracker(sla_s, objective=objective)
        plane = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # the ops plane must not spam
                pass                     # the serving console

            def do_GET(self):
                try:
                    route = self.path.split("?")[0].rstrip("/") or "/"
                    if route == "/metrics":
                        body, ctype = plane.render_metrics(), \
                            "text/plain; version=0.0.4"
                    elif route == "/healthz":
                        body, ctype = plane.render_healthz(), \
                            "application/json"
                    elif route == "/slo":
                        body, ctype = plane.render_slo(), \
                            "application/json"
                    else:
                        self.send_error(404, "unknown endpoint "
                                        "(have /metrics /healthz /slo)")
                        return
                except Exception as e:   # a torn scrape must answer 500,
                    self.send_error(500, f"{type(e).__name__}: {e}")
                    return               # never kill the plane
                raw = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

        class _HTTP(ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._http = _HTTP((host, port), _Handler)
        self._thread = threading.Thread(
            target=self._http.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="cocoa-status-plane")

    @property
    def address(self):
        """(host, port) actually bound — port 0 resolves here."""
        return self._http.server_address

    def start(self):
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0):
        self._http.shutdown()
        self._thread.join(timeout)
        self._http.server_close()

    # --- renderers (also the direct test surface — no sockets needed) ---

    def _scrape(self):
        return read_sources(self.sources_fn())

    def render_metrics(self) -> str:
        return merge_expositions(self._scrape())

    def render_healthz(self) -> str:
        sources = self._scrape()
        live_map = (self.liveness_fn() if self.liveness_fn is not None
                    else {label: True for label in sources})
        replicas = {}
        newest = None
        for name in sorted(set(live_map) | set(sources)):
            text = sources.get(name, "")
            rnd = scrape_gauge(text, "cocoa_model_round")
            age = scrape_gauge(text, "cocoa_model_gap_age_seconds")
            if rnd is not None:
                newest = rnd if newest is None else max(newest, rnd)
            # a scraped source the liveness map does not track (the
            # router's own file) gets live=null, not a false alarm
            replicas[name] = {
                "live": (bool(live_map[name]) if name in live_map
                         else None),
                "round": None if rnd is None else int(rnd),
                "gap_age_s": age}
        n_live = sum(1 for r in live_map.values() if r)
        return json.dumps(
            {"status": ("ok" if live_map
                        and n_live == len(live_map) else "degraded"),
             "replicas_live": n_live,
             "replicas_total": len(live_map),
             "round": None if newest is None else int(newest),
             "replicas": replicas}, sort_keys=True) + "\n"

    def render_slo(self) -> str:
        sources = self._scrape()
        served, over = latency_totals(sources, self.tracker.sla_s)
        self.tracker.observe(served, over)
        status = self.tracker.status()
        live = (sum(1 for v in self.liveness_fn().values() if v)
                if self.liveness_fn is not None else None)
        status["replicas_live"] = live
        self._emit(status)
        return json.dumps(status, sort_keys=True) + "\n"

    def _emit(self, status: dict):
        bus = tele_events.get_bus()
        if bus.active():
            bus.emit("slo_status", algorithm=self.algorithm, **status)
