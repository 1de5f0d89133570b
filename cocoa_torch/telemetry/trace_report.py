"""Offline gang-trace assembly: merge per-process span streams, export a
Perfetto/Chrome trace, compute the per-round critical path, attribute
stragglers.

A gang run leaves one event JSONL per process (worker 0 owns
``<events>``, worker p owns ``<events>.p<p>`` — cli.py), each carrying
that process's ``span`` events (telemetry/tracing.py).  This module is
the postmortem/analysis half:

    python -m cocoa_torch.telemetry.trace_report run/events.jsonl \\
        run/events.jsonl.p1 --trace=run/trace.json \\
        --metrics=run/straggler.prom

- **merge** — spans from every stream on one wall-clock timeline (the
  clock model: placement by wall ``start_ts``, duration by per-process
  monotonic ``dur_s`` — see tracing.py and docs/DESIGN.md).
- **Perfetto export** (``--trace``) — Chrome trace-event JSON, one
  process track per worker, loadable at https://ui.perfetto.dev (or
  ``chrome://tracing``).  :func:`check_chrome_trace` validates the
  structure — the same check the tests and CI run on the artifact.
- **per-round critical path** — spans inherit their round from the
  nearest enclosing span that carries a ``round`` attribute; per round
  and phase the gang can only advance at the SLOWEST worker, so the
  round's critical path is, for each phase, the max-across-workers
  duration (and which worker set it).  Under an elastic resize the
  worker set simply changes between rounds — each round's path is
  computed over the workers that actually reported it.
- **straggler attribution** — for each (round, phase), the time the
  gang lost waiting on worker w is ``max(0, dur_w - max(others))``:
  nonzero only for the slowest worker, and exactly the wall-clock the
  phase would have saved had w kept pace.  Summed over rounds and
  ranked, worker × phase: the table's top row IS the straggler.  The
  same numbers render as ``cocoa_phase_seconds{worker,phase}`` and
  ``cocoa_straggler_slack_seconds{worker,phase}`` gauges (``--metrics``)
  for dashboards that already scrape the run's textfiles.
- **query waterfall** (``--queries``) — assemble the sampled
  ``query_trace`` events (--traceSample, docs/DESIGN.md §22) into a
  per-hop p50/p99 waterfall over the serving pipeline — router queue /
  forward / replica queue / device / serialize — and name the DOMINANT
  hop (largest p99): the one answer a latency incident needs first.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional

_NUM = (int, float)


# --- loading + round attribution -------------------------------------------


def load_spans(paths) -> list:
    """Every ``span`` record from the given JSONL files (event streams,
    rotated ``.1`` files, flight-recorder dumps — any dialect whose
    lines are event records).  Unparseable lines are skipped: a stream
    torn by a SIGKILL is exactly the kind of input a postmortem tool
    must accept."""
    spans = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                if isinstance(obj, dict) and obj.get("event") == "span":
                    spans.append(obj)
    attribute_rounds(spans)
    spans.sort(key=lambda s: (s.get("start_ts") or 0.0,
                              s.get("pid") or 0,
                              s.get("span_id") or 0))
    return spans


def worker_of(span: dict):
    """The worker identity a span is attributed to: the tracer's
    configured process index, falling back to the emitter pid (spans
    from a tracer configured without a worker tag)."""
    w = span.get("worker")
    return w if w is not None else span.get("pid")


def attribute_rounds(spans) -> None:
    """Set ``_round`` on every span — its own ``round`` attribute, else
    the nearest ancestor's (the KV gets inside an allgather inside a
    ``round`` span all belong to that round) — and ``_bg``, whether the
    span ran on an overlapped BACKGROUND collector (its own or an
    ancestor's ``overlapped`` attribute — what
    ``async_host_allgather_bytes`` tags its collector spans with; the
    charged-seconds accounting makes background spans yield the
    wall-clock to concurrent foreground work).  Parent chains are
    per-process (span ids restart per process/generation), so the walk
    keys on (pid, span_id)."""
    by_id = {(s.get("pid"), s.get("span_id")): s for s in spans}
    for s in spans:
        node, r, bg, hops = s, None, False, 0
        while node is not None and hops < 64:
            if r is None and node.get("round") is not None:
                r = int(node["round"])
            if node.get("overlapped") or node.get("background"):
                bg = True
            node = by_id.get((node.get("pid"), node.get("parent_id")))
            hops += 1
        s["_round"] = r
        s["_bg"] = bg


# --- Perfetto / Chrome trace export ----------------------------------------

_RESERVED = frozenset((
    "event", "seq", "pid", "ts", "phase", "span_id", "parent_id",
    "worker", "start_ts", "dur_s", "_round", "_bg",
))


def chrome_trace(spans) -> dict:
    """Chrome trace-event JSON: complete ('X') events on one process
    track per worker, one thread track per OS process (so the
    generations of an elastic run appear as successive threads of the
    same worker).  Timestamps are microseconds of wall clock."""
    events = []
    named = set()
    for s in spans:
        w = worker_of(s)
        if w is None or s.get("start_ts") is None:
            continue
        if w not in named:
            named.add(w)
            events.append({"ph": "M", "name": "process_name", "pid": int(w),
                           "tid": 0, "args": {"name": f"worker {w}"}})
        args = {k: v for k, v in s.items()
                if k not in _RESERVED and v is not None}
        if s.get("_round") is not None:
            args["round"] = s["_round"]
        events.append({
            "name": str(s.get("phase")),
            "cat": "cocoa",
            "ph": "X",
            "ts": float(s["start_ts"]) * 1e6,
            "dur": max(float(s.get("dur_s") or 0.0), 0.0) * 1e6,
            "pid": int(w),
            "tid": int(s.get("pid") or 0),
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def check_chrome_trace(obj) -> list:
    """Structural validation of an exported trace (what the tests and CI
    assert on the artifact); returns error strings."""
    errors = []
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        return ["trace must be an object with a traceEvents list"]
    for i, e in enumerate(obj["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            errors.append(f"{where}: not an object")
            continue
        if e.get("ph") not in ("X", "M"):
            errors.append(f"{where}: unsupported phase {e.get('ph')!r}")
            continue
        for field in ("pid", "tid"):
            if not isinstance(e.get(field), int):
                errors.append(f"{where}: missing/invalid {field}")
        if not isinstance(e.get("name"), str):
            errors.append(f"{where}: missing/invalid name")
        if e["ph"] == "X":
            for field in ("ts", "dur"):
                v = e.get(field)
                if not isinstance(v, _NUM) or isinstance(v, bool):
                    errors.append(f"{where}: missing/invalid {field}")
            if isinstance(e.get("dur"), _NUM) and e["dur"] < 0:
                errors.append(f"{where}: negative dur")
    return errors


# --- critical path + stragglers --------------------------------------------


def _charge_spans(intervals, background) -> list:
    """Partition one worker's wall-clock among its (possibly
    overlapping) leaf spans.  Each second of the intervals' union is
    charged to exactly one covering span: FOREGROUND spans (the
    worker's main thread) beat BACKGROUND ones (an ``--overlapComm``
    collector daemon, ``_bg``), and within a class the latest-started
    covering span owns the second (ties broken by list order).
    Returns per-interval charged seconds.

    Rationale (docs/DESIGN.md §15): a collector's KV gets run
    CONCURRENTLY with the main thread's next local-solve — a worker
    owns at most wall-clock seconds of wall-clock, so summing
    overlapped leaves would double-count hidden exchange time straight
    into the critical path and the slack table.  Foreground-beats-
    background charges the compute (or the ``exchange_join`` wait, once
    the thread actually blocks) and shadows the hidden exchange to ~0 —
    which is exactly what "hidden" means; latest-started-owns within a
    class makes same-phase re-entries charge their union.  Disjoint
    spans (every pre-overlap run) are charged their full durations —
    bit-identical to the old per-phase sums."""
    n = len(intervals)
    events = []
    for i, (s0, s1) in enumerate(intervals):
        events.append((s0, 0, i))
        events.append((max(s0, s1), 1, i))
    events.sort(key=lambda e: (e[0], e[1]))
    charged = [0.0] * n
    active: dict = {}
    prev = None
    for t, kind, i in events:
        if prev is not None and active and t > prev:
            fg = [j for j in active if not background[j]]
            pool = fg if fg else list(active)
            owner = max(pool, key=lambda j: (intervals[j][0], j))
            charged[owner] += t - prev
        prev = t
        if kind == 0:
            active[i] = True
        else:
            active.pop(i, None)
    return charged


def _per_round_phase_durs(spans) -> dict:
    """{round: {phase: {worker: seconds}}} over round-attributed LEAF
    spans.  Container spans — those with recorded children, like the
    ``round`` wrapper or an allgather whose gets were traced — are
    excluded: counting both a parent and its children would double
    every nested second in the critical path and the slack totals.  The
    Perfetto export keeps the full hierarchy.

    Per worker, concurrent leaf spans (a phase re-entered several times
    per round is fine; ``--overlapComm`` collector gets riding
    alongside the main thread are the interesting case) share the
    wall-clock via :func:`_charge_spans` — each second charged to the
    latest-started covering span — and the charged seconds then
    aggregate into (round, phase) cells.  Spans missing a ``start_ts``
    (torn streams) fall back to their full duration."""
    containers = {(s.get("pid"), s.get("parent_id"))
                  for s in spans if s.get("parent_id") is not None}
    leaves: dict = {}   # worker -> [span, ...]
    for s in spans:
        if (s.get("pid"), s.get("span_id")) in containers:
            continue
        r, w = s.get("_round"), worker_of(s)
        if r is None or w is None or s.get("dur_s") is None:
            continue
        leaves.setdefault(w, []).append(s)
    table: dict = {}
    for w, ss in leaves.items():
        timed = [s for s in ss if s.get("start_ts") is not None]
        charged = _charge_spans(
            [(float(s["start_ts"]),
              float(s["start_ts"]) + max(0.0, float(s["dur_s"])))
             for s in timed],
            [bool(s.get("_bg")) for s in timed])
        pairs = list(zip(timed, charged)) + [
            (s, max(0.0, float(s["dur_s"])))
            for s in ss if s.get("start_ts") is None]
        for s, d in pairs:
            ph = str(s.get("phase"))
            cell = table.setdefault(s["_round"], {}).setdefault(ph, {})
            cell[w] = cell.get(w, 0.0) + d
    return table


def critical_path(spans) -> list:
    """One entry per round: which (phase, worker) durations bound the
    gang.  ``entries`` lists every phase's slowest worker and duration;
    ``critical_s`` is their sum — the floor on the round's wall-clock
    no matter how fast the other workers run."""
    out = []
    table = _per_round_phase_durs(spans)
    for r in sorted(table):
        phases = table[r]
        entries = []
        for ph in sorted(phases):
            durs = phases[ph]
            worker = max(durs, key=lambda w: (durs[w], str(w)))
            entries.append({"phase": ph, "worker": worker,
                            "dur_s": durs[worker],
                            "workers": len(durs)})
        out.append({"round": r, "entries": entries,
                    "critical_s": sum(e["dur_s"] for e in entries)})
    return out


def stragglers(spans) -> list:
    """Worker × phase rows ranked by cumulative slack — the wall-clock
    the gang lost waiting on that worker in that phase (see module
    docstring for the definition).  Rows exist for every participating
    (worker, phase) pair, so a balanced gang still yields a table (with
    ~zero slack) and the top row always names the straggler."""
    slack: dict = {}
    seconds: dict = {}
    rounds: dict = {}
    for r, phases in _per_round_phase_durs(spans).items():
        for ph, durs in phases.items():
            for w, d in durs.items():
                key = (w, ph)
                seconds[key] = seconds.get(key, 0.0) + d
                rounds[key] = rounds.get(key, 0) + 1
                others = [v for ow, v in durs.items() if ow != w]
                lost = max(0.0, d - max(others)) if others else 0.0
                slack[key] = slack.get(key, 0.0) + lost
    rows = [{"worker": w, "phase": ph, "slack_s": slack[(w, ph)],
             "phase_s": seconds[(w, ph)], "rounds": rounds[(w, ph)]}
            for (w, ph) in slack]
    rows.sort(key=lambda row: (-row["slack_s"], -row["phase_s"],
                               str(row["worker"]), row["phase"]))
    return rows


def metrics_text(spans) -> str:
    """The straggler numbers in the Prometheus textfile format, labeled
    worker × phase — droppable next to the run's ``--metrics`` files."""
    rows = stragglers(spans)
    lines = ["# TYPE cocoa_phase_seconds gauge"]
    for row in sorted(rows, key=lambda r: (str(r["worker"]), r["phase"])):
        lines.append(
            f'cocoa_phase_seconds{{worker="{row["worker"]}",'
            f'phase="{row["phase"]}"}} {row["phase_s"]!r}')
    lines.append("# TYPE cocoa_straggler_slack_seconds gauge")
    for row in sorted(rows, key=lambda r: (str(r["worker"]), r["phase"])):
        lines.append(
            f'cocoa_straggler_slack_seconds{{worker="{row["worker"]}",'
            f'phase="{row["phase"]}"}} {row["slack_s"]!r}')
    return "\n".join(lines) + "\n"


# --- query waterfall (--queries) --------------------------------------------

# the serving pipeline's hops, in traversal order (query_trace fields);
# solo-server traces carry None for the router-side hops and simply
# contribute nothing to those rows
QUERY_HOPS = ("router_queue_s", "forward_s", "replica_queue_s",
              "device_s", "serialize_s")


def load_query_traces(paths) -> list:
    """Every ``query_trace`` record from the given JSONL streams (same
    torn-stream tolerance as :func:`load_spans`)."""
    traces = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                if isinstance(obj, dict) \
                        and obj.get("event") == "query_trace":
                    traces.append(obj)
    traces.sort(key=lambda t: (t.get("ts") or 0.0, t.get("pid") or 0,
                               t.get("seq") or 0))
    return traces


def _percentile(values, q: float) -> float:
    """Nearest-rank percentile over a non-empty list."""
    vs = sorted(values)
    k = max(0, min(len(vs) - 1, int(round(q * (len(vs) - 1)))))
    return vs[k]


def query_waterfall(traces) -> dict:
    """The per-hop latency waterfall over sampled query traces:
    ``{"traces", "hops": {hop: {n, p50_s, p99_s, mean_s}}, "total":
    {...}, "dominant_hop", "requeued", "replicas"}``.  The dominant hop
    is the largest p99 — the tail is what an SLA pages on, so the hop
    that owns the tail is the hop to fix."""
    hops = {}
    for hop in QUERY_HOPS:
        vals = [float(t[hop]) for t in traces
                if t.get(hop) is not None]
        if vals:
            hops[hop] = {"n": len(vals),
                         "p50_s": _percentile(vals, 0.50),
                         "p99_s": _percentile(vals, 0.99),
                         "mean_s": sum(vals) / len(vals)}
    totals = [float(t["total_s"]) for t in traces
              if t.get("total_s") is not None]
    dominant = (max(hops, key=lambda h: hops[h]["p99_s"])
                if hops else None)
    replicas = {}
    for t in traces:
        rep = t.get("replica")
        if rep is not None:
            replicas[rep] = replicas.get(rep, 0) + 1
    return {
        "traces": len(traces),
        "hops": hops,
        "total": ({"n": len(totals),
                   "p50_s": _percentile(totals, 0.50),
                   "p99_s": _percentile(totals, 0.99),
                   "mean_s": sum(totals) / len(totals)}
                  if totals else None),
        "dominant_hop": dominant,
        "requeued": sum(int(t.get("requeues") or 0) for t in traces),
        "replicas": replicas,
    }


def render_queries(wf: dict) -> str:
    """The waterfall as a fixed-width table plus the dominant-hop
    verdict — the human half of ``--queries`` (the dict itself is the
    machine half serve_bench reads)."""
    lines = [f"query traces: {wf['traces']} sampled"
             + (f", {wf['requeued']} requeue(s) survived"
                if wf["requeued"] else "")
             + (", replicas " + ", ".join(
                 f"{r}={n}" for r, n in sorted(wf["replicas"].items()))
                if wf["replicas"] else "")]
    header = f"  {'hop':<16} {'n':>6} {'p50':>10} {'p99':>10} {'mean':>10}"
    lines.append(header)
    for hop in QUERY_HOPS:
        st = wf["hops"].get(hop)
        if st is None:
            continue
        mark = "  <- dominant" if hop == wf["dominant_hop"] else ""
        lines.append(
            f"  {hop[:-2]:<16} {st['n']:>6} {st['p50_s']*1e3:>8.3f}ms "
            f"{st['p99_s']*1e3:>8.3f}ms {st['mean_s']*1e3:>8.3f}ms"
            f"{mark}")
    if wf["total"]:
        st = wf["total"]
        lines.append(
            f"  {'total':<16} {st['n']:>6} {st['p50_s']*1e3:>8.3f}ms "
            f"{st['p99_s']*1e3:>8.3f}ms {st['mean_s']*1e3:>8.3f}ms")
    if wf["dominant_hop"]:
        lines.append(f"dominant hop: {wf['dominant_hop'][:-2]} "
                     f"(p99 {wf['hops'][wf['dominant_hop']]['p99_s']*1e3:.3f}ms)")
    return "\n".join(lines)


# --- CLI --------------------------------------------------------------------


def render_report(spans, top: int = 10) -> str:
    path = critical_path(spans)
    rows = stragglers(spans)
    workers = sorted({worker_of(s) for s in spans
                      if worker_of(s) is not None}, key=str)
    lines = [f"spans: {len(spans)} from {len(workers)} worker(s) "
             f"{workers}, {len(path)} attributed round(s)"]
    if path:
        total = sum(p["critical_s"] for p in path)
        lines.append(f"critical path: {total:.6f}s over "
                     f"{len(path)} round(s)")
        slowest = max(path, key=lambda p: p["critical_s"])
        lines.append(
            f"  slowest round {slowest['round']}: "
            f"{slowest['critical_s']:.6f}s — "
            + ", ".join(f"{e['phase']}={e['dur_s']:.6f}s(w{e['worker']})"
                        for e in slowest["entries"]))
    if rows:
        lines.append(f"stragglers (top {min(top, len(rows))} of "
                     f"{len(rows)} worker x phase rows, by slack):")
        for row in rows[:top]:
            lines.append(
                f"  worker {row['worker']} x {row['phase']}: "
                f"slack {row['slack_s']:.6f}s over {row['rounds']} "
                f"round(s) (own time {row['phase_s']:.6f}s)")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    inputs, trace_out, metrics_out, top = [], None, None, 10
    queries = False
    for a in argv:
        if a.startswith("--trace="):
            trace_out = a.split("=", 1)[1]
        elif a.startswith("--metrics="):
            metrics_out = a.split("=", 1)[1]
        elif a.startswith("--top="):
            top = int(a.split("=", 1)[1])
        elif a == "--queries":
            queries = True
        elif a.startswith("-"):
            print(f"unknown flag {a!r}", file=sys.stderr)
            return 2
        else:
            inputs.append(a)
    if not inputs:
        print("usage: python -m cocoa_torch.telemetry.trace_report "
              "EVENTS.jsonl [EVENTS.jsonl.p1 ...] [--trace=OUT.json] "
              "[--metrics=OUT.prom] [--top=N] [--queries]",
              file=sys.stderr)
        return 2
    missing = [p for p in inputs if not os.path.exists(p)]
    if missing:
        print(f"no such file(s): {missing}", file=sys.stderr)
        return 2
    if queries:
        traces = load_query_traces(inputs)
        if not traces:
            print("no query_trace events in the given streams (was the "
                  "server run with --traceSample and trace=-prefixed "
                  "queries?)", file=sys.stderr)
            return 1
        print(render_queries(query_waterfall(traces)))
        return 0
    spans = load_spans(inputs)
    if not spans:
        print("no span events in the given streams (was the run traced? "
              "pass --trace to the CLI)", file=sys.stderr)
        return 1
    if trace_out:
        trace = chrome_trace(spans)
        errs = check_chrome_trace(trace)
        if errs:  # self-check: never ship an artifact Perfetto rejects
            print(f"internal error: exported trace failed validation: "
                  f"{errs[:5]}", file=sys.stderr)
            return 1
        with open(trace_out, "w") as f:
            json.dump(trace, f)
        print(f"wrote {trace_out} ({len(trace['traceEvents'])} events) — "
              f"open at https://ui.perfetto.dev")
    if metrics_out:
        with open(metrics_out, "w") as f:
            f.write(metrics_text(spans))
        print(f"wrote {metrics_out}")
    print(render_report(spans, top=top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
