"""The fleet front door (counterpart of cocoa_tpu/serving/router.py):
tenant-aware routing and admission shedding over N scorer replicas
(docs/DESIGN.md §21).

The router speaks the SAME line protocol as a single
:class:`~cocoa_torch.serving.server.MarginServer` (one JSON response line
per request line, ``tenant=<id>;`` prefix, ``shutdown``) so a client
never knows whether it hit one process or a fleet.  Per request line it

- **routes**: ``rr`` round-robins over live replicas; ``tenant`` pins a
  tenant to ``tenant % len(replicas)`` (stable affinity keeps one
  tenant's traffic filling one replica's buckets; a dead home replica
  probes forward to the next live one, so affinity degrades, never
  fails).  Untagged lines always round-robin.
- **sheds before the SLA breaks**: each replica carries an inflight
  count and an EWMA of observed request latency; a line whose cheapest
  projected wait ``(inflight + 1) * ewma`` exceeds the shed budget
  (``_SHED_HEADROOM``  × SLA) on EVERY live replica is refused
  immediately — ``{"error": "shed: ...", "shed": true}`` plus a typed
  ``serve_shed`` event — instead of queueing into a latency violation.
  Shedding is an ADMISSION decision: once a line is admitted it is
  never shed, only requeued.  An idle replica (zero inflight) always
  admits — admitted lines are what update the estimate, so the idle
  probe is how a fleet recovers from a stale post-overload EWMA
  instead of shedding on it forever.
- **requeues on replica death**: a connection that dies mid-request
  (SIGKILLed replica, reset, timeout) marks the replica dead (typed
  ``replica_state`` event), and the line replays against another live
  replica (``requeue`` state, ``requeued=1``).  A killed replica costs
  latency, never a failed query: with no live replica the line WAITS
  (bounded by ``_REVIVE_WAIT_S``) for the fleet monitor to respawn one.

The router holds no model state and no torch — it is pure sockets and
bookkeeping, so it composes with in-process thread replicas (tests) and
spawned CLI replicas (:mod:`cocoa_torch.serving.fleet`) identically.
"""

from __future__ import annotations

import itertools
import json
import re
import socket
import socketserver
import threading
import time
from typing import Optional

from cocoa_torch.telemetry import events as tele_events

# client-chosen trace ids (docs/DESIGN.md §22) — same grammar the
# replica enforces (serving/server.py); a prefix that fails it is left
# on the line so the replica rejects it with the numbers
_TRACE_ID_RE = re.compile(r"^[0-9a-f]{1,32}$")

# fraction of the SLA the projected wait may consume before the router
# sheds; the remainder absorbs estimate error + the hop itself
_SHED_HEADROOM = 0.8
_EWMA = 0.3
# how long an admitted line waits for ANY live replica (fleet restart
# window) before it is allowed to fail — the zero-failed-queries pin
# assumes the monitor respawns well inside this
_REVIVE_WAIT_S = 30.0
_CONNECT_TIMEOUT_S = 5.0
_REPLY_TIMEOUT_S = 30.0


class Replica:
    """One scorer replica as the router sees it: an address, a pool of
    idle connections, and the load/latency bookkeeping the shed and
    route decisions read."""

    def __init__(self, name: str, address):
        self.name = str(name)
        self.address = (address[0], int(address[1]))
        self.live = True
        self.inflight = 0
        self.ewma_s = 0.0
        self.lock = threading.Lock()
        self._idle = []   # pooled (sock, rfile) pairs

    def projected_wait_s(self) -> float:
        """What a new line would wait here: queue depth × observed
        per-line latency.  0.0 until the first observation — an
        unmeasured replica is never shed against."""
        return (self.inflight + 1) * self.ewma_s

    def acquire(self):
        with self.lock:
            if self._idle:
                return self._idle.pop()
        sock = socket.create_connection(self.address,
                                        timeout=_CONNECT_TIMEOUT_S)
        sock.settimeout(_REPLY_TIMEOUT_S)
        return sock, sock.makefile("rb")

    def release(self, conn):
        with self.lock:
            if self.live:
                self._idle.append(conn)
                return
        _close(conn)

    def close_all(self):
        with self.lock:
            idle, self._idle = self._idle, []
        for conn in idle:
            _close(conn)


def _close(conn):
    sock, rfile = conn
    for c in (rfile, sock):
        try:
            c.close()
        except OSError:
            pass


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        srv = self.server
        for raw in self.rfile:
            try:
                line = raw.decode("utf-8", errors="replace").strip()
            except Exception:
                break
            if not line:
                continue
            if line == "shutdown":
                self._reply({"ok": "shutting down"})
                srv.initiate_shutdown()
                return
            self._reply(srv.router.answer_line(line))

    def _reply(self, obj):
        try:
            payload = obj if isinstance(obj, (bytes, bytearray)) \
                else (json.dumps(obj) + "\n").encode()
            self.wfile.write(payload)
            self.wfile.flush()
        except OSError:
            pass


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    router: "Router" = None

    def initiate_shutdown(self):
        threading.Thread(target=self.shutdown, daemon=True).start()


class Router:
    """Front-door TCP server routing request lines across replicas."""

    ROUTES = ("rr", "tenant")

    def __init__(self, replicas, sla_s: float = 0.05,
                 route: str = "rr", host: str = "127.0.0.1",
                 port: int = 0, algorithm: str = "serve",
                 trace_sample: int = 0):
        if route not in self.ROUTES:
            raise ValueError(f"unknown route policy {route!r}: "
                             f"expected one of {self.ROUTES}")
        self.replicas = [r if isinstance(r, Replica) else Replica(*r)
                         for r in replicas]
        if not self.replicas:
            raise ValueError("a router needs at least one replica")
        self.sla_s = float(sla_s)
        self.route = route
        self.algorithm = algorithm
        # sampled query tracing (--traceSample, docs/DESIGN.md §22):
        # 1 in N ``trace=``-prefixed lines is traced end to end — the
        # router strips the prefix from the rest (the replica then does
        # zero trace work and answers byte-identically to an untraced
        # line) and re-stamps sampled lines with its own queue time so
        # the replica knows the line is already sampled upstream
        self.trace_sample = int(trace_sample)
        self._trace_seen = itertools.count()
        self._rr = 0
        self._lock = threading.Lock()
        self.forwarded_total = 0
        self.shed_total = 0
        self.requeue_total = 0
        self.failed_total = 0   # lines that exhausted every recourse —
        # the fleet pin holds this at 0 even under replica SIGKILL
        self._tcp = _TCPServer((host, port), _Handler,
                               bind_and_activate=True)
        self._tcp.router = self

    # --- fleet-facing state ------------------------------------------------

    @property
    def address(self):
        """(host, port) actually bound — port 0 resolves here."""
        return self._tcp.server_address

    def replicas_live(self) -> int:
        return sum(1 for r in self.replicas if r.live)

    def mark_dead(self, rep: "Replica", state: str = "dead"):
        with self._lock:
            was_live = rep.live
            rep.live = False
        rep.close_all()
        if was_live:
            self._emit_replica(rep, state)

    def mark_live(self, name: str, address):
        """Fleet monitor callback after a respawn: the replica returns
        (possibly on a new port) and rejoins routing."""
        for rep in self.replicas:
            if rep.name == name:
                with self._lock:
                    rep.address = (address[0], int(address[1]))
                    rep.live = True
                    rep.inflight = 0
                self._emit_replica(rep, "live")
                return rep
        raise KeyError(f"unknown replica {name!r}: the fleet knows "
                       f"{[r.name for r in self.replicas]}")

    def emit_initial_state(self):
        """One ``replica_state`` "live" event per replica at startup —
        what makes the ``cocoa_serve_replicas_live`` gauge render from
        the first metrics write, not the first death."""
        for rep in self.replicas:
            if rep.live:
                self._emit_replica(rep, "live")

    def _emit_replica(self, rep, state, requeued: int = 0,
                      trace_id: Optional[str] = None):
        bus = tele_events.get_bus()
        if bus.active():
            bus.emit("replica_state", algorithm=self.algorithm,
                     replica=rep.name, state=state,
                     replicas_live=self.replicas_live(),
                     requeued=requeued, trace_id=trace_id)

    # --- routing -----------------------------------------------------------

    def _peel_trace(self, line: str):
        """Strip the optional ``trace=<id>;`` prefix (docs/DESIGN.md
        §22); returns ``(trace_id_or_None, rest)``.  A prefix that
        fails the id grammar is left on the line untouched — the
        replica rejects it with the numbers, keeping the router a pure
        relay for malformed input."""
        if not line.startswith("trace="):
            return None, line
        head, sep, rest = line.partition(";")
        tid = head[len("trace="):]
        if not sep or not _TRACE_ID_RE.match(tid):
            return None, line
        return tid, rest

    def _sample(self) -> bool:
        """Deterministic 1-in-N gate over trace-prefixed lines (the
        first is always sampled); 0 disarms tracing.  The counter is an
        ``itertools.count`` — atomic in CPython without taking the
        router lock, so the gate costs the hot path nothing."""
        n = self.trace_sample
        if n <= 0:
            return False
        return next(self._trace_seen) % n == 0

    def _peel_tenant(self, line: str) -> Optional[int]:
        if not line.startswith("tenant="):
            return None
        head = line.partition(";")[0]
        try:
            return int(head[len("tenant="):])
        except ValueError:
            return None   # the replica rejects it with the numbers

    def _live(self, exclude=()):
        return [r for r in self.replicas
                if r.live and r.name not in exclude]

    def _pick(self, tenant, exclude=()):
        live = self._live(exclude)
        if not live:
            return None
        if self.route == "tenant" and tenant is not None:
            # stable home slot; a dead home probes forward to the next
            # live replica, so affinity degrades instead of failing
            home = tenant % len(self.replicas)
            for off in range(len(self.replicas)):
                rep = self.replicas[(home + off) % len(self.replicas)]
                if rep.live and rep.name not in exclude:
                    return rep
            return None
        with self._lock:
            self._rr += 1
            start = self._rr
        return live[start % len(live)]

    def _shed(self, line, tenant, est_s, inflight,
              trace_id: Optional[str] = None):
        self.shed_total += 1
        bus = tele_events.get_bus()
        if bus.active():
            # trace_id: the exemplar — a shed spike in the counter now
            # names concrete refused queries to go look at
            bus.emit("serve_shed", algorithm=self.algorithm,
                     route=self.route, tenant=tenant,
                     inflight=inflight, est_s=est_s,
                     sla_s=self.sla_s, trace_id=trace_id)
        return {"error": f"shed: projected wait {est_s * 1e3:.1f} ms "
                         f"exceeds the shed budget "
                         f"{self.sla_s * _SHED_HEADROOM * 1e3:.1f} ms "
                         f"(SLA {self.sla_s * 1e3:g} ms) on every "
                         f"live replica — back off and retry",
                "shed": True}

    def answer_line(self, line: str):
        """Route one request line; returns the replica's raw response
        bytes (relayed verbatim) or a router-level JSON object."""
        t_recv = time.monotonic()
        trace_id, line = self._peel_trace(line)
        sampled = trace_id is not None and self._sample()
        tenant = self._peel_tenant(line)
        # --- admission: shed only if EVERY live replica projects past
        # the budget (an unmeasured replica projects 0.0 → admits).
        # An IDLE replica (zero inflight) also always admits: the EWMA
        # is only updated by admitted lines, so after an overload burst
        # the estimate stays inflated until something re-measures it —
        # the idle probe is what lets the fleet recover instead of
        # shedding forever on a stale estimate.
        budget = self.sla_s * _SHED_HEADROOM
        rep = self._pick(tenant)
        if rep is not None and rep.projected_wait_s() > budget:
            best = min(self._live(), key=Replica.projected_wait_s)
            if best.projected_wait_s() > budget and best.inflight > 0:
                return self._shed(line, tenant, best.projected_wait_s(),
                                  best.inflight, trace_id=trace_id)
            rep = best
        # --- admitted: forward, requeueing past dead replicas; never
        # fail while a live replica exists or can still come back
        tried = set()
        requeues = 0
        deadline = time.monotonic() + _REVIVE_WAIT_S
        while True:
            if rep is None:
                if time.monotonic() > deadline:
                    self.failed_total += 1
                    return {"error": "no live replica: the whole "
                                     "fleet is down and none came "
                                     f"back within {_REVIVE_WAIT_S:g}"
                                     "s"}
                time.sleep(0.05)
                tried.clear()   # a respawn may reuse the name
                rep = self._pick(tenant, exclude=tried)
                continue
            t_fwd = time.monotonic()
            fwd_line = line
            if sampled:
                # re-stamp per attempt: the prefix carries THIS line's
                # accumulated router queue (admission + revive waits)
                # in microseconds, and its colon form tells the replica
                # the line is already sampled — the replica stamps its
                # hops into the response and emits nothing
                fwd_line = (f"trace={trace_id}:"
                            f"{int((t_fwd - t_recv) * 1e6)};{line}")
            resp = self._forward(rep, fwd_line)
            if resp is not None:
                self.forwarded_total += 1
                if sampled:
                    self._emit_trace(trace_id, tenant, rep, resp,
                                     t_recv, t_fwd, requeues)
                return resp
            # replica died under us: dead + requeue, stats first so
            # the gauges already show the requeue when the event lands
            self.mark_dead(rep)
            self.requeue_total += 1
            requeues += 1
            self._emit_replica(rep, "requeue", requeued=1,
                               trace_id=trace_id)
            tried.add(rep.name)
            rep = self._pick(tenant, exclude=tried)

    def _emit_trace(self, trace_id, tenant, rep, resp, t_recv, t_fwd,
                    requeues):
        """The fleet-mode ``query_trace`` event: the router saw the
        whole lifecycle, so it owns the emission.  Replica-side hops
        ride back in the response's ``"trace"`` object (relayed to the
        client verbatim); the forward hop is the wire + relay residual
        once those are subtracted."""
        bus = tele_events.get_bus()
        if not bus.active():
            return
        t_reply = time.monotonic()
        tobj = None
        try:
            reply = json.loads(resp.decode("utf-8", errors="replace"))
            entries = reply if isinstance(reply, list) else [reply]
            for entry in entries:
                if isinstance(entry, dict) and "trace" in entry:
                    tobj = entry["trace"]
                    break
        except (ValueError, AttributeError):
            pass   # a malformed reply still gets its router-side hops
        tobj = tobj if isinstance(tobj, dict) else {}
        replica_total = sum(tobj.get(k) or 0.0
                            for k in ("replica_queue_s", "device_s",
                                      "serialize_s"))
        bus.emit("query_trace", algorithm=self.algorithm,
                 trace_id=trace_id, tenant=tenant, replica=rep.name,
                 router_queue_s=t_fwd - t_recv,
                 forward_s=max(0.0, (t_reply - t_fwd) - replica_total),
                 replica_queue_s=tobj.get("replica_queue_s"),
                 device_s=tobj.get("device_s"),
                 serialize_s=tobj.get("serialize_s"),
                 total_s=t_reply - t_recv,
                 bucket=tobj.get("bucket"),
                 model_round=tobj.get("round"),
                 gap_age_s=tobj.get("gap_age_s"),
                 dtype=tobj.get("dtype"), requeues=requeues)

    def _forward(self, rep: Replica, line: str):
        """One attempt against one replica; None means the replica is
        gone (caller requeues)."""
        t0 = time.monotonic()
        with self._lock:
            rep.inflight += 1
        try:
            conn = rep.acquire()
        except OSError:
            with self._lock:
                rep.inflight -= 1
            return None
        sock, rfile = conn
        try:
            sock.sendall((line + "\n").encode())
            raw = rfile.readline()
            if not raw:          # EOF: the replica process died
                raise OSError("replica closed the connection")
        except OSError:
            _close(conn)
            with self._lock:
                rep.inflight -= 1
            return None
        took = time.monotonic() - t0
        with self._lock:
            rep.inflight -= 1
            rep.ewma_s = (took if rep.ewma_s == 0.0
                          else (1 - _EWMA) * rep.ewma_s + _EWMA * took)
        rep.release(conn)
        return raw   # relayed verbatim — bytes already end in \n

    # --- lifecycle ---------------------------------------------------------

    def serve_forever(self, poll_interval: float = 0.2):
        self._tcp.serve_forever(poll_interval=poll_interval)

    def stop(self):
        self._tcp.initiate_shutdown()

    def close(self):
        self._tcp.server_close()
        for rep in self.replicas:
            rep.close_all()
