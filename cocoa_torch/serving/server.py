"""The serving front end: a line-oriented TCP margin server (counterpart
of cocoa_tpu/serving/server.py; the same protocol, byte for byte but
the margins' digits).

Protocol (one JSON response line per request line):

- a request line is one query in the LIBSVM feature grammar
  (``idx:val idx:val ...``, 1-based ids), or several queries joined
  with ``;`` — a client-side batch, which the micro-batcher scores as
  one padded bucket;
- a CATALOGUE server (fleet serving, docs/DESIGN.md §21) additionally
  requires a ``tenant=<id>;`` prefix selecting the catalogue row the
  line's queries score against; responses then carry ``"tenant"``;
- an optional ``trace=<id>;`` prefix BEFORE the tenant prefix arms
  per-query distributed tracing (docs/DESIGN.md §22): the id is 1-32
  lowercase hex chars the CLIENT chose.  A sampled line (1 in
  ``--traceSample``, deterministic counter) gets a ``"trace"`` object
  on its first response entry — the id echoed back plus the per-hop
  seconds (admission queue, device, protocol parse/serialize) and the
  answering generation's round/gap-age/dtype — and, on a solo server,
  a typed ``query_trace`` event.  A ``trace=<id>:<us>;`` form (the
  colon part is the upstream router's queue stamp in microseconds)
  marks a line the fleet router already sampled: it is always traced
  and the ROUTER emits the event (it sees the whole lifecycle).
  Unsampled lines are answered byte-identically to untraced ones —
  the margin math never sees the prefix either way;
- the response is ``{"margin": m, "round": r, "dtype": d}`` per query
  (``round`` = the training round of the model generation that answered
  — how a client observes a hot-swap; ``dtype`` = the model form that
  answered, ``f32``/``bf16``/``int8`` — how a client observes a
  ``--serveDtype`` certificate fallback), a JSON array of those for a
  ``;`` batch,
  or ``{"error": "..."}`` with the numbers for a rejected query
  (rejections are per query: one bad query in a batch fails only
  itself);
- ``shutdown`` stops the whole server (acknowledged first) — the
  clean-exit path the smoke tests and the CLI's signal handlers share.

Connections are thread-per-client (stdlib ThreadingTCPServer); the
batcher is what turns concurrent connections into filled buckets.  The
server owns no model state — it parses, submits, and relays — so
nothing here ever touches the swap path.
"""

from __future__ import annotations

import itertools
import json
import re
import socketserver
import threading
import time

from cocoa_torch.serving.scorer import QueryError, parse_query
from cocoa_torch.telemetry import events as tele_events

# client-chosen trace ids: lowercase hex, bounded — the id is echoed
# into responses and event streams, so the grammar is strict
_TRACE_ID_RE = re.compile(r"^[0-9a-f]{1,32}$")


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
            self._reply(srv.margin_server.answer_line(line))

    def _reply(self, obj):
        try:
            self.wfile.write((json.dumps(obj) + "\n").encode())
            self.wfile.flush()
        except OSError:
            pass   # client went away; its answers are already computed


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    margin_server: "MarginServer" = None

    def initiate_shutdown(self):
        # shutdown() blocks until serve_forever exits — never call it
        # from a handler (or signal) frame that serve_forever is waiting
        # on; hand it to a throwaway thread
        threading.Thread(target=self.shutdown, daemon=True).start()


class MarginServer:
    """Glue: sockets in front, the micro-batcher behind."""

    def __init__(self, batcher, num_features: int, max_nnz: int,
                 host: str = "127.0.0.1", port: int = 0,
                 n_tenants=None, trace_sample: int = 0,
                 algorithm: str = "serve"):
        self.batcher = batcher
        self.num_features = int(num_features)
        self.max_nnz = int(max_nnz)
        # catalogue mode (fleet serving, docs/DESIGN.md §21): queries
        # carry a ``tenant=<id>;`` prefix selecting their catalogue row
        self.n_tenants = None if n_tenants is None else int(n_tenants)
        # sampled query tracing (--traceSample, docs/DESIGN.md §22):
        # 1 in N ``trace=``-prefixed lines is traced; 0 disarms — the
        # prefix is peeled and ignored, answers byte-identical
        self.trace_sample = int(trace_sample)
        self.algorithm = algorithm
        self._trace_seen = itertools.count()
        self._tcp = _TCPServer((host, port), _Handler,
                               bind_and_activate=True)
        self._tcp.margin_server = self

    @property
    def address(self):
        """(host, port) actually bound — port 0 resolves here."""
        return self._tcp.server_address

    def _peel_trace(self, line: str):
        """Split the optional ``trace=<id>[:<us>];`` prefix off a
        request line (docs/DESIGN.md §22); returns
        ``((trace_id, router_queue_s_or_None), rest)`` or
        ``(None, line)``.  The colon form is the fleet router's mark:
        the line was already sampled upstream and the router will emit
        the ``query_trace`` event — this server only stamps its hops
        into the response."""
        if not line.startswith("trace="):
            return None, line
        head, sep, rest = line.partition(";")
        if not sep:
            raise QueryError(
                "trace prefix without a query: expected "
                f"'trace=<id>[:<us>];<query>[;<query>...]', got "
                f"{line!r}")
        body = head[len("trace="):]
        tid, colon, stamp = body.partition(":")
        if not _TRACE_ID_RE.match(tid):
            raise QueryError(
                f"malformed trace id {tid!r}: expected 1-32 lowercase "
                f"hex chars")
        rq_s = None
        if colon:
            try:
                rq_s = int(stamp) / 1e6
            except ValueError:
                raise QueryError(
                    f"malformed trace hop stamp {stamp!r}: expected "
                    f"integer microseconds after ':'")
        return (tid, rq_s), rest

    def _sample(self) -> bool:
        """The deterministic 1-in-N gate: the first trace-prefixed
        line is always sampled (test-friendly), then every Nth.  0
        disarms tracing entirely."""
        n = self.trace_sample
        if n <= 0:
            return False
        return next(self._trace_seen) % n == 0

    def _peel_tenant(self, line: str):
        """Split the optional ``tenant=<id>;`` prefix off a request
        line; returns (tenant_or_None, rest) or raises QueryError with
        the numbers.  The prefix applies to EVERY ``;``-joined query on
        the line (a client batch is one tenant's batch — the router
        groups by tenant, so cross-tenant mixing happens server-side in
        the bucket, not in the protocol)."""
        tenant = None
        if line.startswith("tenant="):
            head, sep, rest = line.partition(";")
            if not sep:
                raise QueryError(
                    "tenant prefix without a query: expected "
                    "'tenant=<id>;<query>[;<query>...]', got "
                    f"{line!r}")
            try:
                tenant = int(head[len("tenant="):])
            except ValueError:
                raise QueryError(
                    f"malformed tenant prefix {head!r}: expected "
                    f"'tenant=<id>' with an integer id")
            line = rest
        if tenant is None and self.n_tenants is not None:
            raise QueryError(
                f"this server serves a catalogue of "
                f"{self.n_tenants} tenant models — prefix queries "
                f"with 'tenant=<id>;' (id in [0, {self.n_tenants}))")
        if tenant is not None and self.n_tenants is None:
            raise QueryError(
                "tenant prefix on a single-model server: this server "
                "serves one model, not a catalogue — drop the "
                "'tenant=' prefix (catalogue serving needs a (T, d) "
                "checkpoint, docs/DESIGN.md §21)")
        if tenant is not None and not 0 <= tenant < self.n_tenants:
            raise QueryError(
                f"tenant {tenant} out of range: this catalogue "
                f"serves {self.n_tenants} tenants (ids 0.."
                f"{self.n_tenants - 1})")
        return tenant, line

    def answer_line(self, line: str):
        """Parse one request line, submit through the batcher, wait for
        the batch, shape the JSON-able response."""
        t_line = time.monotonic()
        try:
            trace, line = self._peel_trace(line)
            tenant, line = self._peel_tenant(line)
        except QueryError as e:
            return {"error": str(e)}
        traced = emit_here = False
        if trace is not None:
            if trace[1] is not None:
                traced = True        # sampled upstream by the router,
                                     # which also emits the event
            elif self._sample():
                traced = emit_here = True
        texts = [t for t in line.split(";") if t.strip()]
        pendings = []
        for text in texts:
            try:
                idx, val = parse_query(text, self.num_features,
                                       self.max_nnz)
            except QueryError as e:
                pendings.append({"error": str(e)})
                continue
            pendings.append(self.batcher.submit(idx, val,
                                                tenant=tenant,
                                                traced=traced))
        t_submitted = time.monotonic()
        out = []
        stamped = None   # the first answered query: its batch's hops
        for p in pendings:
            if isinstance(p, dict):
                out.append(p)
                continue
            try:
                margin = p.result(timeout=30.0)
                resp = {"margin": margin, "round": p.model_round,
                        "dtype": p.served_dtype}
                if tenant is not None:
                    resp["tenant"] = tenant
                out.append(resp)
                if stamped is None:
                    stamped = p
            except Exception as e:
                out.append({"error": f"{type(e).__name__}: {e}"})
        if traced:
            self._stamp_trace(trace, tenant, out, stamped, t_line,
                              t_submitted, emit_here)
        return out if len(texts) > 1 else out[0] if out \
            else {"error": "empty request line"}

    def _stamp_trace(self, trace, tenant, out, stamped, t_line,
                     t_submitted, emit_here):
        """Attach the ``"trace"`` hop breakdown to the line's first
        response entry and (solo mode) emit the ``query_trace`` event.
        ``serialize`` is the host protocol work — the line parse +
        submit leg, the hop the queue/device split cannot see (response
        shaping overlaps the batch wait, so it is not separable)."""
        serialize_s = t_submitted - t_line
        obj = {"id": trace[0],
               "replica_queue_s": None if stamped is None
               else stamped.queue_s,
               "device_s": None if stamped is None
               else stamped.device_s,
               "serialize_s": serialize_s,
               "bucket": None if stamped is None else stamped.bucket,
               "round": None if stamped is None
               else stamped.model_round,
               "gap_age_s": None if stamped is None
               else stamped.gap_age_s,
               "dtype": None if stamped is None
               else stamped.served_dtype}
        if out:
            out[0] = {**out[0], "trace": obj}
        if not emit_here:
            return
        bus = tele_events.get_bus()
        if bus.active():
            bus.emit("query_trace", algorithm=self.algorithm,
                     trace_id=trace[0], tenant=tenant, replica=None,
                     router_queue_s=None, forward_s=None,
                     replica_queue_s=obj["replica_queue_s"],
                     device_s=obj["device_s"],
                     serialize_s=serialize_s,
                     total_s=time.monotonic() - t_line,
                     bucket=obj["bucket"], model_round=obj["round"],
                     gap_age_s=obj["gap_age_s"], dtype=obj["dtype"],
                     requeues=0)

    def serve_forever(self, poll_interval: float = 0.2):
        """Block until ``shutdown`` (protocol line or :meth:`stop`)."""
        self._tcp.serve_forever(poll_interval=poll_interval)

    def stop(self):
        self._tcp.initiate_shutdown()

    def close(self):
        self._tcp.server_close()
