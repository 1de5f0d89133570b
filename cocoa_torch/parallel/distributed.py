"""Multi-process runtime (counterpart of cocoa_tpu/parallel/distributed.py).

The reference's ``--master`` selects the Spark cluster manager
(hingeDriver.scala:23: ``local[4]`` or a ``spark://host:port`` URL).  The
JAX package connects its processes through ``jax.distributed``; here the
processes form a ``torch.distributed`` gang over TCP: every rank runs the
same program, ``--master=host:port`` names the rendezvous, and rank r of
P holds the K/P consecutive shards [r*m, (r+1)*m) (parallel/mesh.py).

Two groups carry the gang's traffic:

- the **host group**, gloo over the whole world: host bytes and CPU
  tensors (the backend probe, :func:`host_allgather_bytes`, the
  checkpoint's alpha gather);
- the **device group**: the round's all-reduce of dw and the eval's
  sums (parallel/fanout.py).  NCCL when every rank has a card of its own
  (:func:`device_backend`), else the host group itself; on the CPU
  always gloo.  A failed NCCL set-up raises: the rule is not a quiet
  fallback.

A third path carries host bytes by key: the gang's rendezvous store
(:func:`kv_client`), the counterpart of the JAX package's coordination
KV.  Its exchanges (:func:`kv_allgather_bytes` and the overlapped
:func:`async_host_allgather_bytes`) match by key, not by order, so a
collector thread can run one beside the main thread's gloo collectives.

``--master=local[...]`` / ``local`` / empty keeps the single-process
path, as the reference's local mode.  Anything of the form ``host:port``
(or ``spark://host:port``, accepted for drop-in compatibility) is the
rendezvous address.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import threading
import time
from typing import Optional

import torch

from cocoa_torch.telemetry import events as _events
from cocoa_torch.telemetry import tracing as _tracing

# how long a rank waits for its peers at the rendezvous and in each
# collective before it raises
TIMEOUT_S = 600.0


def parse_master(master: Optional[str]) -> Optional[str]:
    """Coordinator address from a reference-style --master value, or None
    for local mode."""
    if not master:
        return None
    m = master.strip()
    if m == "local" or m.startswith("local["):
        return None
    for prefix in ("spark://", "jax://", "grpc://"):
        if m.startswith(prefix):
            m = m[len(prefix):]
            if ":" not in m:
                # an explicit scheme unambiguously requests cluster mode —
                # silently degrading to local would train K independent
                # copies, one per host
                raise ValueError(
                    f"--master={master!r} requests cluster mode but has no "
                    f"port; use {prefix}host:port"
                )
            return m
    return m if ":" in m else None


def gang_spec(
    master: Optional[str],
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
) -> Optional[tuple]:
    """(coordinator, rank, world) of the gang that --master names, None
    in local mode, with the checks and messages of :func:`maybe_initialize`
    and without joining anything.

    ``process_id`` / ``num_processes`` fall back to COCOA_PROCESS_ID /
    COCOA_NUM_PROCESSES.  Unlike a TPU pod, nothing on a GPU host tells a
    process its rank, so a rank or world size that is still missing
    raises."""
    coordinator = parse_master(master)
    if coordinator is None:
        return None
    if process_id is None and os.environ.get("COCOA_PROCESS_ID"):
        process_id = int(os.environ["COCOA_PROCESS_ID"])
    if num_processes is None and os.environ.get("COCOA_NUM_PROCESSES"):
        num_processes = int(os.environ["COCOA_NUM_PROCESSES"])
    if process_id is None or num_processes is None:
        raise ValueError(
            f"--master={master} needs --processId and --numProcesses (or "
            f"COCOA_PROCESS_ID and COCOA_NUM_PROCESSES): a GPU host has no "
            f"metadata server to tell a process its rank")
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(
            f"--processId={process_id} must lie in [0, --numProcesses="
            f"{num_processes})")
    return coordinator, process_id, num_processes


def maybe_initialize(
    master: Optional[str],
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
    timeout_s: float = TIMEOUT_S,
) -> bool:
    """Join this process to the gang if --master names a coordinator
    (:func:`gang_spec`): ``torch.distributed`` with the gloo world group,
    rendezvous at ``tcp://<coordinator>``.  Returns True iff distributed
    mode was initialized."""
    spec = gang_spec(master, process_id, num_processes)
    if spec is None:
        return False
    coordinator, process_id, num_processes = spec
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", rank=process_id,
        world_size=num_processes,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def initialized() -> bool:
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized())


def world_size() -> int:
    """The gang's size, 1 without a gang."""
    return torch.distributed.get_world_size() if initialized() else 1


def rank_device(rank: int, device) -> torch.device:
    """Rank r's device: ``cuda:(r % cards)`` on CUDA, the CPU when the
    caller asks for it."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def device_backend(posts, cuda: bool) -> str:
    """The device group's backend from every rank's posted (host name,
    device index) pair: ``nccl`` when the ranks are on CUDA and no two
    share a card, else ``gloo`` (NCCL cannot put two ranks on one card;
    on the CPU the device group is the host group)."""
    posts = [tuple(p) for p in posts]
    if cuda and len(set(posts)) == len(posts):
        return "nccl"
    return "gloo"


def host_allgather_bytes(payload: bytes, group=None) -> list:
    """All-gather one bytes payload per rank over the host group; returns
    the payloads in rank order (every rank sees the same list).
    Single-process: ``[payload]``."""
    if not initialized():
        return [bytes(payload)]
    out = [None] * torch.distributed.get_world_size(group)
    torch.distributed.all_gather_object(out, bytes(payload), group=group)
    return out


def host_gather_shards(x: torch.Tensor, axis: int = 0,
                       every: int = 1) -> torch.Tensor:
    """Every rank's block of shards, concatenated in rank order along
    ``axis`` (the shard axis), on the host: the checkpoint's whole alpha
    from each rank's (m, n_shard), over the gloo host group (gloo gathers
    host tensors only).  ``every`` = F on a feature-parallel gang, whose
    F ranks of a dp position hold the same shards: the blocks of ranks
    0, F, 2F, ... only.  Single-process: ``x`` on the host."""
    x = x.detach().cpu().contiguous()
    if not initialized():
        return x
    parts = [torch.empty_like(x)
             for _ in range(torch.distributed.get_world_size())]
    torch.distributed.all_gather(parts, x)
    return torch.cat(parts[::every], dim=axis)


def post_device(device: torch.device) -> list:
    """Every rank's (host name, device index) pair, in rank order, over
    the host group: what :func:`device_backend` decides from."""
    mine = (socket.gethostname(), -1 if device.type != "cuda"
            else device.index)
    return [pickle.loads(b) for b in
            host_allgather_bytes(pickle.dumps(mine))]


# --- the store path: keyed host exchanges -----------------------------------
#
# The gloo host group matches collectives by their order, so a collective
# issued from a second thread would pair with whatever the main thread
# issues next.  The exchanges below go through the rendezvous store
# instead, by key, as the JAX package's go through the coordination
# service's key-value store: a key names one payload of one rank in one
# exchange, and any thread may post or read it at any time.

# one raw chunk per store value, as the JAX package chunks its payloads
_KV_CHUNK = 2 << 20
# the exchanges' keys live under this prefix of the rendezvous store
_KV_PREFIX = "kv"

# the store's wait policy (cocoa_tpu/parallel/distributed.py:113-122): one
# logical get is a bounded sequence of short blocking attempts, with an
# exponential backoff after fast failures, not one wait for the whole
# budget; a transient error retries, and the final failure names the
# missing key and the peer it stands for
KV_TIMEOUT_S = 600.0       # total budget per logical key
KV_ATTEMPT_S = 20.0        # per-attempt blocking wait
_KV_BACKOFF_BASE_S = 0.25  # pause after a FAST failure (doubled, capped)
_KV_BACKOFF_CAP_S = 5.0


def _gang_store():
    """The rendezvous store under the default group's prefixes."""
    store = torch.distributed.distributed_c10d._get_default_store()
    while isinstance(store, torch.distributed.PrefixStore):
        store = store.underlying_store
    return store


def kv_client():
    """The gang's store behind the exchanges' prefix, or None in a single
    process (no gang, or a gang of one)."""
    if not initialized() or torch.distributed.get_world_size() == 1:
        return None
    return torch.distributed.PrefixStore(_KV_PREFIX, _gang_store())


def _store_address(timeout_s: float) -> tuple:
    """(host, port, timeout) of the gang's TCP store, read on the
    caller's thread, from which a collector thread opens a connection of
    its own (:func:`_connect`).  A TCP store client holds its lock through
    a blocking wait, so a collector waiting on the caller's connection
    would hold up the caller's next post until the awaited peer came."""
    store = _gang_store()
    if not isinstance(store, torch.distributed.TCPStore):
        raise RuntimeError(
            f"the overlapped exchange needs the gang's TCP store (a "
            f"--master=host:port rendezvous), got {type(store).__name__}")
    return store.host, store.port, datetime.timedelta(seconds=timeout_s)


def _connect(address: tuple):
    """A new client of the store at ``address``, behind the prefix."""
    host, port, timeout = address
    return torch.distributed.PrefixStore(_KV_PREFIX, torch.distributed.TCPStore(
        host, port, is_master=False, timeout=timeout))


def blocking_kv_get(client, key: str, *, timeout_s: float = KV_TIMEOUT_S,
                    attempt_s: float = KV_ATTEMPT_S,
                    what: Optional[str] = None) -> bytes:
    """A bounded, retrying get of ``key`` from the store ``client``:
    ``wait([key])`` in attempts of at most ``attempt_s``, then ``get``.

    Retries (with a capped exponential backoff after fast failures) until
    ``timeout_s`` is spent, then raises a RuntimeError naming the key and
    ``what`` (the peer or exchange it stands for), chaining the last
    underlying error.  A dead peer thus fails this process within
    ``timeout_s``, where a plain ``get`` would block for the store's whole
    timeout."""
    with _tracing.span("kv_get", key=key, what=what):
        return _blocking_kv_get(client, key, timeout_s=timeout_s,
                                attempt_s=attempt_s, what=what)


def _blocking_kv_get(client, key: str, *, timeout_s: float,
                     attempt_s: float, what: Optional[str]) -> bytes:
    deadline = time.monotonic() + timeout_s
    attempts = 0
    fast_failures = 0
    last_err = None
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        attempts += 1
        wait_s = min(attempt_s, remaining)
        t0 = time.monotonic()
        try:
            client.wait([key], datetime.timedelta(
                milliseconds=max(1, int(wait_s * 1000))))
            return client.get(key)
        except RuntimeError as e:  # a timeout, or a transient store error
            last_err = e
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        # back off only after a FAST failure (the store refused or erred
        # at once): an attempt that used its whole wait was listening all
        # along, and a pause after it would spend budget deaf
        if time.monotonic() - t0 < wait_s / 2.0:
            fast_failures += 1
            pause = min(_KV_BACKOFF_CAP_S,
                        _KV_BACKOFF_BASE_S * (2.0 ** (fast_failures - 1)))
            time.sleep(min(pause, remaining))
        else:
            # a full-length attempt shows the store is reachable: the next
            # transient error pauses at the base again, not at the cap
            fast_failures = 0
    raise RuntimeError(
        f"KV-store key {key!r}"
        + (f" ({what})" if what else "")
        + f" never appeared within {timeout_s:g}s ({attempts} attempt(s)): "
        f"the process that should publish it likely died, or never "
        f"reached this exchange — check its log; under --elastic the "
        f"supervisor restarts (or shrinks) the gang automatically"
    ) from last_err


def kv_allgather_bytes(tag: str, payload: bytes,
                       timeout_s: float = KV_TIMEOUT_S,
                       attempt_s: float = KV_ATTEMPT_S) -> list:
    """All-gather one bytes payload per rank through the store, keyed by
    ``tag`` (the JAX package's ``host_allgather_bytes(tag, ...)``).

    Returns the payloads in rank order (every rank sees the same list).
    ``tag`` must be unique per logical exchange and the same on every
    rank.  Every get is a :func:`blocking_kv_get`, so a peer that died
    before posting fails this rank within ``timeout_s``, naming the peer.
    Single-process: ``[payload]``."""
    client = kv_client()
    if client is None:
        return [bytes(payload)]
    with _tracing.span("kv_allgather", tag=tag, bytes=len(payload)):
        _post_chunks(client, tag, payload)
        return _collect_allgather(client, tag, payload, timeout_s,
                                  attempt_s)


def _post_chunks(client, tag, payload) -> None:
    """Post this rank's payload under ``tag``, in chunks: plain sets, so
    the peers can collect it the moment this returns."""
    me = torch.distributed.get_rank()
    nchunk = (len(payload) + _KV_CHUNK - 1) // _KV_CHUNK
    for i in range(nchunk):
        client.set(f"cocoa/{tag}/{me}/{i}",
                   payload[i * _KV_CHUNK:(i + 1) * _KV_CHUNK])
    client.set(f"cocoa/{tag}/{me}/n", str(nchunk))


def _collect_allgather(client, tag, payload, timeout_s, attempt_s,
                       rank=None, world=None) -> list:
    """The blocking half of an all-gather: every peer's chunks (this
    rank's payload slots in from the argument).  On the caller's thread
    for :func:`kv_allgather_bytes`, on a collector thread for
    :func:`async_host_allgather_bytes` (which passes the rank and world
    it read on the caller's thread)."""
    me = torch.distributed.get_rank() if rank is None else rank
    world = torch.distributed.get_world_size() if world is None else world
    out = []
    for p in range(world):
        if p == me:
            out.append(bytes(payload))
            continue
        n = int(blocking_kv_get(
            client, f"cocoa/{tag}/{p}/n", timeout_s=timeout_s,
            attempt_s=attempt_s,
            what=f"peer process {p}, exchange {tag!r}"))
        out.append(b"".join(
            blocking_kv_get(
                client, f"cocoa/{tag}/{p}/{i}", timeout_s=timeout_s,
                attempt_s=attempt_s,
                what=f"peer process {p}, exchange {tag!r} chunk {i}/{n}")
            for i in range(n)))
    return out


# --- overlapped (asynchronous) exchanges ------------------------------------
#
# An exchange split in two (cocoa_tpu/parallel/distributed.py:273-297):
# the post, on the caller's thread at once (the peers need not wait for
# this rank to collect), and the collect, on a daemon collector thread
# that runs beside the caller's next local solve, joined by an
# ExchangeHandle where the caller chooses (solvers/cocoa.StaleJoinWindow
# picks the round).  Payloads are host bytes by contract: a tensor's
# bytes are fetched on the caller's thread, after the work that made
# them, never on the collector.  The collector goes only through the
# store, on a connection of its own, and issues no collective.  Its
# threads are daemons and each of its gets is bounded, so an abandoned
# handle neither holds up the process's exit nor waits past the budget.


def _require_host_bytes(payload) -> bytes:
    """An exchange's payload, checked to be host bytes already: a tensor
    (on any device) or an array must be turned into bytes on the CALLER's
    thread, never on the collector, where a device read would race the
    work that produced it."""
    if isinstance(payload, (bytes, bytearray)):
        return bytes(payload)
    raise TypeError(
        f"exchange payloads must be host bytes, got "
        f"{type(payload).__name__}: device values must not escape into "
        f"the exchange thread — convert with "
        f"x.cpu().numpy().tobytes() on the caller's thread first")


class ExchangeHandle:
    """One in-flight asynchronous exchange.

    ``join()`` blocks until the collector finishes (re-raising its
    error), returns its result, and emits one ``comm_overlap`` event:

    - ``hidden_s``: the exchange's time that ran beside the caller's own
      work (launch to the earlier of the collector's end and the join);
    - ``wait_s``: what the join itself still waited.

    ``done()`` polls without blocking.  A second ``join()`` returns the
    first one's result (or error) and emits nothing."""

    def __init__(self, tag: str, collect=None, result=None, attrs=None):
        self.tag = tag
        self._attrs = dict(attrs or {})
        self._result = result
        self._err = None
        self._joined = False
        self._t0 = time.monotonic()
        self._t_done = self._t0 if collect is None else None
        self._thread = None
        if collect is not None:
            self._thread = threading.Thread(
                target=self._run, args=(collect,), daemon=True,
                name=f"cocoa-exchange-{tag}")
            self._thread.start()

    def _run(self, collect):
        try:
            self._result = collect()
        except BaseException as e:  # re-raised at join()
            self._err = e
        finally:
            self._t_done = time.monotonic()

    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    def join(self):
        """The barrier: the collected payloads, or the collector's error."""
        if self._joined:
            if self._err is not None:
                raise self._err
            return self._result
        t_join = time.monotonic()
        with _tracing.span("exchange_join", tag=self.tag, **self._attrs):
            if self._thread is not None:
                self._thread.join()
        self._joined = True
        t_done = self._t_done if self._t_done is not None else t_join
        hidden = max(0.0, min(t_done, t_join) - self._t0)
        wait = max(0.0, t_done - t_join)
        _events.get_bus().emit("comm_overlap", tag=self.tag,
                               hidden_s=hidden, wait_s=wait, **self._attrs)
        if self._err is not None:
            raise self._err
        return self._result


def async_host_allgather_bytes(tag: str, payload: bytes,
                               timeout_s: float = KV_TIMEOUT_S,
                               attempt_s: float = KV_ATTEMPT_S,
                               trace_attrs: Optional[dict] = None
                               ) -> ExchangeHandle:
    """Overlapped :func:`kv_allgather_bytes`: post now, collect on a
    collector thread, join at the caller's barrier.

    This rank's payload is posted on the caller's thread before this
    returns, so the peers can finish their gathers even if this handle is
    never joined.  ``trace_attrs`` (e.g. ``{"round": t}``) tag the
    collector's spans, so trace_report charges the exchange to its round
    though it runs off the round's thread.  Single-process: a handle
    already done, holding ``[payload]``."""
    payload = _require_host_bytes(payload)
    attrs = dict(trace_attrs or {})
    client = kv_client()
    if client is None:
        return ExchangeHandle(tag, result=[payload], attrs=attrs)
    with _tracing.span("kv_post", tag=tag, bytes=len(payload), **attrs):
        _post_chunks(client, tag, payload)
    address = _store_address(timeout_s)
    rank = torch.distributed.get_rank()
    world = torch.distributed.get_world_size()

    def collect():
        with _tracing.span("kv_allgather", tag=tag, bytes=len(payload),
                           overlapped=True, **attrs):
            return _collect_allgather(_connect(address), tag, payload,
                                      timeout_s, attempt_s, rank, world)

    return ExchangeHandle(tag, collect=collect, attrs=attrs)


def async_kv_get(client, key: str, *, timeout_s: float = KV_TIMEOUT_S,
                 attempt_s: float = KV_ATTEMPT_S,
                 what: Optional[str] = None,
                 trace_attrs: Optional[dict] = None) -> ExchangeHandle:
    """Overlapped :func:`blocking_kv_get`: the bounded get runs on a
    collector thread, on ``client``; ``join()`` returns the value or
    raises the bounded error that names the peer."""
    attrs = dict(trace_attrs or {})

    def collect():
        return blocking_kv_get(client, key, timeout_s=timeout_s,
                               attempt_s=attempt_s, what=what)

    return ExchangeHandle(f"get:{key}", collect=collect, attrs=attrs)


def shutdown() -> None:
    """Leave the gang: destroy every process group (a no-op when none
    was set up)."""
    if initialized():
        torch.distributed.destroy_process_group()
