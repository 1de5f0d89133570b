"""Dynamic sanitizers: the capture-once and no-silent-read invariants (the
port's counterpart of cocoa_tpu/analysis/sanitize.py, with its names).

The static rules (rules.py) catch the host reads and captures one can
see in the source; this module catches the ones one cannot — a chunk
length that quietly captures a new graph every super-block, a scalar read
that waits for the card inside the round loop — with two runtime probes
around the drive loops:

- **capture watch** — the port's compiles are CUDA graph captures and
  nvcc builds.  Each one calls :func:`record_compile` with a name
  (``chunk/<branch>/<c>`` for a chunked loop's capture, solvers/base.py
  ``ChunkRunner``; ``device_loop/<branch>`` for the device loop's;
  ``fleet`` for the fleet's; ``nvcc/<lib>`` for a kernel library built
  by ``kernels.build``) and its seconds.  :func:`watch_compiles` collects
  them, and :func:`install_compile_events` bridges them onto the
  telemetry bus as typed ``compile`` events, which ``--metrics`` counts in
  ``cocoa_compiles_total``.  The invariant: one capture per (branch,
  chunk length) a run uses, one per branch in the device loop, and none
  while graphs replay.
- **transfer guard** — :func:`sanitizer` with ``strict="all"`` arms the
  drive loops' regions (marked with :func:`device_loop_guard`: a chunk's
  dispatch through its eval's fetch, a super-block, the fleet's loop), in
  which every read of the device raises at its line unless it sits in
  :func:`intended_fetch`, which reopens the region, counts the read and
  emits a ``host_transfer`` event when the bus is active.  On CUDA the
  region sets ``torch.cuda.set_sync_debug_mode("error")`` (every
  synchronizing call raises, uploads from pageable memory included); on
  every device it pushes a ``TorchFunctionMode`` that refuses
  ``Tensor.item``, ``tolist``, ``numpy``, ``cpu``, ``__bool__``,
  ``__float__``, ``__int__``, ``__index__``, ``__array__``,
  ``__format__``, ``torch.equal``/``allclose`` and ``.to("cpu")``.  On
  the CPU every tensor stands in for a device tensor, so the CPU runs of
  the same drive loops are a real gate; on the card host tensors (pinned
  words, host tables) are the host's own.  The invariant: zero
  unintended reads inside the round loop.

Both probes only observe: neither changes what a run computes.  Unarmed,
a region costs one thread-local check, and :func:`intended_fetch` one
counter increment a fetch (one an eval or a super-block, never one a
round).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch
from torch.overrides import TorchFunctionMode

# process-lifetime counts of sanctioned fetches and refused reads (the
# production mirror of what a sanitizer context observes per run)
_counters_lock = threading.Lock()
intended_fetches_total = 0
refused_total = 0

# the reads the guard refuses, by torch function name
_READS = frozenset({
    "item", "tolist", "numpy", "cpu", "__bool__", "__float__", "__int__",
    "__index__", "__array__", "__format__", "is_nonzero", "equal",
    "allclose"})


class TransferRefused(RuntimeError):
    """A read of the device inside a guarded region, outside
    :func:`intended_fetch`."""


@dataclasses.dataclass
class CompileRecord:
    name: str
    seconds: float


_watches: list = []   # the lists of the open watch_compiles contexts
_BUS_BRIDGE = None


def record_compile(name: str, seconds: float) -> None:
    """The emit hook of every capture and nvcc build: ``name`` and its
    ``seconds`` go to every open :func:`watch_compiles` list and, once
    :func:`install_compile_events` ran, to the bus as a ``compile``
    event."""
    rec = CompileRecord(name=name, seconds=float(seconds))
    with _counters_lock:
        sinks = list(_watches)
    for sink in sinks:
        sink.append(rec)
    bus = _BUS_BRIDGE
    if bus is not None and bus.active():
        bus.emit("compile", name=rec.name, seconds=rec.seconds)


@contextlib.contextmanager
def watch_compiles():
    """Yield a list that accumulates one :class:`CompileRecord` per
    capture or build finishing while the context is open."""
    records: list = []
    with _counters_lock:
        _watches.append(records)
    try:
        yield records
    finally:
        with _counters_lock:
            # by identity: two open watches may hold equal lists
            _watches[:] = [w for w in _watches if w is not records]


def install_compile_events(bus) -> None:
    """Bridge compile records onto the telemetry bus as ``compile``
    events (idempotent; installed by ``EventBus.configure``, so any run
    with ``--metrics``/``--events`` counts ``compiles_total``).  ``emit``
    on an inactive bus is a no-op, so the bridge costs nothing once the
    sinks detach."""
    global _BUS_BRIDGE
    if _BUS_BRIDGE is None:
        _BUS_BRIDGE = bus


# --- the transfer guard -----------------------------------------------------

_tls = threading.local()


def _open_depth() -> int:
    return getattr(_tls, "open", 0)


def _counts(t, all_tensors: bool) -> bool:
    return isinstance(t, torch.Tensor) and (all_tensors
                                            or t.device.type != "cpu")


def _to_host(args, kwargs) -> bool:
    """Whether a ``Tensor.to`` call names the CPU as its device."""
    for a in list(args[1:]) + [kwargs.get("device")]:
        if isinstance(a, str) and a.split(":")[0] == "cpu":
            return True
        if isinstance(a, torch.device) and a.type == "cpu":
            return True
        if isinstance(a, torch.Tensor) and a.device.type == "cpu":
            return True
    return False


class _ReadGuard(TorchFunctionMode):
    """Refuses the reads of :data:`_READS` (and ``.to`` the CPU) of a
    tensor that counts as the device's: every tensor when
    ``all_tensors`` (a CPU run), else those not on the CPU."""

    def __init__(self, all_tensors: bool):
        super().__init__()
        self.all_tensors = all_tensors

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _open_depth() and args:
            name = getattr(func, "__name__", "")
            src = args[0]
            refused = (name in _READS and any(
                _counts(a, self.all_tensors) for a in args[:2])) or (
                name == "to" and isinstance(src, torch.Tensor)
                and src.device.type != "cpu" and _to_host(args, kwargs))
            if refused:
                global refused_total
                with _counters_lock:
                    refused_total += 1
                raise TransferRefused(
                    f"`{name}` reads the device inside a guarded region "
                    f"(analysis/sanitize.py); mark a deliberate read with "
                    f"intended_fetch(label)")
        return func(*args, **kwargs)


@contextlib.contextmanager
def _reopened():
    """Lift the guard for the block: the read guard on this thread and,
    where a region armed it, CUDA's sync debug mode."""
    depth = _open_depth()
    _tls.open = depth + 1
    armed = depth == 0 and getattr(_tls, "sync_armed", 0)
    if armed:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if armed:
            torch.cuda.set_sync_debug_mode("error")
        _tls.open -= 1


@contextlib.contextmanager
def intended_fetch(label: str):
    """Mark a deliberate read of the device (a super-block's fetch, an
    eval's).  Inside a guarded region this is the only way data may leave
    the device; each use is counted and, when telemetry is active,
    emitted as a ``host_transfer`` event (``host_transfers_total``)."""
    from cocoa_torch.telemetry import events as _tele

    global intended_fetches_total
    with _reopened():
        yield
    with _counters_lock:
        intended_fetches_total += 1
    bus = _tele.get_bus()
    if bus.active():
        bus.emit("host_transfer", label=label)


@contextlib.contextmanager
def allow_transfers():
    """A plain, uncounted reopening — for the machinery of sanctioned
    paths that is neither a fetch nor a leak: staging the host's draw
    tables onto the card, and design B's poll of the pinned live word
    (on the CPU, of the live flag itself)."""
    with _reopened():
        yield


@contextlib.contextmanager
def no_transfers(device=None):
    """Refuse every read of the device except through
    :func:`intended_fetch`.  ``device`` is the run's: on CUDA the region
    also sets CUDA's sync debug mode to "error" (a missing
    ``set_sync_debug_mode`` raises: the guard never degrades quietly),
    and host tensors stay readable; on the CPU, or with ``device`` None,
    every tensor counts as the device's."""
    dev = None if device is None else torch.device(device)
    cuda = dev is not None and dev.type == "cuda"
    if cuda and not hasattr(torch.cuda, "set_sync_debug_mode"):
        raise RuntimeError("this torch has no torch.cuda.set_sync_debug_mode:"
                           " the transfer guard cannot watch the card")
    prev = None
    with _ReadGuard(all_tensors=dev is None or dev.type == "cpu"):
        if cuda:
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            _tls.sync_armed = getattr(_tls, "sync_armed", 0) + 1
        try:
            yield
        finally:
            if cuda:
                _tls.sync_armed -= 1
                torch.cuda.set_sync_debug_mode(prev)


def device_loop_guard(device=None):
    """The guard a drive loop wraps its dispatch-to-fetch region in (a
    chunk through its eval's fetch, a super-block, the fleet's loop).
    Inert (a nullcontext) unless a :func:`sanitizer` with
    ``strict="all"`` is active on this thread: setup legitimately moves
    data, so the contract starts where the loop does."""
    if getattr(_tls, "arm_device_loop", False):
        return no_transfers(device)
    return contextlib.nullcontext()


@contextlib.contextmanager
def _arm_device_loop():
    prev = getattr(_tls, "arm_device_loop", False)
    _tls.arm_device_loop = True
    try:
        yield
    finally:
        _tls.arm_device_loop = prev


@dataclasses.dataclass
class SanitizerStats:
    compiles: list                  # CompileRecord per capture or build
    fetches_before: int = 0
    refused_before: int = 0

    @property
    def intended_fetches(self) -> int:
        return intended_fetches_total - self.fetches_before

    @property
    def unintended(self) -> int:
        """Reads the guard refused while the context was open (each one
        raised at its line; nonzero only where a caller swallowed it)."""
        return refused_total - self.refused_before


@contextlib.contextmanager
def sanitizer(strict="all"):
    """The combined harness the sanitized runs use: capture watch plus a
    transfer guard.  ``strict="all"`` arms the drive loops' regions
    (:func:`device_loop_guard`); ``"d2h"`` guards the whole context with
    every tensor counted (:func:`no_transfers`); ``False`` = capture
    watch only.  Yields :class:`SanitizerStats`; an unintended read
    raises from the guarded code itself, so "zero unintended reads" is
    "the run completed" (and ``stats.unintended == 0``)."""
    with contextlib.ExitStack() as stack:
        records = stack.enter_context(watch_compiles())
        stats = SanitizerStats(compiles=records,
                               fetches_before=intended_fetches_total,
                               refused_before=refused_total)
        if strict in (True, "all"):
            stack.enter_context(_arm_device_loop())
        elif strict == "d2h":
            stack.enter_context(no_transfers())
        yield stats
