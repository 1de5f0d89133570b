"""The hot-swap watcher: poll for the newest validated checkpoint
generation, swap it in atomically, export freshness as gap age
(counterpart of cocoa_tpu/serving/watcher.py).

A background thread polls ``checkpoint.latest()`` (its validation is
cached on the file's inode, mtime and size, so an unchanged generation
costs a stat a retained file) and, when a new healthy generation
appears, loads it and swaps the model slots: an upload into a fresh
tensor behind one atomic publish (serving/scorer.py ``ModelSlots``).
Shapes are static and a batch keeps the tensor it read, so a swap under
traffic drops nothing, and the margins after it are those of a cold
restart on the new checkpoint, bit for bit.

With ``--serveDtype`` armed, ``slots.swap`` quantizes the generation and
computes its certificate inside the swap, so this watcher needs no dtype
awareness.

Freshness is **gap age**: seconds since the live model's certificate (its
checkpoint, whose meta carries the last certified duality gap) was
produced.  A healthy trainer keeps it bounded by its checkpoint cadence;
a dead one shows as a climbing gauge.  A torn generation falls back
inside ``checkpoint.latest`` (with its ``checkpoint_corrupt`` event) and
is not swapped in.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

from cocoa_torch import checkpoint as ckpt_lib
from cocoa_torch.serving.scorer import ModelInfo, QueryError
from cocoa_torch.telemetry import events as tele_events


def load_model(path: str):
    """(w, ModelInfo) from one validated checkpoint path."""
    meta, arrays = ckpt_lib.load_full(path)
    try:
        birth = os.stat(path).st_mtime
    except OSError:
        birth = time.time()
    # a catalogue's per-tenant certification metadata, as tuples so the
    # published ModelInfo stays immutable
    tg = meta.get("tenant_gaps")
    tc = meta.get("tenant_cert_ts")
    info = ModelInfo(round=meta.get("round"), path=path, birth_ts=birth,
                     gap=meta.get("gap"), seq=0,
                     tenant_gaps=None if tg is None else tuple(tg),
                     tenant_cert_ts=None if tc is None else tuple(tc))
    return arrays["w"], info


def wait_for_model(directory: str, algorithm: str,
                   timeout_s: float = 300.0, poll_s: float = 0.25,
                   quiet: bool = False) -> Optional[str]:
    """Block until a validated checkpoint exists (the trainer may still
    be warming up when the server starts); None on timeout."""
    deadline = time.monotonic() + timeout_s
    noted = False
    while True:
        path = ckpt_lib.latest(directory, algorithm)
        if path is not None:
            return path
        if time.monotonic() >= deadline:
            return None
        if not noted and not quiet:
            print(f"serve: waiting for the first validated {algorithm} "
                  f"checkpoint in {directory} (the background trainer "
                  f"has not saved yet)", file=sys.stderr, flush=True)
            noted = True
        time.sleep(poll_s)


class SwapWatcher:
    """Poll-and-swap thread.  ``on_swap(info)`` (optional) runs after
    each publish."""

    def __init__(self, slots, directory: str, algorithm: str,
                 poll_s: float = 0.25, on_swap=None):
        self.slots = slots
        self.directory = directory
        self.algorithm = algorithm
        self.poll_s = float(poll_s)
        self.on_swap = on_swap
        self.swaps_total = 0
        self.rejected_total = 0
        self._stop = threading.Event()
        self._seen = slots.info.path
        self._rejected = None   # a generation refused once (a width
        # change) is not retried every poll: it cannot heal in place
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="cocoa-serve-watcher")

    def start(self):
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        self._thread.join(timeout)

    def poll_once(self) -> bool:
        """One poll (also the test hook): swap if a new validated
        generation appeared; returns whether a swap happened."""
        path = ckpt_lib.latest(self.directory, self.algorithm)
        if path is None or path == self._seen or path == self._rejected:
            return False
        try:
            w, info = load_model(path)
        except (OSError, ValueError, KeyError) as e:
            # lost a race with pruning, or a tear validation missed: the
            # next poll resolves again
            print(f"serve: could not load {path} ({e}); keeping the "
                  f"current model", file=sys.stderr, flush=True)
            return False
        self.swaps_total += 1
        info = info._replace(seq=self.swaps_total)
        try:
            self.slots.swap(w, info)
        except QueryError as e:
            self.rejected_total += 1
            self.swaps_total -= 1
            self._rejected = path
            print(f"serve: {e}", file=sys.stderr, flush=True)
            return False
        self._seen = path
        emit_model_swap(self.algorithm, info)
        if self.on_swap is not None:
            self.on_swap(info)
        return True

    def _run(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:   # the watcher must outlive hiccups
                print(f"serve: watcher error ({type(e).__name__}: {e}); "
                      f"retrying", file=sys.stderr, flush=True)
            self._stop.wait(self.poll_s)


def emit_model_swap(algorithm: str, info: ModelInfo):
    """The ``model_swap`` event: which generation went live, its
    certificate, and how old that certificate was at swap time."""
    bus = tele_events.get_bus()
    if bus.active():
        # swap_seq, not "seq": every record already carries the stream's
        # seq, and a field of that name would overwrite it
        bus.emit("model_swap", algorithm=algorithm,
                 round=(int(info.round) if info.round is not None
                        else None),
                 path=info.path, birth_ts=info.birth_ts, gap=info.gap,
                 gap_age_s=max(0.0, time.time() - info.birth_ts),
                 swap_seq=info.seq,
                 tenant_gaps=(None if info.tenant_gaps is None
                              else list(info.tenant_gaps)),
                 tenant_cert_ts=(None if info.tenant_cert_ts is None
                                 else list(info.tenant_cert_ts)))
