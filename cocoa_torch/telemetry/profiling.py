"""Profiler capture, trace summarization, and round-windowed capture (the
port's counterpart of cocoa_tpu/telemetry/profiling.py, on
``torch.profiler`` where the JAX package uses ``jax.profiler``).

A capture records the CPU activities and, where CUDA is present, the
card's (CUPTI: kernels, copies, fills, the kernels a replayed CUDA graph
launches included) and exports one Chrome trace,
``<host>_<pid>.<ns>.pt.trace.json``, into its directory.
:func:`parse_trace` reads such traces back; :func:`device_table` keeps
the kernel events (``cat == "kernel"``), each counted once — not the
annotations or flow events on the same device track.

The round window: :class:`RoundWindowProfiler` subscribes to the event
bus and starts and stops the profiler when the ``round_eval`` stream
crosses the requested rounds (``--profile=DIR,START,STOP``).  The events
arrive between a run's CUDA-graph replays, after each eval's fetch, so
the profiler starts and stops only there.  On the chunked loop that is
every eval; on ``--deviceLoop`` the rows of a super-block are decoded at
its one fetch, so the window opens and closes at super-block boundaries
(the JAX package's fetch-fallback bridge behaves the same way).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import socket
import time
from collections import defaultdict


def profiler():
    """A ``torch.profiler.profile`` with the CPU activities and, where
    CUDA is present, the card's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def export(prof, outdir: str) -> str:
    """Write a stopped profile's Chrome trace into ``outdir``; returns
    its path."""
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"{socket.gethostname()}_{os.getpid()}."
                                f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def capture(tag, run_fn, out_root):
    """Run ``run_fn`` under the profiler; return the capture directory."""
    import shutil

    tdir = os.path.join(out_root, tag)
    # start clean: parse_trace globs the directory, and a stale capture
    # would silently mix into the aggregation; a failed rmtree is loud
    if os.path.exists(tdir):
        shutil.rmtree(tdir)
    os.makedirs(tdir, exist_ok=True)
    prof = profiler()
    prof.start()
    try:
        run_fn()
    finally:
        prof.stop()
        export(prof, tdir)
    return tdir


def trace_events(tdir) -> list:
    """Every event of the Chrome traces under ``tdir`` (``*.trace.json``,
    gzipped or not, at any depth)."""
    events = []
    paths = (glob.glob(os.path.join(tdir, "**", "*.trace.json"),
                       recursive=True)
             + glob.glob(os.path.join(tdir, "**", "*.trace.json.gz"),
                         recursive=True))
    for path in sorted(paths):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            data = json.load(f)
        if isinstance(data, dict):
            events.extend(data.get("traceEvents", []))
        elif isinstance(data, list):
            events.extend(data)
    return events


def parse_trace(tdir):
    """Aggregate the complete events of the traces under ``tdir``:
    {track: {op_name: total_us}}, a track named ``<cat>:<process
    name>/<thread name>`` (``kernel:...`` for the card's kernels)."""
    events = trace_events(tdir)
    out = defaultdict(lambda: defaultdict(float))
    pids, tids = {}, {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pids[e.get("pid")] = str(e.get("args", {}).get("name", ""))
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tids[(e.get("pid"), e.get("tid"))] = str(
                e.get("args", {}).get("name", ""))
    for e in events:
        if e.get("ph") != "X":
            continue
        pname = pids.get(e.get("pid"), str(e.get("pid", "")))
        tname = tids.get((e.get("pid"), e.get("tid")), str(e.get("tid", "")))
        track = f"{e.get('cat', '')}:" + f"{pname}/{tname}".strip("/")
        out[track][e.get("name", "?")] += float(e.get("dur", 0.0))
    return {k: dict(v) for k, v in out.items()}


def device_table(tracks, top=18):
    """The device-side op table: the card's kernels (the tracks of
    ``cat == "kernel"``), each kernel event counted once.  The card's
    other events on the same device — the annotations that span several
    kernels, the copies and fills — are left out; an annotation's
    duration includes its kernels' and would count them twice.  Returns
    (the ``top`` rows (track, kernel, us) by time, the total us over
    every kernel)."""
    rows = []
    for track, ops in tracks.items():
        if track.split(":", 1)[0] != "kernel":
            continue
        for name, us in ops.items():
            rows.append((track, name, us))
    rows.sort(key=lambda r: -r[2])
    return rows[:top], sum(r[2] for r in rows)


def kernel_launches(tdir) -> dict:
    """{kernel name: launches} over the kernel events under ``tdir``."""
    counts = defaultdict(int)
    for e in trace_events(tdir):
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            counts[e.get("name", "?")] += 1
    return dict(counts)


def parse_profile_flag(value: str):
    """``--profile=DIR`` or ``--profile=DIR,START,STOP`` →
    (dir, start_round|None, stop_round|None)."""
    parts = str(value).split(",")
    if len(parts) == 1:
        return parts[0], None, None
    if len(parts) != 3:
        raise ValueError(
            f"--profile takes DIR or DIR,START,STOP (round window), got "
            f"{value!r}")
    try:
        start, stop = int(parts[1]), int(parts[2])
    except ValueError:
        raise ValueError(
            f"--profile window bounds must be round numbers, got {value!r}")
    if start < 1 or stop <= start:
        raise ValueError(
            f"--profile window needs 1 <= START < STOP, got {value!r}")
    return parts[0], start, stop


class RoundWindowProfiler:
    """Bus subscriber that profiles the rounds in ``[start, stop)``.

    The profiler starts at the first ``round_eval`` with t >= start and
    stops at the first with t >= stop (round numbers are only observable
    at the ``debugIter`` eval cadence, so the window snaps to it; on the
    device loop to its super-block fetches).  One window per process:
    the first algorithm whose trajectory crosses it wins.  ``path`` is
    the exported trace once the window closed.
    """

    def __init__(self, outdir: str, start_round: int, stop_round: int):
        self.outdir = outdir
        self.start_round = start_round
        self.stop_round = stop_round
        self.active = False
        self.done = False
        self.path = None
        self._prof = None

    def __call__(self, rec: dict):
        ev = rec.get("event")
        if ev == "round_eval" and not self.done:
            t = rec.get("t")
            if not isinstance(t, int):
                return
            if not self.active and t >= self.start_round:
                os.makedirs(self.outdir, exist_ok=True)
                self._prof = profiler()
                self._prof.start()
                self.active = True
            if self.active and t >= self.stop_round:
                self.close()
        elif ev in ("run_end", "divergence"):
            # a run ending inside the window must still flush the capture
            self.close()

    def close(self):
        if self.active:
            self._prof.stop()
            self.active = False
            self.done = True
            self.path = export(self._prof, self.outdir)
            self._prof = None
