"""Streaming sharded ingest: each rank parses only its own shards
(counterpart of cocoa_tpu/data/ingest.py).

The whole-file path (``load_libsvm`` then ``shard_dataset(...,
part=...)``) parses the whole LIBSVM text in every rank of a gang and
keeps 1/P of it.  This module is the two-pass byte-range pipeline that
reads only what a rank needs:

- **pass 1, the index scan.**  Rank r of P scans bytes [r*size/P,
  (r+1)*size/P) of the file in windows of :data:`PASS1_WINDOW` bytes
  (range-parse, keep the counts, drop the rows): each row's byte offset
  and nnz, and a column histogram.  The parts are all-gathered over the
  gang's gloo host group (parallel/distributed.py
  ``host_allgather_bytes``) and concatenated or summed: integers, so the
  histogram equals the whole file's ``np.bincount`` and ``--hotCols=auto``
  resolves to the same width.
- **pass 2, the shard parse.**  The row offsets map each shard's rows to
  an exact byte range; a rank parses only the ranges of its own m = K/P
  shards (``sharding.part_range``), on a thread pool when the native
  parser is built (its ctypes calls release the interpreter lock; the
  Python parser keeps a sequential loop), and builds each shard's slabs
  through the same ``sharding._build_shard_slabs`` the whole-file build
  uses, so the shards are equal bit for bit.  No rank ever holds the
  whole file's CSR.

**The slab cache** (``--ingestCache=DIR``, data/slab_cache.py): pass 1
loads a cached index (no scan), pass 2 loads each cached shard (no parse,
no build) and parses only the misses, publishing what it builds.  Cache
state can differ between ranks, and a rank that skips a collective its
peers entered would hang the gang, so every cache shortcut is first voted
across the gang (:func:`_all_agree`) and taken only when every rank can.

The hybrid residual's width (the largest row's cold nonzeros) needs the
hot set, which needs the whole histogram: it is measured on the pass-2
pieces, max-reduced across the gang (an exact integer, the whole file's
``bincount(cold_rows).max()``) and cached as the hybrid layout meta.
"""

from __future__ import annotations

import dataclasses
import io
import os
import time
from typing import Optional

import numpy as np
import torch

from cocoa_torch.data import hybrid as hybrid_lib
from cocoa_torch.data import sharding as sharding_lib
from cocoa_torch.data.libsvm import load_libsvm_range
from cocoa_torch.device import resolve_device
from cocoa_torch.parallel import distributed
from cocoa_torch.telemetry import tracing

# pass 1's window: bounds the rows a scan holds at once (they are parsed
# and dropped a window at a time; only offsets, nnz and counts stay)
PASS1_WINDOW = 64 << 20


def peak_rss_bytes() -> int:
    """This process's lifetime peak resident set (ru_maxrss is kB on
    Linux); 0 where ``resource`` is absent."""
    try:
        import resource
    except ImportError:
        return 0
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _gang() -> tuple:
    """(rank, world size) of the gang this process joined; (0, 1) alone."""
    if not distributed.initialized():
        return 0, 1
    return torch.distributed.get_rank(), torch.distributed.get_world_size()


@dataclasses.dataclass
class IngestIndex:
    """Pass 1's result: the row index and the column histogram.
    ``row_off`` has n+1 entries, ``row_off[n]`` the file's size, so rows
    [a, b) occupy exactly bytes [row_off[a], row_off[b])."""

    path: str
    file_bytes: int
    num_features: int
    row_off: np.ndarray      # (n+1,) int64
    row_nnz: np.ndarray      # (n,) int64
    hist: np.ndarray         # (d,) int64 column histogram of the file
    scan_bytes: int          # bytes this rank scanned in pass 1
    scan_seconds: float

    @property
    def n(self) -> int:
        return len(self.row_nnz)

    @property
    def total_nnz(self) -> int:
        return int(self.row_nnz.sum())


def _pack_arrays(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _unpack_arrays(payload: bytes) -> dict:
    with np.load(io.BytesIO(payload)) as z:
        return {k: z[k] for k in z.files}


def _exchange_max(value: int) -> int:
    """The exact integer max over the gang (``value`` alone)."""
    payloads = distributed.host_allgather_bytes(
        _pack_arrays(v=np.asarray([value], np.int64)))
    return int(max(int(_unpack_arrays(p)["v"][0]) for p in payloads))


def _all_agree(flag: bool) -> bool:
    """True only when every rank of the gang says True (``flag`` alone):
    the vote every cache shortcut takes first, so that all ranks take it
    or none does."""
    if _gang()[1] <= 1:
        return flag
    payloads = distributed.host_allgather_bytes(
        _pack_arrays(v=np.asarray([1 if flag else 0], np.int64)))
    return all(int(_unpack_arrays(p)["v"][0]) for p in payloads)


def _cache_handle(cache, path: str, num_features: int):
    """The slab cache bound to the file, or None (a file that vanished
    fails the parse after with its own message)."""
    if cache is None:
        return None
    try:
        return cache.for_file(path, num_features)
    except OSError:
        return None


def build_index(path: str, num_features: int, *,
                window: int = PASS1_WINDOW, cache=None) -> IngestIndex:
    """Pass 1: scan this rank's 1/P of the file, exchange, assemble.
    Every rank returns the same index (offsets concatenated in rank
    order, which is the file's row order since the ranges tile it; the
    histogram summed in int64).

    With ``cache`` (a :class:`slab_cache.SlabCache`), a stored full index
    of this exact file returns without reading a byte (``scan_bytes`` 0)
    when every rank holds one, and a scan stores its index."""
    with tracing.span("ingest_pass1", path=path):
        handle = _cache_handle(cache, path, num_features)
        if cache is not None:
            stats = handle.load_index() if handle is not None else None
            if _all_agree(stats is not None and stats.has_rows):
                return IngestIndex(
                    path=path, file_bytes=stats.file_bytes,
                    num_features=num_features,
                    row_off=np.asarray(stats.row_off, np.int64),
                    row_nnz=np.asarray(stats.row_nnz, np.int64),
                    hist=np.asarray(stats.hist, np.int64),
                    scan_bytes=0, scan_seconds=0.0)
        index = _build_index(path, num_features, window=window)
        if handle is not None:
            handle.store_index(
                hist=index.hist, n=index.n, total_nnz=index.total_nnz,
                max_row_nnz=int(index.row_nnz.max(initial=0)),
                row_off=index.row_off, row_nnz=index.row_nnz)
        return index


def _build_index(path: str, num_features: int, *,
                 window: int = PASS1_WINDOW) -> IngestIndex:
    size = os.path.getsize(path)
    me, nproc = _gang()
    lo = me * size // nproc
    hi = (me + 1) * size // nproc
    t0 = time.perf_counter()
    offs, nnzs = [], []
    hist = np.zeros(num_features, np.int64)
    w = lo
    while w < hi:
        wh = min(w + window, hi)
        piece, off = load_libsvm_range(path, num_features, w, wh)
        hist += np.bincount(piece.indices, minlength=num_features)
        nnzs.append(np.diff(piece.indptr))
        offs.append(off)
        w = wh
    my_off = np.concatenate(offs).astype(np.int64) if offs \
        else np.empty(0, np.int64)
    my_nnz = np.concatenate(nnzs).astype(np.int64) if nnzs \
        else np.empty(0, np.int64)
    if nproc > 1:
        parts = [_unpack_arrays(p) for p in distributed.host_allgather_bytes(
            _pack_arrays(off=my_off, nnz=my_nnz, hist=hist))]
        row_off = np.concatenate([p["off"] for p in parts])
        row_nnz = np.concatenate([p["nnz"] for p in parts])
        hist = np.sum([p["hist"] for p in parts], axis=0, dtype=np.int64)
    else:
        row_off, row_nnz = my_off, my_nnz
    return IngestIndex(
        path=path, file_bytes=size, num_features=num_features,
        row_off=np.append(row_off, np.int64(size)), row_nnz=row_nnz,
        hist=hist, scan_bytes=hi - lo,
        scan_seconds=time.perf_counter() - t0)


def _pass2_workers(n_tasks: int) -> int:
    """The thread pool's width for the pass-2 shard parses: the native
    parser releases the interpreter lock inside its ctypes calls, so
    shards parse in parallel; the Python parser holds it and keeps the
    sequential loop."""
    if n_tasks <= 1:
        return 1
    from cocoa_torch.data import native_loader

    if not native_loader.available():
        return 1
    return max(1, min(n_tasks, os.cpu_count() or 1))


def _parse_waves(shards, parse_fn):
    """Yield ``(s, parse_fn(s))`` for every shard id in order, parsing in
    waves of at most one pool's width, so at most that many pieces are
    held at once; the results come in shard order, so the parallel parse
    cannot move a byte of the output."""
    shards = list(shards)
    workers = _pass2_workers(len(shards))
    if workers <= 1:
        for s in shards:
            yield s, parse_fn(s)
        return
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as ex:
        for i in range(0, len(shards), workers):
            chunk = shards[i:i + workers]
            yield from zip(chunk, ex.map(parse_fn, chunk))


@dataclasses.dataclass
class StreamBuildInfo:
    """Pass 2's facts for this rank."""

    rows: int                # rows this rank parsed in pass 2
    nnz: int
    bytes_read: int          # pass-2 bytes this rank parsed
    parse_seconds: float     # pass 2's wall time (parse and slab build)
    residual_max_nnz: int    # the residual's widest row (0 unless hybrid)
    shards_cached: int = 0   # this rank's shards served from the cache
    shards_total: int = 0    # this rank's shards
    cache_bytes_mapped: int = 0
    cache_status: str = "off"   # off | hit | partial | miss
    seconds_saved: float = 0.0  # the cached cold cost, on a full hit


def stream_shard_dataset(path: str, num_features: int, k: int, *,
                         layout: str = "auto",
                         dtype: torch.dtype = torch.float32, device=None,
                         part: Optional[tuple] = None,
                         eval_dense: bool = False, hot_cols: int = 0,
                         index: Optional[IngestIndex] = None, cache=None):
    """The streamed twin of ``sharding.shard_dataset(load_libsvm(path,
    num_features), k, ...)``: the same arguments with the file's path in
    place of its parse, returning ``(ShardedDataset, StreamBuildInfo)``.
    ``part=(rank, world)`` builds that rank's shards, parsing only their
    byte ranges; the dataset equals the whole-file build's bit for bit.

    With ``cache`` each shard comes from its artifact where one is valid
    (no parse), and each shard parsed is stored; a build that finds every
    shard parses nothing.  Pass 1 runs first when no ``index`` is given,
    so that the ``ingest_pass2`` span times the shard parse and build
    alone."""
    if index is None:
        index = build_index(path, num_features, cache=cache)
    with tracing.span("ingest_pass2", path=path):
        return _stream_build(path, num_features, k, layout=layout,
                             dtype=dtype, device=device, part=part,
                             eval_dense=eval_dense, hot_cols=hot_cols,
                             index=index, cache=cache)


def _stream_build(path, num_features, k, *, layout, dtype, device, part,
                  eval_dense, hot_cols, index, cache):
    device = resolve_device(device)
    n, d = index.n, num_features
    layout = sharding_lib.resolve_layout_stats(n, d, index.total_nnz,
                                               layout)
    if eval_dense and layout != "sparse":
        raise ValueError("eval_dense only applies to the sparse layout "
                         "(the dense layout's eval is already a matvec)")
    sizes = sharding_lib.split_sizes(n, k)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    n_shard = int(sizes.max()) if k > 0 else 0
    lo_s, hi_s = sharding_lib.part_range(k, part)
    local_shards = list(range(lo_s, hi_s))
    width = max(1, int(index.row_nnz.max(initial=1))) \
        if layout == "sparse" else 0

    rank = hot_ids = None
    n_hot = 0
    if hot_cols:
        if layout != "sparse":
            raise ValueError("hot_cols (the hot/cold column split) only "
                             "applies to the sparse layout")
        n_hot = hybrid_lib.pad_panel(min(int(hot_cols), d))
        # the hot set from the assembled histogram: the whole file's
        hot_ids = hybrid_lib.hottest_columns(index.hist, n_hot)
        rank = hybrid_lib.hot_rank(d, hot_ids)

    handle = _cache_handle(cache, path, num_features)
    mapped_before = cache.bytes_mapped if cache is not None else 0
    t0 = time.perf_counter()
    parsed = {"bytes": 0, "rows": 0, "nnz": 0}

    def parse_shard(s):
        """The piece holding exactly shard ``s``'s rows (a pure function
        of the index, safe on any thread)."""
        r0, r1 = int(offsets[s]), int(offsets[s + 1])
        blo, bhi = int(index.row_off[r0]), int(index.row_off[r1])
        piece, _ = load_libsvm_range(path, d, blo, bhi)
        if piece.n != r1 - r0:
            raise ValueError(
                f"{path}: changed during ingest (index says rows "
                f"[{r0}, {r1}) occupy bytes [{blo}, {bhi}), parsed "
                f"{piece.n} rows); re-run")
        return piece, bhi - blo

    def account(piece, nbytes):
        parsed["bytes"] += nbytes
        parsed["rows"] += piece.n
        parsed["nnz"] += len(piece.values)

    # the residual's width: the cached hybrid meta when every rank holds
    # it, else measured on this rank's pieces (kept for the build) and
    # max-reduced over the gang, then cached
    pieces: dict = {}
    resid_max = 0
    if n_hot:
        cached_resid = (handle.load_hybrid_meta(n_hot)
                        if handle is not None else None)
        if cache is not None and _all_agree(cached_resid is not None):
            resid_max = int(cached_resid)
        else:
            for s, (piece, nbytes) in _parse_waves(local_shards,
                                                   parse_shard):
                account(piece, nbytes)
                pieces[s] = piece
            local_max = max((hybrid_lib.residual_max_nnz(p, rank)
                             for p in pieces.values() if p.n), default=0)
            resid_max = (_exchange_max(local_max) if _gang()[1] > 1
                         else local_max)
            if handle is not None:
                handle.store_hybrid_meta(n_hot, resid_max)
        width = max(1, resid_max)

    view = None if handle is None else handle.view(
        layout=layout, k=k, n_shard=n_shard, width=width, n_hot=n_hot, d=d,
        dtype=dtype, eval_dense=eval_dense)
    cached = []

    def build_from_piece(s, piece):
        """Shard ``s``'s slabs from its own piece, published when a
        cache rides the build."""
        slab = sharding_lib._build_shard_slabs(
            piece, 0, piece.n, n_shard, layout, dtype, d, width,
            np.diff(piece.indptr),
            sharding_lib.segment_sq_norms(piece.values, piece.indptr),
            rank=rank, n_hot=n_hot, eval_dense=eval_dense)
        if view is not None:
            view.store(s, slab)
        return slab

    def iter_slabs():
        """Every local shard's slabs: the cache's hits first, then the
        pieces held from the residual's measurement, then the misses
        parsed in waves, one slab at a time."""
        to_parse = []
        for s in local_shards:
            if s in pieces:
                continue
            slab = view.load(s) if view is not None else None
            if slab is not None:
                cached.append(s)
                yield s, slab
            else:
                to_parse.append(s)
        for s in sorted(pieces):
            yield s, build_from_piece(s, pieces.pop(s))
        for s, (piece, nbytes) in _parse_waves(to_parse, parse_shard):
            account(piece, nbytes)
            yield s, build_from_piece(s, piece)

    ds = sharding_lib.assemble(iter_slabs(), layout=layout, n=n, d=d, k=k,
                               sizes=sizes, dtype=dtype, device=device,
                               part=part, hot_ids=hot_ids, n_hot=n_hot,
                               residual_max_nnz=resid_max)
    parse_seconds = time.perf_counter() - t0
    status, seconds_saved = "off", 0.0
    if cache is not None:
        if len(cached) == len(local_shards):
            status = "hit"
            seconds_saved = handle.load_cost() if handle is not None \
                else 0.0
        else:
            status = "partial" if cached else "miss"
            if handle is not None and not cached:
                # only a full miss records the cold cost: a partial run
                # paid for its missed shards alone
                handle.store_cost(index.scan_seconds + parse_seconds)
    return ds, StreamBuildInfo(
        rows=parsed["rows"], nnz=parsed["nnz"], bytes_read=parsed["bytes"],
        parse_seconds=parse_seconds, residual_max_nnz=resid_max,
        shards_cached=len(cached), shards_total=len(local_shards),
        cache_bytes_mapped=(cache.bytes_mapped - mapped_before
                            if cache is not None else 0),
        cache_status=status, seconds_saved=seconds_saved)


def load_cached_dataset(handle, stats, k: int, *, layout: str,
                        dtype: torch.dtype, device=None,
                        part: Optional[tuple] = None,
                        eval_dense: bool = False, hot_cols: int = 0):
    """A :class:`ShardedDataset` from the cache's artifacts alone, with no
    parse: the warm half of the whole-file path.  ``layout`` is resolved
    (from the cached ``stats``) and ``hot_cols`` is the resolved panel
    width.  Returns ``(ShardedDataset, StreamBuildInfo)``, or None when an
    artifact is missing or corrupt (the caller then parses, which
    publishes them again)."""
    t0 = time.perf_counter()
    device = resolve_device(device)
    n, d = stats.n, handle.num_features
    sizes = sharding_lib.split_sizes(n, k)
    n_shard = int(sizes.max()) if k > 0 else 0
    width = resid_max = 0
    hot_ids = None
    if layout == "sparse":
        if hot_cols:
            resid = handle.load_hybrid_meta(hot_cols)
            if resid is None:
                return None
            resid_max = int(resid)
            width = max(1, resid_max)
            hot_ids = hybrid_lib.hottest_columns(stats.hist, hot_cols)
        else:
            width = max(1, int(stats.max_row_nnz))
    view = handle.view(layout=layout, k=k, n_shard=n_shard, width=width,
                       n_hot=hot_cols, d=d, dtype=dtype,
                       eval_dense=eval_dense)
    try:
        lo_s, hi_s = sharding_lib.part_range(k, part)
    except ValueError:
        return None  # the cold path raises its own message
    before = handle.cache.bytes_mapped
    built = {}
    for s in range(lo_s, hi_s):
        slab = view.load(s)
        if slab is None:
            return None
        built[s] = slab
    bytes_mapped = handle.cache.bytes_mapped - before
    ds = sharding_lib.assemble(
        ((s, built.pop(s)) for s in range(lo_s, hi_s)), layout=layout, n=n,
        d=d, k=k, sizes=sizes, dtype=dtype, device=device, part=part,
        hot_ids=hot_ids, n_hot=hot_cols, residual_max_nnz=resid_max)
    return ds, StreamBuildInfo(
        rows=0, nnz=0, bytes_read=0,
        parse_seconds=time.perf_counter() - t0,
        residual_max_nnz=resid_max, shards_cached=hi_s - lo_s,
        shards_total=hi_s - lo_s, cache_bytes_mapped=bytes_mapped,
        cache_status="hit", seconds_saved=handle.load_cost())


def resolve_ingest_mode(spec, mesh=None, *, objective: str = "svm",
                        cached: bool = False, fp: bool = False) -> str:
    """``--ingest=stream|whole|auto`` -> the mode a run uses, with the JAX
    package's rule and messages: ``auto`` streams SVM runs on a gang of
    more than one rank (``mesh``, parallel/mesh.py), and every SVM run
    once a cache is armed (the streamed build is what consults and fills
    the cache shard by shard); a single uncached process and the lasso's
    column shards keep ``whole``.  ``stream`` with the lasso raises.  A
    feature-parallel gang (``--fp``) keeps ``whole``, and ``stream``
    raises there: the column split has no per-rank byte range to stream
    (cocoa_tpu/data/ingest.py:706-717); ``fp`` says so before the mesh
    exists."""
    from cocoa_torch.parallel.mesh import has_fp

    fp = fp or has_fp(mesh)

    spec_s = ("auto" if spec is None else str(spec)).strip().lower()
    if spec_s not in ("auto", "stream", "whole"):
        raise ValueError(f"--ingest must be stream|whole|auto, "
                         f"got {spec!r}")
    if spec_s == "stream":
        if objective == "lasso":
            raise ValueError(
                "--ingest=stream does not apply to --objective=lasso "
                "(column shards re-bucket every row; use --ingest=whole)")
        if fp:
            raise ValueError(
                "--ingest=stream does not support feature-parallel (fp) "
                "meshes (no per-device byte range to stream); use "
                "--ingest=whole")
        return "stream"
    if spec_s == "whole" or fp:
        return "whole"
    if objective == "svm" and mesh is not None and mesh.size > 1:
        return "stream"
    if cached and objective == "svm":
        return "stream"
    return "whole"


@dataclasses.dataclass
class IngestReport:
    """The typed ``ingest`` telemetry payload (one per loaded file)."""

    mode: str                # "stream" | "whole"
    path: str
    file_bytes: int
    processes: int
    parse_seconds: float     # this process: scan and shard parse
    bytes_read: int          # this process: scanned and parsed bytes
    rows: int                # rows this process parsed
    nnz: int
    n: int                   # the whole dataset's
    total_nnz: int
    peak_rss_bytes: int
    cache: str = "off"       # --ingestCache outcome: off|hit|partial|miss

    def as_fields(self) -> dict:
        return dataclasses.asdict(self)


def whole_report(path: str, data, seconds: float, processes: int = 1,
                 cache: str = "off") -> IngestReport:
    """The report of one whole-file load of ``path`` (``data`` the parsed
    file, ``seconds`` its parse and shard build), as the JAX CLI's
    ``whole_report``: every process reads the whole file."""
    try:
        fsize = os.path.getsize(path)
    except OSError:
        fsize = 0
    nnz = int(data.indptr[-1])
    return IngestReport(mode="whole", path=path, file_bytes=fsize,
                        processes=processes, parse_seconds=seconds,
                        bytes_read=fsize, rows=data.n, nnz=nnz, n=data.n,
                        total_nnz=nnz, peak_rss_bytes=peak_rss_bytes(),
                        cache=cache)


def stream_report(index: IngestIndex, info: StreamBuildInfo,
                  processes: int, cache: str) -> IngestReport:
    """The report of one streamed load: this rank's scan and parse."""
    return IngestReport(
        mode="stream", path=index.path, file_bytes=index.file_bytes,
        processes=processes,
        parse_seconds=index.scan_seconds + info.parse_seconds,
        bytes_read=index.scan_bytes + info.bytes_read, rows=info.rows,
        nnz=info.nnz, n=index.n, total_nnz=index.total_nnz,
        peak_rss_bytes=peak_rss_bytes(), cache=cache)
