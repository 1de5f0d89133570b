"""The shard-granular persistent slab cache, ``--ingestCache=DIR``
(counterpart of cocoa_tpu/data/slab_cache.py).

After a cold parse each built shard's host slabs (the exact
``sharding._build_shard_slabs`` output: labels, mask and sq_norms plus the
dense rows, the padded CSR, the hybrid panel and residual, the eval twin)
are written as memory-mappable ``.npy`` artifacts under the cache root,
beside the pass-1 index (the column histogram and the row offsets and nnz)
and the hybrid layout's residual width.  A warm run ``np.load``\\ s the
slabs with ``mmap_mode="r"`` and copies each to the device once: no parse
and no slab build.

**Keys.** The *file tag* hashes ``(st_dev, st_ino, st_size,
st_mtime_ns, num_features, PARSER_VERSION)``; an atomic-rename rewrite
changes the inode even where the mtime aliases.  The index artifact, the
hybrid meta and the cold-cost sidecar hold facts of the file alone, and
are named exactly as the JAX package names them, so either package reads
the other's.  A shard's tag adds the resolved layout (kind, K, n_shard,
padded width, panel width, eval twin, d, dtype, ``LAYOUT_VERSION``), the
shard id, and the name of this package: the port pads no rows to a TPU
tile, so its slabs are not the JAX package's, and neither package can
read the other's slab artifacts even where the shapes agree.  The shard,
not the gang, is the key, so a gang of another size reads the same
artifacts.

**bfloat16** slabs are stored as their 16-bit patterns (``|V2``), made by
the same single cast from float64 the whole-file build makes.

**Single writer.** An artifact is a directory written under a
writer-unique temporary name (pid and uuid) and renamed into place: one
writer wins, a loser discards its copy.  A failed publish (no space, no
permission) leaves the run uncached with one warning.

**Corruption.** A load checks the shapes, dtypes and fields against the
artifact's own manifest and touches each array's first element; a torn
file fails there, fires ``on_corrupt`` (the ``ingest_cache_corrupt``
event), is evicted, and the caller parses the shard cold.

numpy only: nothing here touches torch or a device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import uuid
from typing import Callable, Optional

import numpy as np

# the JAX package's versions (cocoa_tpu/data/slab_cache.py), so the
# file-level artifacts keep its names: bump PARSER_VERSION when what a
# byte range parses to changes, LAYOUT_VERSION when a slab's fields,
# padding or dtypes do
PARSER_VERSION = 1
LAYOUT_VERSION = 1
# the slab tags' own component: no slab artifact is read across packages
PACKAGE = "cocoa_torch"


def _dtype_name(dtype) -> str:
    """``float32``, ``float64`` or ``bfloat16`` for a torch dtype (or a
    numpy one)."""
    return str(dtype).replace("torch.", "") if not isinstance(
        dtype, np.dtype) else dtype.name


def _digest(parts: dict) -> str:
    blob = json.dumps(parts, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:20]


def _tmp_name(final: str) -> str:
    """A writer-unique temp name.  pid alone is NOT unique across hosts
    sharing one cache directory (the multi-host elastic gang over NFS —
    two workers with the same pid would interleave writes into one temp
    dir and publish a torn artifact); the uuid component makes every
    writer's staging area its own."""
    return f"{final}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"


def _atomic_publish(tmp_dir: str, final_dir: str) -> bool:
    """Atomically rename a fully-written temp artifact into place.
    Returns True when THIS writer won; False when another writer already
    published (the temp is discarded — the artifacts are bit-identical
    by construction, so the loser simply reads the winner's)."""
    try:
        os.rename(tmp_dir, final_dir)
        return True
    except OSError:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        return False


def _write_json_atomic(path: str, obj: dict) -> None:
    tmp = _tmp_name(path)
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


@dataclasses.dataclass
class CachedStats:
    """The cached pass-1 facts of one source file: enough to resolve
    ``--layout=auto`` / ``--hotCols=auto`` / ``--evalDense=auto`` and to
    key every shard artifact WITHOUT parsing a byte.  ``row_off`` /
    ``row_nnz`` are present only on index artifacts stored by a pass-1
    scan (``has_rows``) — the whole-file populate path has no byte
    offsets to record, and a warm full-hit load never needs them."""

    n: int
    file_bytes: int
    total_nnz: int
    max_row_nnz: int
    hist: np.ndarray                 # (d,) int64 global column histogram
    has_rows: bool
    row_off: Optional[np.ndarray] = None   # (n+1,) int64 when has_rows
    row_nnz: Optional[np.ndarray] = None   # (n,) int64 when has_rows


class SlabCache:
    """One ``--ingestCache=DIR`` root, process-safe through the
    atomic-rename protocol.  Its counters add up over every handle and
    view made from it (what the CLI's ``ingest_cache`` event reports)."""

    def __init__(self, root: str,
                 on_corrupt: Optional[Callable] = None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.on_corrupt = on_corrupt
        self.shard_hits = 0
        self.shard_misses = 0
        self.corrupt_total = 0
        self.bytes_mapped = 0
        self.store_failures = 0

    def _store_failed(self, what: str, err: Exception) -> None:
        """Publish failures (ENOSPC, lost permission, a yanked volume)
        degrade to UNCACHED operation — the data is already parsed in
        memory and the run must proceed; a cache is an accelerator, not
        a dependency.  Warn once so a dead cache volume is visible."""
        self.store_failures += 1
        if self.store_failures == 1:
            import warnings

            warnings.warn(
                f"--ingestCache could not publish {what} "
                f"({type(err).__name__}: {err}); continuing uncached — "
                f"check the cache volume", RuntimeWarning)

    def for_file(self, path: str, num_features: int) -> "FileCacheHandle":
        """Bind the cache to one source file's CURRENT identity (stat).
        Raises OSError when the file cannot be stat'd — the cold parse
        would fail on the same file, so callers share one error path."""
        st = os.stat(path)
        return FileCacheHandle(self, path, num_features, st)

    def _corrupt(self, path: str, artifact: str, reason: str) -> None:
        self.corrupt_total += 1
        if self.on_corrupt is not None:
            try:
                self.on_corrupt(path=path, artifact=artifact,
                                reason=reason)
            except Exception:
                pass  # telemetry must never turn a recoverable cache
                # miss into a crash


class FileCacheHandle:
    """The per-source-file face of the cache: the index/stats artifact,
    the hybrid layout meta, the cold-cost sidecar, and the
    :class:`ShardCacheView` factory."""

    def __init__(self, cache: SlabCache, path: str, num_features: int,
                 st: os.stat_result):
        self.cache = cache
        self.path = path
        self.num_features = int(num_features)
        self.file_tag = _digest({
            "kind": "file",
            "dev": int(st.st_dev),
            "ino": int(st.st_ino),
            "size": int(st.st_size),
            "mtime_ns": int(st.st_mtime_ns),
            "num_features": self.num_features,
            "parser": PARSER_VERSION,
        })
        self.file_bytes = int(st.st_size)

    # --- the pass-1 index artifact ---------------------------------------

    def _index_dir(self, full: bool) -> str:
        # two artifact kinds, never overwritten in place: "-full" carries
        # the row offset/nnz arrays a streaming pass-2 needs, "-stats"
        # is the whole-path populate (histogram + scalars only).  The
        # loader prefers full; a later scan upgrades stats->full by
        # publishing the OTHER name (no replace-in-place race).
        return os.path.join(self.cache.root,
                            f"index-{self.file_tag}-"
                            f"{'full' if full else 'stats'}")

    def store_index(self, *, hist, n: int, total_nnz: int,
                    max_row_nnz: int, row_off=None, row_nnz=None) -> None:
        full = row_off is not None
        final = self._index_dir(full)
        if os.path.isdir(final):
            return
        tmp = _tmp_name(final)
        try:
            os.makedirs(tmp, exist_ok=True)
            np.save(os.path.join(tmp, "hist.npy"),
                    np.asarray(hist, np.int64))
            if full:
                np.save(os.path.join(tmp, "row_off.npy"),
                        np.asarray(row_off, np.int64))
                np.save(os.path.join(tmp, "row_nnz.npy"),
                        np.asarray(row_nnz, np.int64))
            _write_json_atomic(os.path.join(tmp, "meta.json"), {
                "n": int(n), "file_bytes": self.file_bytes,
                "total_nnz": int(total_nnz),
                "max_row_nnz": int(max_row_nnz), "has_rows": bool(full),
            })
        except OSError as e:
            shutil.rmtree(tmp, ignore_errors=True)
            self.cache._store_failed(os.path.basename(final), e)
            return
        _atomic_publish(tmp, final)

    def load_index(self) -> Optional[CachedStats]:
        """The cached stats (preferring the full index), or None."""
        for full in (True, False):
            d = self._index_dir(full)
            if not os.path.isdir(d):
                continue
            try:
                with open(os.path.join(d, "meta.json")) as f:
                    meta = json.load(f)
                hist = np.load(os.path.join(d, "hist.npy"),
                               mmap_mode="r")
                if hist.shape != (self.num_features,):
                    raise ValueError(
                        f"hist shape {hist.shape} != "
                        f"({self.num_features},)")
                out = CachedStats(
                    n=int(meta["n"]),
                    file_bytes=int(meta["file_bytes"]),
                    total_nnz=int(meta["total_nnz"]),
                    max_row_nnz=int(meta["max_row_nnz"]),
                    hist=np.asarray(hist), has_rows=bool(full))
                if full:
                    row_off = np.load(os.path.join(d, "row_off.npy"),
                                      mmap_mode="r")
                    row_nnz = np.load(os.path.join(d, "row_nnz.npy"),
                                      mmap_mode="r")
                    if (row_off.shape != (out.n + 1,)
                            or row_nnz.shape != (out.n,)):
                        raise ValueError("row index shape mismatch")
                    out.row_off = np.asarray(row_off)
                    out.row_nnz = np.asarray(row_nnz)
                return out
            except (OSError, ValueError, KeyError) as e:
                self.cache._corrupt(self.path, os.path.basename(d),
                                    f"{type(e).__name__}: {e}")
                shutil.rmtree(d, ignore_errors=True)
        return None

    # --- the hybrid layout meta (the exchanged residual width) -----------

    def _hybrid_meta_path(self, n_hot: int) -> str:
        tag = _digest({"kind": "hybridmeta", "file": self.file_tag,
                       "n_hot": int(n_hot), "layout": LAYOUT_VERSION})
        return os.path.join(self.cache.root, f"hybrid-{tag}.json")

    def store_hybrid_meta(self, n_hot: int, resid_max: int) -> None:
        try:
            _write_json_atomic(self._hybrid_meta_path(n_hot),
                               {"resid_max": int(resid_max),
                                "n_hot": int(n_hot)})
        except OSError as e:
            self.cache._store_failed("hybrid meta", e)

    def load_hybrid_meta(self, n_hot: int) -> Optional[int]:
        path = self._hybrid_meta_path(n_hot)
        try:
            with open(path) as f:
                meta = json.load(f)
            return int(meta["resid_max"])
        except FileNotFoundError:
            return None
        except (OSError, ValueError, KeyError) as e:
            self.cache._corrupt(self.path, os.path.basename(path),
                                f"{type(e).__name__}: {e}")
            try:
                os.unlink(path)
            except OSError:
                pass
            return None

    # --- the cold-cost sidecar (the seconds_saved estimate) --------------

    def _cost_path(self) -> str:
        return os.path.join(self.cache.root, f"cost-{self.file_tag}.json")

    def store_cost(self, seconds: float) -> None:
        try:
            _write_json_atomic(self._cost_path(),
                               {"cold_seconds": float(seconds)})
        except OSError as e:
            self.cache._store_failed("cost sidecar", e)

    def load_cost(self) -> float:
        try:
            with open(self._cost_path()) as f:
                return float(json.load(f)["cold_seconds"])
        except (OSError, ValueError, KeyError):
            return 0.0

    # --- the per-shard slab view -----------------------------------------

    def view(self, *, layout: str, k: int, n_shard: int, width: int,
             n_hot: int, d: int, dtype, eval_dense: bool
             ) -> "ShardCacheView":
        return ShardCacheView(self, layout=layout, k=k, n_shard=n_shard,
                              width=width, n_hot=n_hot, d=d, dtype=dtype,
                              eval_dense=eval_dense)


class ShardCacheView:
    """One fully-resolved layout's shard artifacts: ``load(s)`` /
    ``store(s, slab)`` over the ``_build_shard_slabs`` field dicts."""

    def __init__(self, handle: FileCacheHandle, *, layout: str, k: int,
                 n_shard: int, width: int, n_hot: int, d: int, dtype,
                 eval_dense: bool):
        self.handle = handle
        self.cache = handle.cache
        self.fields = ["labels", "mask", "sq_norms"]
        if layout == "dense":
            self.fields.append("X")
        else:
            if n_hot:
                self.fields.append("X_hot")
            self.fields += ["sp_indices", "sp_values"]
            if eval_dense:
                self.fields.append("X_eval")
        self.layout_tag = _digest({
            "kind": "slab", "file": handle.file_tag, "layout": layout,
            "k": int(k), "n_shard": int(n_shard), "width": int(width),
            "n_hot": int(n_hot), "d": int(d), "dtype": _dtype_name(dtype),
            "eval_dense": bool(eval_dense), "version": LAYOUT_VERSION,
            "package": PACKAGE,
        })

    def _shard_dir(self, s: int) -> str:
        return os.path.join(self.cache.root,
                            f"slab-{self.layout_tag}-s{int(s):05d}")

    def load(self, s: int) -> Optional[dict]:
        """Shard ``s``'s slab dict (memory-mapped, read-only), or None on
        a miss.  Any validation failure — torn file, shape/dtype/field
        drift — counts as CORRUPT: the event fires, the artifact is
        evicted, and None sends the caller to the cold parse."""
        d = self._shard_dir(s)
        if not os.path.isdir(d):
            self.cache.shard_misses += 1
            return None
        try:
            with open(os.path.join(d, "meta.json")) as f:
                meta = json.load(f)
            if sorted(meta.get("fields", {})) != sorted(self.fields):
                raise ValueError(
                    f"field set {sorted(meta.get('fields', {}))} != "
                    f"expected {sorted(self.fields)}")
            out = {}
            nbytes = 0
            for name in self.fields:
                spec = meta["fields"][name]
                arr = np.load(os.path.join(d, f"{name}.npy"), mmap_mode="r")
                if (list(arr.shape) != list(spec["shape"])
                        or arr.dtype.name != spec["dtype"]):
                    raise ValueError(
                        f"{name}: {arr.shape}/{arr.dtype.name} != "
                        f"manifest {spec['shape']}/{spec['dtype']}")
                # touch the first element: a truncated data segment that
                # survived the header check must fail here, not later in
                # the copy to the device
                if arr.size:
                    arr[(0,) * arr.ndim]
                out[name] = arr
                nbytes += arr.nbytes
            self.cache.shard_hits += 1
            self.cache.bytes_mapped += nbytes
            return out
        except (OSError, ValueError, KeyError) as e:
            self.cache.shard_misses += 1
            self.cache._corrupt(self.handle.path, os.path.basename(d),
                                f"{type(e).__name__}: {e}")
            shutil.rmtree(d, ignore_errors=True)
            return None

    def store(self, s: int, slab: dict) -> None:
        """Publish shard ``s``'s slab dict (atomic rename, one writer
        wins).  Field order/set is validated against the view so a
        builder drift cannot poison the cache silently."""
        if sorted(slab) != sorted(self.fields):
            raise ValueError(
                f"slab fields {sorted(slab)} != view fields "
                f"{sorted(self.fields)} — the cache key no longer "
                f"matches the builder output (bump LAYOUT_VERSION)")
        final = self._shard_dir(s)
        if os.path.isdir(final):
            return
        tmp = _tmp_name(final)
        try:
            os.makedirs(tmp, exist_ok=True)
            meta = {"fields": {}, "shard": int(s)}
            for name in self.fields:
                arr = np.ascontiguousarray(slab[name])
                np.save(os.path.join(tmp, f"{name}.npy"), arr)
                meta["fields"][name] = {"shape": list(arr.shape),
                                        "dtype": arr.dtype.name}
            _write_json_atomic(os.path.join(tmp, "meta.json"), meta)
        except OSError as e:
            # a publish failure (ENOSPC, lost permission) must degrade
            # to uncached operation, not kill a run whose data is
            # already parsed — the read-side contract's write twin
            shutil.rmtree(tmp, ignore_errors=True)
            self.cache._store_failed(os.path.basename(final), e)
            return
        _atomic_publish(tmp, final)
