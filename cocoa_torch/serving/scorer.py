"""Batched margin scoring with static buckets and atomic hot-swap
(counterpart of cocoa_tpu/serving/scorer.py).

The serving hot path answers batched margin queries ``x.w`` while a
background trainer keeps ``w`` fresh:

- **Static buckets.**  Queries are padded up to a static batch bucket
  (default 64/256/1024, :data:`DEFAULT_BUCKETS`), so every batch the card
  sees has one of a few shapes, and the model ``w`` is a plain tensor
  argument of a fixed shape and dtype: a swap changes bytes, not shapes.
  The JAX package compiles one executable a (bucket, form); eager torch
  compiles nothing, and :meth:`BatchScorer.warmup` runs each (bucket,
  form) once and returns the JAX package's count of them.  Padded slots
  carry index 0 / value 0 and add exactly 0.
- **The evaluator's arithmetic.**  Scoring goes through
  ops/rows.py ``serve_margins``, which runs ``shard_margins``' operations
  on the batch as one shard; a model trained with a hot/cold column split
  (``--hotCols``) splits each query the same way: the panel's columns as
  one matrix product, the cold tail through the gather.

:class:`ModelSlots` holds the live model: ``(w, scale, info, form)`` is
published as ONE tuple behind one attribute, so the batcher's thread
sees the old model or the new one, never a mix.  The upload runs on the
caller's (the watcher's) thread into a fresh tensor and blocks until the
copy is whole; a batch keeps its reference to the tensor it read until
its fetch returns, so a swap never drops or blocks a request.  Both
threads queue on the device's default stream, so a freed model's memory
is reused only after the kernels queued before it.

Low-precision serving (``--serveDtype``) hangs off the publish: with a
bf16/int8 serve dtype :meth:`ModelSlots.swap` quantizes the incoming f32
model once on the host (serving/quantize.py), computes the margin-error
certificate over a calibration batch, and publishes the f32 model
instead where the bound could flip the weakest calibrated margin's sign.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from cocoa_torch.data import hybrid as hybrid_lib
from cocoa_torch.device import resolve_device
from cocoa_torch.ops import rows as rows_mod
from cocoa_torch.serving import quantize as quantize_mod
from cocoa_torch.telemetry import events as tele_events

DEFAULT_BUCKETS = (64, 256, 1024)

# static per-query nonzero budget when the caller gives none (rcv1's
# widest row has 548; typical queries are far shorter); --serveMaxNnz
# overrides it on the CLI
DEFAULT_MAX_NNZ = 512


class QueryError(ValueError):
    """A malformed or out-of-contract query, rejected with the numbers."""


def parse_query(text: str, num_features: int, max_nnz: int):
    """One query line (LIBSVM feature grammar, ``idx:val`` pairs, 1-based
    ids) -> ``(idx, val)``, int32 and float64 arrays, 0-based.  Rejects a
    feature id outside the trained width, more nonzeros than the padding
    budget, and a pair that does not parse, with the numbers."""
    toks = text.split()
    if not toks:
        raise QueryError("empty query (expected 'idx:val idx:val ...', "
                         "1-based feature ids)")
    idx, val = [], []
    for m, tok in enumerate(toks):
        head, sep, tail = tok.partition(":")
        try:
            i = int(head)
            v = float(tail)
        except ValueError:
            sep = ""
        if not sep:
            raise QueryError(f"malformed pair {tok!r} at position {m} "
                             f"(expected 'idx:val')")
        if i < 1 or i > num_features:
            raise QueryError(
                f"feature id {i} outside the trained width: this model "
                f"serves num_features={num_features} (1-based ids "
                f"1..{num_features})")
        idx.append(i - 1)
        val.append(v)
    if len(toks) > max_nnz:
        raise QueryError(
            f"query carries {len(toks)} nonzeros but the compiled "
            f"scoring path pads to max_nnz={max_nnz} — restart the "
            f"server with --serveMaxNnz>={len(toks)} or sparsify the "
            f"query")
    # float64 from the text; the batch assembly casts to float32
    return np.asarray(idx, np.int32), np.asarray(val, np.float64)


def pick_bucket(n: int, buckets: tuple) -> int:
    """The smallest static bucket that holds ``n`` requests (least
    padding).  Callers cap admission at ``buckets[-1]``."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds the largest bucket "
                     f"{buckets[-1]} — the batcher must cap admission")


class ModelInfo(NamedTuple):
    """What the serving loop knows about the model in the live slot."""

    round: Optional[int]       # training round the checkpoint stamped
    path: Optional[str]        # checkpoint file it came from
    birth_ts: float            # checkpoint mtime: when the certificate
                               # was produced (the gap-age anchor)
    gap: Optional[float]       # certified duality gap in the meta
    seq: int                   # swap sequence number (0 = initial load)
    # a (T, d) catalogue's per-tenant certified gaps and certification
    # times (checkpoint meta tenant_gaps / tenant_cert_ts); None otherwise
    tenant_gaps: Optional[tuple] = None
    tenant_cert_ts: Optional[tuple] = None


class ModelSlots:
    """The live model on the device, with atomic hot-swap.

    ``current()`` returns the live ``(w_device, scale, info, form)``
    tuple, swapped by replacing one attribute, so readers never observe
    a torn state and never block on a swap."""

    def __init__(self, w, info: ModelInfo, dtype=None, calibration=None,
                 algorithm: str = "serve",
                 flip_guard: Optional[float] = None, device=None):
        self.serve_dtype = quantize_mod.resolve_serve_dtype(dtype)
        self.device = resolve_device(device)
        self.algorithm = algorithm
        self._calibration = calibration   # CalibrationBuffer or None
        # publish f32 when the bound reaches the weakest calibrated
        # |margin| (default) or this absolute threshold (tests force it)
        self._flip_guard = flip_guard
        w = np.asarray(w, np.float32)
        # a 2-D (T, d) w is a served catalogue of T tenant models;
        # anything else flattens to the single-model vector
        if w.ndim != 2:
            w = w.reshape(-1)
        self.n_tenants = int(w.shape[0]) if w.ndim == 2 else None
        if self.n_tenants is not None and self.serve_dtype != "f32":
            raise QueryError(
                f"a served catalogue ({self.n_tenants} tenants x "
                f"{w.shape[1]} features) only supports "
                f"--serveDtype=f32: per-tenant quantization "
                f"certificates are not in the fleet v1 surface "
                f"(docs/DESIGN.md §21)")
        self._shape = tuple(int(s) for s in w.shape)
        self._d = self._shape[-1]
        self.served_dtype = "f32"       # form of the LIVE slot
        self.last_bound: Optional[float] = None
        self.fallbacks_total = 0
        self._lock = threading.Lock()   # serializes WRITERS only
        self._publish(w, info)

    def _publish(self, w32, info: ModelInfo):
        """Quantize (if armed), certify, upload, publish: the one place a
        model becomes live.  The caller holds the writer lock (or is
        ``__init__``)."""
        served, qm, bound, calib_n, flips, fallback = \
            "f32", None, None, 0, 0, 0
        if self.serve_dtype != "f32":
            qm = quantize_mod.quantize(w32, self.serve_dtype)
            if self._calibration is not None:
                batch = self._calibration.sample()
                calib_n = len(batch)
                if batch:
                    wq = quantize_mod.dequantize(qm, self._d)
                    bound, weakest, flips = \
                        quantize_mod.margin_error_bound(w32, wq, batch)
                    guard = (weakest if self._flip_guard is None
                             else self._flip_guard)
                    fallback = int(bound >= guard)
            if not fallback:
                served = self.serve_dtype
        if served == "f32":
            w_dev, scale = torch.from_numpy(w32.copy()).to(self.device), \
                None
        else:
            w_dev, scale = quantize_mod.device_words(qm, self.device), \
                qm.scale
        self._live = (w_dev, scale, info, served)
        self.served_dtype = served
        self.last_bound = bound
        self.fallbacks_total += fallback
        if self.serve_dtype != "f32":
            self._emit_quantize(info, served, bound, calib_n, flips,
                                fallback, qm)

    def _emit_quantize(self, info, served, bound, calib_n, flips,
                       fallback, qm):
        bus = tele_events.get_bus()
        if not bus.active():
            return
        bus.emit(
            "model_quantize", algorithm=self.algorithm,
            serve_dtype=self.serve_dtype, served=served,
            round=info.round, swap_seq=info.seq, bound=bound,
            calib_n=calib_n, flips=flips, fallback=fallback,
            scale=(None if qm is None or qm.scale is None
                   else float(qm.scale)))

    def current(self):
        """The live ``(w_device, scale, info, form)``: ``scale`` is int8's
        per-model scale (None for the other forms) and ``form`` the served
        form's name, published atomically with the tensor."""
        return self._live

    @property
    def info(self) -> ModelInfo:
        return self._live[2]

    def gap_age_s(self, now: Optional[float] = None) -> float:
        """Seconds since the live model's certificate was produced
        (``cocoa_model_gap_age_seconds``)."""
        return (now if now is not None else time.time()) \
            - self._live[2].birth_ts

    def swap(self, w, info: ModelInfo):
        """Quantize, certify, upload ``w`` and publish it atomically.  A
        shape change is rejected with the numbers: a width (or tenant
        count) change is a different model."""
        with self._lock:
            w = np.asarray(w)
            if tuple(w.shape) != self._shape:
                raise QueryError(
                    f"refusing hot-swap: incoming w has shape "
                    f"{tuple(w.shape)} but the serving executable is "
                    f"compiled for {self._shape} — a shape change is a "
                    f"new model (restart the server)")
            self._publish(np.asarray(w, np.float32), info)
        return info


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class BatchScorer:
    """The scoring path: static buckets, the model a plain tensor
    argument of one of the forms this scorer serves.

    ``hot_ids`` (optional) arms the hybrid path: queries split into a
    dense panel over the trained hot columns plus a cold residual."""

    def __init__(self, num_features: int, dtype=None,
                 buckets: tuple = DEFAULT_BUCKETS,
                 max_nnz: int = DEFAULT_MAX_NNZ,
                 hot_ids=None, model_width=None, n_tenants=None,
                 device=None):
        if not buckets or list(buckets) != sorted(set(int(b)
                                                      for b in buckets)):
            raise ValueError(f"buckets must be strictly increasing "
                             f"positive ints, got {buckets!r}")
        if buckets[0] < 1:
            raise ValueError(f"buckets must be >= 1, got {buckets!r}")
        self.device = resolve_device(device)
        self.num_features = int(num_features)
        # catalogue mode: score against a (T, d) tenant catalogue, each
        # batch carrying a per-row tenant vector
        self.n_tenants = int(n_tenants) if n_tenants is not None else None
        if self.n_tenants is not None and self.n_tenants < 1:
            raise ValueError(f"n_tenants must be >= 1, "
                             f"got {n_tenants!r}")
        # the trained width may exceed the query width by padding (the
        # CLI passes the checkpoint's); the packed forms are sized from it
        self.model_width = (int(model_width) if model_width is not None
                            else self.num_features)
        if self.model_width < self.num_features:
            raise ValueError(
                f"model_width={self.model_width} is narrower than the "
                f"query surface num_features={self.num_features} — a "
                f"query could gather past the model")
        # the SERVE dtype (--serveDtype): which packed form this scorer
        # serves beside f32; the query side is always float32
        self.serve_dtype = quantize_mod.resolve_serve_dtype(dtype)
        self.dtype = torch.float32
        if self.n_tenants is not None and self.serve_dtype != "f32":
            raise ValueError(
                f"a catalogue scorer ({self.n_tenants} tenants) only "
                f"supports serve dtype f32 — per-tenant quantization "
                f"certificates are not in the fleet v1 surface "
                f"(docs/DESIGN.md §21)")
        if self.n_tenants is not None and hot_ids is not None \
                and len(hot_ids):
            raise ValueError(
                "a catalogue scorer does not combine with a hot-column "
                "panel: the hot split is a single-model layout "
                "(per-tenant panels are not in the fleet v1 surface)")
        # the forms this scorer serves, by name: (device dtype, shape),
        # the numbers a mismatch is rejected with
        model_shape = ((self.model_width,) if self.n_tenants is None
                       else (self.n_tenants, self.model_width))
        self._forms = {"f32": (torch.float32, model_shape)}
        if self.serve_dtype != "f32":
            self._forms[self.serve_dtype] = (
                quantize_mod.PACKED_DTYPE[self.serve_dtype],
                (quantize_mod.packed_len(self.model_width,
                                         self.serve_dtype),))
        self.buckets = tuple(int(b) for b in buckets)
        self.max_nnz = int(min(max_nnz, num_features))
        self.hot_rank = None
        self._hot_cols_dev = None
        if hot_ids is not None and len(hot_ids):
            hot_ids = np.asarray(hot_ids, np.int64)
            self.hot_rank = hybrid_lib.hot_rank(self.num_features,
                                                hot_ids)
            self._hot_cols_dev = torch.from_numpy(hot_ids.copy()).to(
                self.device)
        self.n_hot = (0 if self._hot_cols_dev is None
                      else int(self._hot_cols_dev.shape[0]))

    def assemble(self, queries: list, bucket: int):
        """Pad parsed ``(idx, val)`` queries up to ``bucket`` rows of
        static width; returns the host arrays (idx, val, hot).  With a hot
        split, each query's nonzeros partition into the panel lanes and
        the cold residual as the training slabs do."""
        idx = np.zeros((bucket, self.max_nnz), np.int32)
        val = np.zeros((bucket, self.max_nnz), np.float32)
        hot = (np.zeros((bucket, self.n_hot), np.float32)
               if self.n_hot else None)
        for r, (qi, qv) in enumerate(queries):
            if self.hot_rank is None:
                idx[r, :len(qi)] = qi
                val[r, :len(qi)] = qv
            else:
                lanes = self.hot_rank[qi]
                is_hot = lanes >= 0
                # accumulate: a query may repeat a feature id, and the
                # gather path sums the duplicates
                np.add.at(hot[r], lanes[is_hot], qv[is_hot])
                ci, cv = qi[~is_hot], qv[~is_hot]
                idx[r, :len(ci)] = ci
                val[r, :len(cv)] = cv
        return idx, val, hot

    def assemble_tenants(self, tenants: list, bucket: int):
        """A catalogue batch's per-row tenant vector, padded to ``bucket``
        rows (padded rows carry tenant 0 and all-zero values)."""
        out = np.zeros((bucket,), np.int32)
        for r, t in enumerate(tenants):
            out[r] = t
        return out

    def _upload(self, a):
        """A host array (or a tensor) on the scorer's device.  On the card
        the host array is staged in pinned memory and copied without
        blocking the host: the batch's one fetch is its only wait."""
        if a is None or isinstance(a, torch.Tensor):
            return a if a is None else a.to(self.device)
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def score(self, w_dev, idx, val, hot=None, scale=None, tenant=None,
              form: str = "f32"):
        """Score one padded bucket; returns the margins on the device
        (the caller fetches them once).  The model must be one of the
        forms this scorer serves, named by ``form``: its ``--serveDtype``
        form or the f32 fallback."""
        wd = w_dev.dtype
        ws = tuple(int(s) for s in w_dev.shape)
        if self._forms.get(form) != (wd, ws):
            raise QueryError(
                f"model form mismatch: got form {form} w dtype="
                f"{_dtype_name(wd)} shape={ws} but this scorer (serve "
                f"dtype {self.serve_dtype}, num_features="
                f"{self.num_features}) serves only "
                + " or ".join(f"{sd}:{_dtype_name(fd)}{fs}"
                              for sd, (fd, fs) in self._forms.items())
                + " — construct ModelSlots and BatchScorer with the "
                  "same dtype= (the CLI wires --serveDtype into both)")
        if (scale is None) == (form == "int8"):
            raise QueryError(
                f"scale mismatch: an int8-packed model carries its "
                f"per-model scale and every other form carries None — "
                f"got form {form} with scale={scale!r}")
        if (tenant is None) != (self.n_tenants is None):
            if self.n_tenants is not None:
                what = (f"serves a catalogue of {self.n_tenants} "
                        f"tenants and every batch must carry a "
                        f"tenant vector")
            else:
                what = ("serves a single model and takes no tenant "
                        "vector")
            raise QueryError(
                f"tenant mismatch: this scorer {what} — got "
                f"tenant={tenant!r}")
        shard = {"sp_indices": self._upload(idx),
                 "sp_values": self._upload(val)}
        if hot is not None:
            shard["X_hot"] = self._upload(hot)
            shard["hot_cols"] = self._hot_cols_dev
        if tenant is not None:
            shard["tenant"] = self._upload(tenant)
        return rows_mod.serve_margins(w_dev, shard, scale, form)

    def warmup(self, w_dev, scale=None, form: str = "f32"):
        """Run every (bucket, form) pair once before the first request:
        the served form and, under a quantized serve dtype, the other of
        it and the f32 fallback.  Returns the count of pairs, the JAX
        package's count of compiled executables."""
        forms = [(w_dev, scale, form)]
        for sd, (fd, fs) in self._forms.items():
            if sd == form:
                continue
            forms.append((torch.zeros(fs, dtype=fd, device=self.device),
                          np.float32(1.0) if sd == "int8" else None, sd))
        for b in self.buckets:
            idx, val, hot = self.assemble([], b)
            tenant = (None if self.n_tenants is None
                      else self.assemble_tenants([], b))
            for wv, sv, fv in forms:
                self.score(wv, idx, val, hot, sv, tenant, fv).cpu()
        return len(self.buckets) * len(forms)
