"""Swap-time model quantization for low-precision serving
(``--serveDtype``; counterpart of cocoa_tpu/serving/quantize.py, whose
packed words these are bit for bit).

A margin needs its sign and its ranking, not the duality gap's precision,
so the server may narrow the model it serves:

- **Weights only, once a swap.**  The model is narrowed on the host when
  a generation is published; the queries and the batch stay float32, and
  the scoring path widens each gathered lane exactly
  (ops/rows.py ``gather_dequant``).  With the f32 form the scoring path
  is the plain gather.
- **Packed lanes.**  bf16 is stored two lanes a 32-bit word, int8 four,
  so the per-nonzero gather stays a 4-byte gather while the model's
  footprint halves (quarters).  The JAX package keeps bf16 words as
  uint32 and dispatches on the dtype; on the card both packed forms are
  int32 tensors (the same bits), and the form travels by name.
- **A certificate a swap.**  Each publish measures the f32-against-
  quantized margin error over a calibration batch of recent queries
  (:class:`CalibrationBuffer`, seeded with synthetic ones) and compares it
  with the weakest calibrated margin: where the error could flip that
  sign, the swap publishes the f32 model instead.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

# the serve-dtype vocabulary: resolve_serve_dtype() maps every accepted
# spelling onto these
SERVE_DTYPES = ("f32", "bf16", "int8")

# the device dtype of each form (the packed words' bits as int32)
PACKED_DTYPE = {"f32": torch.float32, "bf16": torch.int32,
                "int8": torch.int32}

LANES = {"f32": 1, "bf16": 2, "int8": 4}

_ALIASES = {"f32": "f32", "float32": "f32",
            "bf16": "bf16", "bfloat16": "bf16",
            "int8": "int8"}


def resolve_serve_dtype(dtype) -> str:
    """Canonical serve dtype (``f32``/``bf16``/``int8``) from any
    accepted spelling (a string, a numpy dtype); anything else is
    rejected with the vocabulary."""
    if dtype is None:
        return "f32"
    if isinstance(dtype, str):
        key = dtype.strip().lower()
    else:
        try:
            key = np.dtype(dtype).name
        except TypeError:
            key = str(dtype)
    got = _ALIASES.get(key)
    if got is None:
        raise ValueError(
            f"unsupported serve dtype {dtype!r}: the serving stack "
            f"quantizes to one of {'/'.join(SERVE_DTYPES)} "
            f"(--serveDtype)")
    return got


def packed_len(num_features: int, serve_dtype: str) -> int:
    """Length of the packed array of a width-``num_features`` model (the
    tail word zero-padded: pad lanes widen to 0.0, and a padded query slot
    carries value 0)."""
    lanes = LANES[serve_dtype]
    return -(-int(num_features) // lanes)


class QuantizedModel(NamedTuple):
    """One quantized publishable form of a model vector."""

    serve_dtype: str              # "bf16" | "int8" ("f32" = passthrough)
    packed: np.ndarray            # bf16: uint32 words; int8: int32 words
    scale: Optional[np.float32]   # int8's symmetric per-model scale, else
                                  # None


def bf16_bits(w: np.ndarray) -> np.ndarray:
    """The bfloat16 bits (uint32, low 16 bits) of float32 ``w``, rounded
    to nearest even on the integers, so the result is the same on every
    host: no denormal flush, overflow to infinity, a NaN made the quiet
    NaN of its sign (0x7FC0 / 0xFFC0), as ``ml_dtypes`` rounds."""
    u = np.ascontiguousarray(w, np.float32).view(np.uint32)
    out = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        >> np.uint32(16)
    nan = np.isnan(w)
    if nan.any():
        out[nan] = np.where(u[nan] >> np.uint32(31), np.uint32(0xFFC0),
                            np.uint32(0x7FC0))
    return out


def quantize(w, serve_dtype: str) -> QuantizedModel:
    """Host-side quantize and pack of a model vector.  bf16 rounds to
    nearest even, lane ``i`` in bits ``16*(i&1)`` of word ``i>>1``; int8
    takes the symmetric scale ``max|w|/127`` (1.0 for a zero model), lane
    ``i`` in bits ``8*(i&3)`` of word ``i>>2``: the layouts
    ops/rows.py ``gather_dequant`` unpacks."""
    w = np.asarray(w, np.float32).reshape(-1)
    d = w.shape[0]
    sd = resolve_serve_dtype(serve_dtype)
    if sd == "f32":
        return QuantizedModel("f32", w, None)
    if sd == "bf16":
        lanes = bf16_bits(w)
        pad = packed_len(d, sd) * 2 - d
        if pad:
            lanes = np.concatenate([lanes, np.zeros(pad, np.uint32)])
        return QuantizedModel(
            "bf16", lanes[0::2] | (lanes[1::2] << np.uint32(16)), None)
    scale = np.float32(np.max(np.abs(w)) / 127.0) if np.any(w) \
        else np.float32(1.0)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    lanes = q.view(np.uint8).astype(np.uint32)
    pad = packed_len(d, sd) * 4 - d
    if pad:
        lanes = np.concatenate([lanes, np.zeros(pad, np.uint32)])
    packed = (lanes[0::4] | (lanes[1::4] << np.uint32(8))
              | (lanes[2::4] << np.uint32(16))
              | (lanes[3::4] << np.uint32(24))).view(np.int32)
    return QuantizedModel("int8", packed, scale)


def device_words(qm: QuantizedModel, device) -> torch.Tensor:
    """The packed model on ``device``: float32 for the f32 form, the
    words' bits as int32 for the packed forms.  A blocking copy: the
    tensor is whole when this returns."""
    host = np.ascontiguousarray(qm.packed)
    if qm.serve_dtype != "f32":
        host = host.view(np.int32)
    return torch.from_numpy(host.copy()).to(device)


def dequantize(qm: QuantizedModel, num_features: int) -> np.ndarray:
    """The exact float32 image of the quantized model: what the scoring
    path serves.  Bounds and tests compare against it."""
    d = int(num_features)
    if qm.serve_dtype == "f32":
        return np.asarray(qm.packed, np.float32)[:d]
    if qm.serve_dtype == "bf16":
        words = np.asarray(qm.packed).view(np.uint32)
        lanes = np.empty(words.shape[0] * 2, np.uint32)
        lanes[0::2] = words & np.uint32(0xFFFF)
        lanes[1::2] = words >> np.uint32(16)
        return (lanes << np.uint32(16)).view(np.float32)[:d]
    words = np.asarray(qm.packed).view(np.uint32)
    lanes = np.empty(words.shape[0] * 4, np.uint8)
    for j in range(4):
        lanes[j::4] = ((words >> np.uint32(8 * j))
                       & np.uint32(0xFF)).astype(np.uint8)
    return lanes.view(np.int8).astype(np.float32)[:d] \
        * np.float32(qm.scale)


def margin_error_bound(w32, w_served, queries):
    """The certificate over a calibration batch: ``(bound, weakest,
    flips)``, the largest float64 margin error of the served (dequantized)
    model against the f32 one, the smallest nonzero |f32 margin|, and how
    many calibration margins changed sign.  The swap falls back to f32
    when ``bound >= weakest``."""
    w32 = np.asarray(w32, np.float64)
    wq = np.asarray(w_served, np.float64)
    bound, weakest, flips = 0.0, np.inf, 0
    for qi, qv in queries:
        qi = np.asarray(qi, np.int64)
        qv = np.asarray(qv, np.float64)
        m32 = float(np.dot(w32[qi], qv))
        mq = float(np.dot(wq[qi], qv))
        bound = max(bound, abs(mq - m32))
        if m32 != 0.0:
            weakest = min(weakest, abs(m32))
        if (mq < 0.0) != (m32 < 0.0) and mq != m32:
            flips += 1
    return bound, weakest, flips


class CalibrationBuffer:
    """Ring of recent queries the certificate is computed over, seeded
    with synthetic queries so the first publish, before any traffic,
    carries a bound.  The batcher records every admitted query; the swap
    samples the most recent window."""

    def __init__(self, num_features: int, max_nnz: int = 16,
                 capacity: int = 256, seed: int = 0,
                 warmup_n: int = 64):
        self._lock = threading.Lock()
        self._cap = int(capacity)
        self._ring = []
        self.recorded_total = 0
        rng = np.random.default_rng(seed)
        nnz = max(1, min(int(max_nnz), 8))
        for _ in range(warmup_n):
            qi = rng.integers(0, num_features, size=nnz,
                              dtype=np.int32)
            qv = rng.standard_normal(nnz).astype(np.float32)
            self._ring.append((qi, qv))

    def record(self, idx, val):
        with self._lock:
            self._ring.append((idx, val))
            self.recorded_total += 1
            if len(self._ring) > self._cap:
                del self._ring[:len(self._ring) - self._cap]

    def sample(self, n: int = 64) -> list:
        """The most recent ``n`` queries."""
        with self._lock:
            return list(self._ring[-int(n):])
