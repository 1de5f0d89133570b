"""Index sampling, bit-identical to cocoa_tpu/utils/prng.py.

Three modes (``--rng``):

- ``reference``: java.util.Random replay (the engine behind the Scala
  reference's ``new Random(seed + t)``, CoCoA.scala:45,144), in numpy.
  Every shard replays the same per-round seed against its own size.
- ``jax``: a stateless 32-bit counter hash of (seed, round, shard,
  position), decorrelated across shards.
- ``permuted``: random reshuffling -- each shard walks a keyed Feistel
  bijection of its rows, one permutation per epoch.

The two hash modes are uint32 arithmetic in the JAX package.  PyTorch's
uint32 support is thin, so here they run on int64 tensors masked to 32
bits after every operation; every product is split so that it stays
below 2**48 and never overflows int64.  All three return (C, K, H) int32
tables on the CPU: :func:`host_tables` is what ``--sampling=host`` copies
to the device once per chunk, and the plain version of
:func:`draw_tables`, which makes the same tables on the card
(``csrc/draw_tables.cu``) from a first round held in device memory.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cocoa_torch import kernels

_MULT = 0x5DEECE66D
_ADD = 0xB
_MASK = (1 << 48) - 1


class JavaRandom:
    """Bit-exact java.util.Random: seed' = (seed * 0x5DEECE66D + 0xB) mod 2^48."""

    def __init__(self, seed: int):
        self._seed = (seed ^ _MULT) & _MASK

    def _next(self, bits: int) -> int:
        self._seed = (self._seed * _MULT + _ADD) & _MASK
        val = self._seed >> (48 - bits)
        if bits == 32 and val >= (1 << 31):
            val -= 1 << 32
        return val

    def next_int(self, bound: int | None = None) -> int:
        if bound is None:
            return self._next(32)
        if bound <= 0:
            raise ValueError("bound must be positive")
        if (bound & -bound) == bound:  # power of two
            return (bound * self._next(31)) >> 31
        while True:
            bits = self._next(31)
            val = bits % bound
            if bits - val + (bound - 1) < (1 << 31):
                return val

    def next_double(self) -> float:
        return ((self._next(26) << 27) + self._next(27)) * (2.0 ** -53)


# ---- vectorised LCG in numpy uint64; 48-bit products split 24/24 ----

_U_MULT = np.uint64(_MULT)
_U_ADD = np.uint64(_ADD)
_U_MASK = np.uint64(_MASK)
_LO24 = np.uint64((1 << 24) - 1)
_S24 = np.uint64(24)
_S17 = np.uint64(17)  # 48 - 31: the top 31 bits, next(31)


def _scramble(seeds: np.ndarray) -> np.ndarray:
    return (seeds.astype(np.uint64) ^ _U_MULT) & _U_MASK


def _mulmod48(a, b):
    lo_a, hi_a = a & _LO24, a >> _S24
    lo_b, hi_b = b & _LO24, b >> _S24
    cross = ((lo_a * hi_b + hi_a * lo_b) & _LO24) << _S24
    return (lo_a * lo_b + cross) & _U_MASK


def _advance(states: np.ndarray) -> np.ndarray:
    return (_mulmod48(states, _U_MULT) + _U_ADD) & _U_MASK


def _state_sequence(s0: np.ndarray, m: int) -> np.ndarray:
    """seq[..., i] = advance^i(s0) for i < m, by jump doubling: advance^L
    is affine, x -> A_L x + C_L mod 2^48, with A_2L = A_L^2 and
    C_2L = A_L C_L + C_L."""
    seq = np.empty(s0.shape + (m,), np.uint64)
    seq[..., 0] = s0
    a_l = np.uint64(_MULT)
    c_l = np.uint64(_ADD)
    filled = 1
    while filled < m:
        take = min(filled, m - filled)
        seq[..., filled:filled + take] = (
            _mulmod48(seq[..., :take], a_l) + c_l) & _U_MASK
        c_l = (_mulmod48(a_l, c_l) + c_l) & _U_MASK
        a_l = _mulmod48(a_l, a_l)
        filled += take
    return seq


def _sample_block(t0: np.ndarray, h: int, n_locals: np.ndarray) -> np.ndarray:
    """(K, len(t0), h) nextInt(n_local) tables.  nextInt rejects a draw iff
    its 31 bits reach the largest multiple of the bound below 2^31, so the
    accepted draws are the filtered raw next(31) stream."""
    k, r = n_locals.shape[0], t0.shape[0]
    is_pow2 = (n_locals & -n_locals) == n_locals
    limit = ((1 << 31) // n_locals) * n_locals
    p_max = float(np.max(np.where(is_pow2, 0.0, 1.0 - limit / float(1 << 31))))
    m = h
    if p_max > 0.0:
        exp = h * p_max / (1.0 - p_max)
        m = h + max(64, int(2.0 * exp + 10.0 * np.sqrt(exp)))
    s1 = _advance(np.broadcast_to(_scramble(t0)[None, :], (k, r)).copy())
    while True:
        bits = (_state_sequence(s1, m) >> _S17).astype(np.int64)
        ok = is_pow2[:, None, None] | (bits < limit[:, None, None])
        if not np.any(ok.sum(axis=-1) < h):
            break
        m *= 2
    bounds = n_locals[:, None, None]
    vals = np.where(is_pow2[:, None, None],
                    (bounds * bits[..., :h]) >> np.int64(31),
                    bits[..., :h] % bounds)
    # lanes that rejected a draw among their first h: compact the
    # accepted subsequence (power-of-two lanes never reject)
    for ki, ri in np.argwhere(np.any(~ok[..., :h], axis=-1)):
        pos = np.flatnonzero(ok[ki, ri])[:h]
        vals[ki, ri] = bits[ki, ri, pos] % n_locals[ki]
    return vals.astype(np.int32)


def device_replay_ok(seed: int, max_round: int) -> bool:
    """The JAX package's rule for its in-jit reference replay (int32 round
    seeds): 0 <= seed and seed + max_round < 2^31.  The card's draw kernel
    replays the full java long range, but ``--sampling`` follows this
    rule so that both packages pick the same tables."""
    return 0 <= seed and seed + max_round < (1 << 31)


def _check_sizes(n_locals) -> np.ndarray:
    n_locals = np.asarray(n_locals, dtype=np.int64)
    if np.any(n_locals <= 0):
        raise ValueError(f"all shards must be non-empty, got sizes {n_locals}")
    return n_locals


def sample_indices_per_shard(seed: int, rounds: range, h: int,
                             n_locals) -> np.ndarray:
    """Reference-mode (K, len(rounds), H) int32 table: shard k replays
    ``Random(seed + t)`` against its own size (CoCoA.scala:144,151)."""
    n_locals = _check_sizes(n_locals)
    t0 = np.asarray([seed + t for t in rounds], dtype=np.int64)
    k, r = n_locals.shape[0], len(t0)
    out = np.empty((k, r, h), dtype=np.int32)
    block = max(1, 4_000_000 // max(1, k * h))
    for lo in range(0, r, block):
        out[:, lo:lo + block] = _sample_block(t0[lo:lo + block], h, n_locals)
    return out


# ---- the counter-hash modes, uint32 arithmetic on int64 tensors ----

_M32 = 0xFFFFFFFF
_P1, _P2, _P3 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for x < 2^32: x * c_lo + ((x * c_hi) mod 2^16) << 16,
    each product below 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values."""
    x = x & _M32
    x = _mul32(x ^ (x >> 16), _P2)
    x = _mul32(x ^ (x >> 13), _P3)
    return x ^ (x >> 16)


def hash_tables(seed: int, ts, h: int, n_locals,
                lane0: int = 0) -> torch.Tensor:
    """``rng=jax`` tables: (C, K, H) int32 draws uniform in [0, n_local);
    lane j hashes the global shard id ``lane0 + j``."""
    n_locals = _check_sizes(n_locals)
    k = n_locals.shape[0]
    ts = torch.as_tensor(ts, dtype=torch.int64) & _M32
    s = torch.arange(lane0, lane0 + k, dtype=torch.int64)
    i = torch.arange(h, dtype=torch.int64)
    base = _mix32(_mul32(ts[:, None, None], _P1)
                  ^ ((s[None, :, None] + 0x632BE5AB) & _M32)
                  ^ (seed & _M32))
    v = _mix32(base ^ _mul32(i[None, None, :], _P3)) >> 1
    bounds = torch.as_tensor(n_locals)[None, :, None]
    return (v % bounds).to(torch.int32)


def _feistel_perm(i: torch.Tensor, cnt: int, rk: torch.Tensor) -> torch.Tensor:
    """Keyed bijection on [0, cnt): a 4-round Feistel network on the
    enclosing even-bit power-of-two domain, cycle-walked back into range."""
    if cnt <= 1:
        return torch.zeros_like(i)
    b = max(2, -(-int(np.ceil(np.log2(cnt))) // 2) * 2)
    hb = b // 2
    mask = (1 << hb) - 1

    def enc(x):
        left = x >> hb
        right = x & mask
        for r in range(4):
            f = _mix32(_mul32(right, _P1) ^ rk ^ ((r * _P2) & _M32)) & mask
            left, right = right, left ^ f
        return (left << hb) | right

    y = enc(i)
    while bool((y >= cnt).any()):
        y = torch.where(y >= cnt, enc(y), y)
    return y


def permuted_tables(seed: int, ts, h: int, n_locals,
                    lane0: int = 0) -> torch.Tensor:
    """``rng=permuted`` tables: (C, K, H) int32.  Global step
    g = (t-1)*H + j of shard s reads perm_{(s, g // n_s)}[g mod n_s],
    lane j being the global shard s = ``lane0 + j``; rounds must be
    consecutive."""
    n_locals = _check_sizes(n_locals)
    ts = torch.as_tensor(ts, dtype=torch.int64)
    c = int(ts.shape[0])
    if (int(ts[-1]) + 1) * h >= (1 << 31):
        raise ValueError(
            f"rng=permuted overflows int32 global-step arithmetic at round "
            f"{int(ts[-1])} with H={h}; lower localIterFrac or numRounds")
    g = (ts[0] - 1) * h + torch.arange(c * h, dtype=torch.int64)
    outs = []
    for s in range(n_locals.shape[0]):
        cnt = int(n_locals[s])
        e = g // cnt
        pos = g % cnt
        rk = _mix32(_mul32(e, _P3) ^ (((lane0 + s + 1) * _P1) & _M32)
                    ^ (seed & _M32))
        outs.append(_feistel_perm(pos, cnt, rk).to(torch.int32).reshape(c, h))
    return torch.stack(outs, dim=1)


MODES = ("reference", "jax", "permuted")
_MODE_CODES = {mode: code for code, mode in enumerate(MODES)}


def host_tables(mode: str, seed: int, h: int, n_locals, t0: int,
                c: int, lane0: int = 0) -> torch.Tensor:
    """(C, K, H) int32 tables on the CPU for rounds t0..t0+c-1 (1-based,
    as the reference) in ``mode``.  The K lanes are the global shards
    ``lane0 .. lane0+K-1`` (a gang's rank holds a run of them), so a
    rank's tables are those rows of the whole run's, bit for bit; the
    reference replay reads only each lane's size."""
    if mode not in MODES:
        raise ValueError(f"rng mode must be one of {MODES}, got {mode!r}")
    if mode == "reference":
        tab = sample_indices_per_shard(seed, range(t0, t0 + c), h, n_locals)
        return torch.from_numpy(np.ascontiguousarray(np.swapaxes(tab, 0, 1)))
    ts = torch.arange(t0, t0 + c, dtype=torch.int64)
    if mode == "permuted":
        return permuted_tables(seed, ts, h, n_locals, lane0)
    return hash_tables(seed, ts, h, n_locals, lane0)


def draw_tables(mode: str, seed: int, h: int, counts: torch.Tensor,
                t0: torch.Tensor, c: int, lane0: int = 0) -> torch.Tensor:
    """The chunk's (C, K, H) int32 tables for rounds t0..t0+c-1 on the
    device of ``t0`` (0-d int64, the first round, read where it lies) and
    ``counts`` ((K,) int64 shard sizes): on CUDA one launch of the draw
    kernel on the current stream, which a captured chunk replays; on the
    CPU the plain version, :func:`host_tables`.  Bit for bit with
    :func:`host_tables` in every mode; ``lane0`` the first lane's global
    shard id, as there."""
    if mode not in MODES:
        raise ValueError(f"rng mode must be one of {MODES}, got {mode!r}")
    if c < 1 or h < 1:
        raise ValueError(f"draw_tables needs c >= 1 and h >= 1, got c={c}, "
                         f"h={h}")
    if kernels.runs_plain(t0.device):
        return host_tables(mode, seed, h, counts.numpy(), int(t0), c,
                           lane0)
    kernels.require_cuda(t0, "draw_tables")
    k = counts.shape[0]
    kernels.check_tensor("t0", t0, torch.int64, (), t0.device)
    kernels.check_tensor("counts", counts, torch.int64, (k,), t0.device)
    out = torch.empty(c, k, h, dtype=torch.int32, device=t0.device)
    lib = _library()
    with torch.cuda.device(t0.device):
        rc = lib.draw_tables(_MODE_CODES[mode], counts.data_ptr(),
                             t0.data_ptr(), out.data_ptr(), c, k, h,
                             lane0, seed, kernels.stream_ptr(t0.device))
    kernels.raise_on_error(lib, rc, "draw_tables")
    draw_tables.launches += 1
    return out


kernels.count_launches(draw_tables, "launches")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernels.load("draw_tables")
    lib.draw_tables.restype = ctypes.c_int
    lib.draw_tables.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
    return lib
