"""The port's device-mode index tables against the JAX package's, mirroring
tests/test_device_sampling.py: in every mode and in both ``device``
settings the port's (C, K, H) tables equal JAX's in-jit tables
(``device_sample_per_shard``, ``hash_tables``, ``permuted_tables``) and
its host replay (``sample_indices_per_shard``) bit for bit, over many
seeds, first rounds and shard sizes; chunk invariance, permuted epoch
coverage, ``ints_per_round`` and ``resolve_sampling``'s rules and
messages at the int32 edge.  On the CPU device mode runs the draw
kernel's plain version (``prng.draw_tables`` on a CPU ``t0``); the kernel
itself is held to the host tables on the card by chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cocoa_tpu.solvers.base import IndexSampler as JaxSampler  # noqa: E402
from cocoa_tpu.solvers.base import \
    resolve_sampling as jax_resolve  # noqa: E402
from cocoa_tpu.utils import prng as jax_prng  # noqa: E402
from cocoa_torch.solvers.base import IndexSampler, make_sampler, \
    resolve_sampling  # noqa: E402
from cocoa_torch.utils import prng  # noqa: E402

# power-of-two, tiny, n = 1, big, and just above 2^30, where nextInt
# rejects about half of all raw draws
COUNTS = {
    "mixed": [33, 64, 100, 1],
    "big": [50000, 2531, 20242, 7],
    "reject": [(1 << 30) + 1, (1 << 30) + 3],
}


def _device_tables(sampler, t0, c):
    return sampler.draw(torch.tensor(t0, dtype=torch.int64), c).numpy()


def _jax_in_jit(mode, seed, t0, c, h, counts):
    ts = jnp.arange(t0, t0 + c, dtype=jnp.int32)
    fn = {"reference": jax_prng.device_sample_per_shard,
          "jax": jax_prng.hash_tables,
          "permuted": jax_prng.permuted_tables}[mode]
    return np.asarray(jax.jit(lambda t: fn(seed, t, h, counts))(ts))


@pytest.mark.parametrize("mode", ["reference", "jax", "permuted"])
@pytest.mark.parametrize("seed,t0,c,h,counts", [
    (0, 1, 5, 17, "mixed"),
    (123456, 1000, 3, 64, "big"),
    (3, 1, 3, 40, "reject"),
    ((1 << 31) - 1 - 12, 1, 4, 9, "mixed"),
    (7, 999_990, 4, 33, "big"),
])
def test_tables_equal_jax_in_jit_and_host(mode, seed, t0, c, h, counts):
    """Host and device tables of the port, JAX's in-jit tables and (in
    reference mode) JAX's host replay: one table, bit for bit."""
    counts = np.asarray(COUNTS[counts])
    host = IndexSampler(mode, seed, h, counts, device=False)
    dev = IndexSampler(mode, seed, h, counts, device=True)
    want = _jax_in_jit(mode, seed, t0, c, h, counts)
    got_host = host.chunk_indices(t0, c)
    assert got_host.dtype == torch.int32
    assert got_host.shape == (c, len(counts), h)
    np.testing.assert_array_equal(got_host.numpy(), want)
    np.testing.assert_array_equal(_device_tables(dev, t0, c), want)
    if mode == "reference":
        ref = np.swapaxes(jax_prng.sample_indices_per_shard(
            seed, range(t0, t0 + c), h, counts), 0, 1)
        np.testing.assert_array_equal(want, ref)
    for s, cnt in enumerate(counts):
        assert want[:, s].min() >= 0 and want[:, s].max() < cnt


@pytest.mark.parametrize("mode", ["reference", "jax", "permuted"])
@pytest.mark.parametrize("seed", [5, 2**40 + 3])
def test_sampler_tables_equal_jax_sampler(mode, seed):
    """The two packages' samplers, host and device settings, past the
    int32 seed range too (the port's host replay takes a java long)."""
    counts = np.array([13, 16, 9])
    mine = IndexSampler(mode, seed, 7, counts, device=True)
    want = np.asarray(JaxSampler(mode, seed, 7, counts).chunk_indices(3, 6))
    np.testing.assert_array_equal(_device_tables(mine, 3, 6), want)
    np.testing.assert_array_equal(mine.chunk_indices(3, 6).numpy(), want)


def test_draw_tables_wrapper_rules():
    """The wrapper's plain version on CPU tensors, a refusal of a device
    that is neither CPU nor CUDA and of a bad mode or extent."""
    counts = torch.tensor([5, 8], dtype=torch.int64)
    t0 = torch.tensor(4, dtype=torch.int64)
    got = prng.draw_tables("jax", 2, 3, counts, t0, 2)
    np.testing.assert_array_equal(
        got.numpy(), prng.hash_tables(2, torch.arange(4, 6), 3,
                                      np.array([5, 8])).numpy())
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        prng.draw_tables("jax", 2, 3, counts.to("meta"), t0.to("meta"), 2)
    with pytest.raises(ValueError, match="rng mode"):
        prng.draw_tables("philox", 2, 3, counts, t0, 2)
    with pytest.raises(ValueError, match="c >= 1"):
        prng.draw_tables("jax", 2, 3, counts, t0, 0)


@pytest.mark.parametrize("mode", ["reference", "jax", "permuted"])
def test_chunk_invariance(mode):
    """One chunk of C rounds equals its pieces, in both settings, and a
    different seed gives a different stream."""
    counts = np.array([11, 8])
    s = IndexSampler(mode, 5, 7, counts, device=True)
    whole = _device_tables(s, 1, 12)
    parts = np.concatenate([_device_tables(s, 1, 5), _device_tables(s, 6, 4),
                            s.chunk_indices(10, 3).numpy()])
    np.testing.assert_array_equal(whole, parts)
    other = IndexSampler(mode, 6, 7, counts, device=True)
    assert not np.array_equal(_device_tables(other, 1, 12), whole)


def test_permuted_epoch_coverage_and_continuity():
    """Every coordinate once per epoch, epochs running on across rounds
    and chunks."""
    counts = np.array([10, 35, 5])
    s = IndexSampler("permuted", 3, 5, counts, device=True)
    tab = np.concatenate([_device_tables(s, 1, 15), _device_tables(s, 16, 25)])
    for k, cnt in enumerate(counts):
        stream = tab[:, k, :].reshape(-1)
        for e in range(len(stream) // cnt):
            assert sorted(stream[e * cnt:(e + 1) * cnt].tolist()) == \
                list(range(cnt))


def test_ints_per_round():
    s = IndexSampler("reference", 0, 50, np.array([100, 100]))
    j = JaxSampler("reference", 0, 50, np.array([100, 100]))
    assert s.ints_per_round() == j.ints_per_round() == 100
    s.device = j.device = True
    assert s.ints_per_round() == j.ints_per_round() == 1


@pytest.mark.parametrize("mode,seed,h,rounds", [
    ("reference", 0, 4, 10),
    ("reference", (1 << 31) - 11, 4, 10),      # seed + rounds = 2^31 - 1
    ("reference", (1 << 31) - 10, 4, 10),      # one past the edge
    ("reference", -1, 4, 10),
    ("jax", (1 << 31) - 1, 4, 10),
    ("permuted", 0, 1 << 20, 2046),            # (2046 + 1) * 2^20 < 2^31
    ("permuted", 0, 1 << 20, 2047),            # == 2^31: overflows
])
@pytest.mark.parametrize("sampling", ["auto", "device", "host"])
def test_resolve_sampling_matches_jax(mode, seed, h, rounds, sampling):
    """The same answer, or the same error message, as the JAX package:
    auto takes device tables exactly where they are exact, device raises
    where they are not, permuted past int32 raises in every setting."""
    counts = np.array([7, 9])

    def outcome(fn, sampler):
        try:
            return fn(sampling, sampler, rounds)
        except ValueError as e:
            return str(e)

    mine = outcome(resolve_sampling, IndexSampler(mode, seed, h, counts))
    want = outcome(jax_resolve, JaxSampler(mode, seed, h, counts))
    assert mine == want
    if isinstance(mine, bool):
        s = make_sampler(mode, seed, h, counts, sampling, rounds)
        assert s.device is mine
        assert s.device_capable(rounds) == \
            JaxSampler(mode, seed, h, counts).device_capable(rounds)


def test_resolve_sampling_refuses_a_bad_setting():
    s = IndexSampler("reference", 0, 4, np.array([3]))
    with pytest.raises(ValueError, match="sampling must be auto"):
        resolve_sampling("bogus", s, 10)
    assert prng.device_replay_ok(0, 1000)
    assert not prng.device_replay_ok(-1, 10)
    assert not prng.device_replay_ok((1 << 31) - 5, 10)


_MASK48 = (1 << 48) - 1


def _warp_model(seed, t, h, bound):
    """A model of csrc/draw_tables.cu's reference lane in Python ints: 32
    lanes hold LCG states one draw apart, each step takes 32 raw draws,
    keeps the accepted ones in stream order (the ballot's prefix count)
    and jumps every lane by advance^32."""
    mult, add = 0x5DEECE66D, 0xB
    s0 = ((seed + t) ^ mult) & _MASK48
    states = []
    for _ in range(32):
        s0 = (s0 * mult + add) & _MASK48
        states.append(s0)
    a32, c32 = mult, add
    for _ in range(5):
        c32 = (a32 * c32 + c32) & _MASK48
        a32 = (a32 * a32) & _MASK48
    pow2 = (bound & -bound) == bound
    limit = ((1 << 31) // bound) * bound
    out, written = [None] * h, 0
    while written < h:
        bits = [s >> 17 for s in states]
        ok = [pow2 or b < limit for b in bits]
        for lane in range(32):
            pos = written + sum(ok[:lane])
            if ok[lane] and pos < h:
                out[pos] = ((bound * bits[lane]) >> 31 if pow2
                            else bits[lane] % bound)
        written += sum(ok)
        states = [(s * a32 + c32) & _MASK48 for s in states]
    return out


@pytest.mark.parametrize("seed,t,h,bound", [
    (0, 1, 50, 500), (7, 999_999, 253, 2531), (3, 2, 70, (1 << 30) + 1),
    (-5, 4, 40, 64), (2**40, 9, 33, 1), ((1 << 31) - 3, 2, 100, 3)])
def test_reference_warp_model_equals_host(seed, t, h, bound):
    """The reference kernel's warp scheme, modelled, against the host
    replay (the kernel itself is held to it on the card)."""
    want = prng.sample_indices_per_shard(seed, [t], h, [bound])[0, 0]
    assert _warp_model(seed, t, h, bound) == want.tolist()


def test_feistel_domain_bits_equal_host():
    """The kernel's domain width from integer bits, 2*ceil(ceil(log2 n)/2)
    at least 2, against the host's float log2, across powers of two and
    their neighbours up to 2^31."""
    ns = sorted({max(2, (1 << p) + d) for p in range(1, 31)
                 for d in (-1, 0, 1)})
    for n in ns:
        bits = (n - 1).bit_length()
        kernel = 2 if bits < 2 else ((bits + 1) // 2) * 2
        host = max(2, -(-int(np.ceil(np.log2(n))) // 2) * 2)
        assert kernel == host, n
