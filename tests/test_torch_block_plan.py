"""The block kernels' plans and designs (the chain B3, ``csrc/block_chain.cu``
``chain_kernel``, the sparse Gram B5 and the sparse apply B6,
``csrc/sparse_block.cu`` ``gram_kernel`` and ``apply_kernel``), on the CPU
where the kernels cannot run: ``chain_plan``, ``gram_plan`` and
``apply_plan`` at the main shapes and their refusals, their byte counts
against the kernels' formulas, the wrappers' calls into the C entry
points, the chain's ring of mbarrier-guarded slots under random
interleavings, and numpy models of the three designs (the right-looking
chain reading its Gram from the staged units, the Gram from shared-memory
hash tables, the apply's column slices folded in (row, slot) order) held
against the plain versions: in float64 to 1e-12, the apply bit for bit in
float32 and float64."""

import random
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from cocoa_torch import kernels  # noqa: E402
from cocoa_torch.ops import block_chain as bc  # noqa: E402
from cocoa_torch.ops import losses  # noqa: E402
from cocoa_torch.ops import sparse_block as sb  # noqa: E402

OPTIN = 232448  # an H100's opt-in shared memory per block
SMS = 132       # an H100 SXM's streaming multiprocessors
HASH_MUL = 2654435769  # csrc/sparse_block.cu kHashMul
TOL = 1e-12     # float64: the models and the plain versions sum in
                # different orders
LOSSES = [("hinge", 1.0), ("smooth_hinge", 0.5), ("logistic", 1.0)]
MODES = [("cocoa", 1.0, 1.0), ("plus", 4.0, 4.0), ("frozen", 0.0, 1.0)]
LAM_N = 0.96


# --------------------------------------------------------------------------
# the plans
# --------------------------------------------------------------------------

# (B, itemsize, the auto chain plan (stages, cols)): the rcv1-like and
# demo blocks (128), the epsilon-like split shapes (256, 512) and the
# wrapper's limit (1024); B=128 and B=256 float32 stage the whole triangle
CHAIN_PLANS = [(128, 4, (4, 32)), (128, 8, (4, 32)), (256, 4, (8, 32)),
               (256, 8, (7, 16)), (512, 4, (6, 16)), (512, 8, (5, 8)),
               (1024, 4, (5, 8)), (1024, 8, (2, 8))]


def _units(b, cols):
    return -(-b // cols)


@pytest.mark.parametrize("b,itemsize,want", CHAIN_PLANS,
                         ids=[f"B{p[0]}-f{p[1] * 8}" for p in CHAIN_PLANS])
def test_chain_plan_at_main_shapes(b, itemsize, want):
    """The auto plan stages every unit in its own slot where that fits,
    else the widest unit with at least AUTO_CHAIN_STAGES slots, as deep as
    fits, else the narrowest unit as deep as fits; every plan fits the
    opt-in and one more slot would not (unless every unit has one)."""
    stages, cols, used = bc.chain_plan(b, itemsize, OPTIN)
    assert (stages, cols) == want
    assert used == bc.chain_smem_bytes(b, stages, cols, itemsize) <= OPTIN
    units = _units(b, cols)
    assert 1 <= stages <= units
    if stages < units:
        assert bc.chain_smem_bytes(b, stages + 1, cols, itemsize) > OPTIN
    for wider in bc.CHAIN_COLS[:bc.CHAIN_COLS.index(cols)]:
        need = min(_units(b, wider), bc.AUTO_CHAIN_STAGES)
        assert bc.chain_smem_bytes(b, need, wider, itemsize) > OPTIN
    # the whole triangle at the rcv1-like block and at B=256 float32
    assert (stages == units and cols == 32) == (b == 128
                                                or (b, itemsize) == (256, 4))


def test_chain_plan_explicit_stages_and_refusals():
    plan = bc.chain_plan
    for s in range(1, 5):
        assert plan(128, 4, OPTIN, s)[:2] == (s, 32)
    # five slots are more units of 32 than B=128 has: units of 16
    assert plan(128, 4, OPTIN, 5)[:2] == (5, 16)
    assert plan(128, 4, OPTIN, 16)[:2] == (16, 8)
    assert plan(1024, 8, OPTIN, 1)[:2] == (1, 16)
    assert plan(1024, 8, OPTIN, 2)[:2] == (2, 8)
    with pytest.raises(ValueError, match="cannot stage 17 slots"):
        plan(128, 4, OPTIN, 17)
    with pytest.raises(ValueError, match="cannot stage 3 slots"):
        plan(1024, 8, OPTIN, 3)
    # an opt-in that holds one slot of 8 columns at B=128 and no more
    one = bc.chain_smem_bytes(128, 1, 8, 4)
    assert plan(128, 4, one) == (1, 8, one)
    with pytest.raises(ValueError, match="cannot stage auto slots"):
        plan(128, 4, one - 1)
    for b in (0, bc.CHAIN_MAX_B + 1):
        with pytest.raises(ValueError, match="B in 1.."):
            plan(b, 4, OPTIN)
    for bad in (0, -1, 2.0, True, "3"):
        with pytest.raises(ValueError, match="stages must be an int"):
            plan(128, 4, OPTIN, bad)


def _slot_rows_before(b, cols, s):
    """csrc/block_chain.cu slot_rows_before, the closed form."""
    g, m = 32 // cols, s // (32 // cols)
    return s * b - 32 * (g * m * (m - 1) // 2 + m * (s - m * g))


def test_chain_smem_matches_the_kernel():
    """The plan's constants and byte count are the kernel's, read from the
    source; the kernel's closed form of the ring's rows equals the plan's
    sum at every B, unit width and depth."""
    src = kernels.SOURCES["block_chain"].read_text()
    assert "if (cols != 32 && cols != 16 && cols != 8) return false;" in src
    assert tuple(sorted(bc.CHAIN_COLS, reverse=True)) == (32, 16, 8)
    assert "return stages >= 1 && stages <= (b + cols - 1) / cols;" in src
    assert "if (b < 1 || b > 1024) return false;" in src \
        and bc.CHAIN_MAX_B == 1024
    assert ("  return 16 * (size_t)stages +\n"
            "         ((size_t)(cols + 1) * slot_rows_before(b, cols, stages)"
            " +\n          8 * (size_t)b) * itemsize;") in src
    assert "32LL * (g * (long long)m * (m - 1) / 2 + (long long)m * " \
        "(s - m * g));" in src
    for b in (1, 31, 32, 100, 128, 200, 256, 512, 1000, 1024):
        for cols in bc.CHAIN_COLS:
            for s in range(_units(b, cols) + 1):
                assert _slot_rows_before(b, cols, s) == sum(
                    bc.chain_slot_rows(b, cols, t) for t in range(s))
    assert bc.chain_smem_bytes(128, 4, 32, 4) == \
        64 + (33 * (128 + 96 + 64 + 32) + 8 * 128) * 4
    # B4's chain is untouched: its three cluster barriers and chain_warp
    assert src.count("cluster.sync();") == 3
    assert "chain_warp<T, R>(b, m0, nullptr, ys, qs, as0, ls, ix," in src


def _gram_bytes(tables, slots, chunk, itemsize, b=128):
    return tables * slots * 2 * itemsize + 16 * chunk * (itemsize + 4) \
        + 4 * b


def _whole(blocks, tables, slots, width, itemsize):
    """A one-pass plan whose warps buffer whole rows of ``width``."""
    return sb.GramPlan(blocks, slots, width, width,
                       _gram_bytes(tables, slots, width, itemsize))


# (name, width, itemsize, the auto Gram plan): whole rows, one pass, the
# plans of the kernel before rows of any width were taken
GRAM_PLANS = [
    ("rcv1-like", 548, 4, _whole(16, 8, 2048, 548, 4)),
    ("rcv1-like", 548, 8, _whole(64, 2, 2048, 548, 8)),
    ("rcv1-like residual", 174, 4, _whole(16, 8, 512, 174, 4)),
    ("rcv1-like residual", 174, 8, _whole(16, 8, 512, 174, 8)),
    ("demo", 283, 4, _whole(16, 8, 1024, 283, 4)),
    ("demo", 283, 8, _whole(16, 8, 1024, 283, 8)),
]


def _kernel_takes(plan, b, width):
    """csrc/sparse_block.cu gram_plan_ok, and the shared memory."""
    chunk_ok = plan.chunk >= width or plan.chunk % 32 == 0
    cap_ok = plan.cap >= width or plan.cap % 32 == 0
    return (1 <= plan.blocks <= b and chunk_ok and cap_ok
            and plan.chunk >= 1 and 1 <= plan.cap < plan.slots
            and sb.gram_tables(b, plan.blocks) <= sb.MAX_TABLES
            and plan.slots & (plan.slots - 1) == 0
            and plan.smem <= OPTIN)


@pytest.mark.parametrize("name,width,itemsize,want", GRAM_PLANS,
                         ids=[f"{p[0]}-f{p[2] * 8}" for p in GRAM_PLANS])
def test_gram_plan_at_main_shapes(name, width, itemsize, want):
    """The default table is the least power of two of at least 2 W; the
    auto plan owns as many rows a block as fit (at most 8) beside whole
    rows, in one pass; every asked rows_per_cta gives ceil(B / rows)
    blocks, with whole rows where they fit, else chunks of CHUNK entries
    beside the default tables, else beside the largest tables that fit,
    in passes of half a table."""
    plan = sb.gram_plan(128, width, itemsize, OPTIN)
    assert plan == want
    assert plan.slots >= 2 * width and plan.slots // 2 < 2 * width
    assert plan.smem <= OPTIN
    for rows in sb.ROWS_PER_CTA:
        got = sb.gram_plan(128, width, itemsize, OPTIN, rows)
        assert got.blocks == 128 // rows and _kernel_takes(got, 128, width)
        assert got.smem == sb.gram_smem_bytes(rows, got.slots, got.chunk,
                                              128, itemsize)
        whole = sb.gram_smem_bytes(rows, plan.slots, width, 128, itemsize)
        chunked = sb.gram_smem_bytes(rows, plan.slots, sb.CHUNK, 128,
                                     itemsize)
        assert (whole <= OPTIN) == (rows <= 128 // plan.blocks)
        if whole <= OPTIN:
            assert got == plan._replace(blocks=got.blocks, smem=got.smem)
        elif chunked <= OPTIN:
            assert got == sb.GramPlan(got.blocks, plan.slots, sb.CHUNK,
                                      width, chunked)
        else:
            assert got.slots < plan.slots and got.chunk == sb.CHUNK
            assert got.cap == min(width, got.slots // 2) < width
            assert sb.gram_smem_bytes(rows, 2 * got.slots, sb.CHUNK, 128,
                                      itemsize) > OPTIN


def test_gram_plan_tables_and_refusals():
    plan = sb.gram_plan
    # B=100 over 8 rows a block: 13 blocks, the last owning 9 - 1 rows
    assert plan(100, 20, 4, OPTIN, 8)[0] == 13
    assert sb.gram_tables(100, 13) == 8
    assert sb.gram_tables(10, 2) == 8      # 5 rows, rounded up
    assert plan(128, 548, 4, OPTIN, slots=1024)[:2] == (16, 1024)
    assert plan(128, 1, 4, OPTIN) == _whole(16, 8, 32, 1, 4)
    for bad in (548, 1000, 3000, 0, 32, True, 2.0):
        with pytest.raises(ValueError, match="slots must be a power of two"):
            plan(128, 548, 4, OPTIN, slots=bad)
    assert plan(128, 1, 4, OPTIN, slots=2)[1] == 2
    for bad in (3, 16, 0, True, 2.0):
        with pytest.raises(ValueError, match="rows_per_cta must be one of"):
            plan(128, 548, 4, OPTIN, bad)
    small = sb.gram_smem_bytes(1, 2048, 548, 128, 4)
    assert plan(128, 548, 4, small) == _whole(128, 1, 2048, 548, 4)
    # a byte less: chunked buffers beside two tables of the same size
    assert plan(128, 548, 4, small - 1) == sb.GramPlan(
        64, 2048, sb.CHUNK, 548, _gram_bytes(2, 2048, sb.CHUNK, 4))
    assert plan(128, 548, 4, small, 2) == plan(128, 548, 4, small - 1)
    # a table asked for below the row's width: passes of half the table
    assert plan(128, 548, 4, OPTIN, slots=256) == _whole(
        16, 8, 256, 548, 4)._replace(cap=128)
    # the one refusal: an asked plan that cannot fit
    with pytest.raises(ValueError, match="cannot hold auto tables of 65536"):
        plan(128, 548, 4, OPTIN, slots=1 << 16)
    with pytest.raises(ValueError, match="cannot hold 8 tables of 8192"):
        plan(128, 548, 8, OPTIN, 8, 1 << 13)
    tiny = _gram_bytes(1, sb.MIN_PASS_SLOTS, sb.CHUNK, 4)
    assert plan(128, 548, 4, tiny) == sb.GramPlan(
        128, sb.MIN_PASS_SLOTS, sb.CHUNK, 32, tiny)
    with pytest.raises(ValueError, match="cannot hold auto tables"):
        plan(128, 548, 4, tiny - 1)


# the widths whose tables did not fit beside whole rows (the demo's
# padded-CSC columns are 1738 wide; 20242 is a column of rcv1's rows)
WIDE = [(4, 1560), (4, 1738), (4, 4096), (4, 20242), (8, 1028), (8, 1738)]


@pytest.mark.parametrize("b", [128, 256, 512])
@pytest.mark.parametrize("itemsize,width", WIDE,
                         ids=[f"f{i * 8}-W{w}" for i, w in WIDE])
def test_gram_plan_takes_every_width(itemsize, width, b):
    """A plan for rows of every width, within an H100's shared memory:
    chunked buffers beside default tables in one pass where they fit
    (W = 1560 to 4096 in float32, 1028 and 1738 in float64), else the
    largest table in passes of half of it, one row a block."""
    plan = sb.gram_plan(b, width, itemsize, OPTIN)
    assert _kernel_takes(plan, b, width)
    assert plan.chunk == sb.CHUNK
    passes = -(-width // plan.cap)
    if plan.slots == sb.table_slots(width):
        assert passes == 1 and plan.cap == width
    else:
        assert plan.blocks == b and plan.cap == plan.slots // 2
        assert sb.gram_smem_bytes(1, 2 * plan.slots, sb.CHUNK, b,
                                  itemsize) > OPTIN
    assert passes == {20242: 3}.get(width, 1)


def test_gram_smem_matches_the_kernel():
    src = kernels.SOURCES["sparse_block"].read_text()
    assert f"kWarps = kThreads / 32;" in src and "kThreads = 256;" in src
    assert sb.GRAM_WARPS == 256 // 32
    assert f"kMaxTables = {sb.MAX_TABLES};" in src
    assert max(sb.ROWS_PER_CTA) == sb.MAX_TABLES
    assert f"kHashMul = {HASH_MUL}u;" in src
    assert "return bits == 0 ? 0 : (int)(((unsigned)col * kHashMul) >> " \
        "(32 - bits));" in src
    assert ("  return (size_t)tables * slots * 2 * itemsize +\n"
            "         2 * (size_t)kWarps * chunk * (itemsize + sizeof(int))"
            " +\n         (size_t)b * sizeof(int);") in src
    assert "int pos = hash_slot(f, bits);" in src
    assert "const int h = hash_slot(f, bits);" in src
    assert sb.gram_smem_bytes(8, 2048, 548, 128, 4) == _gram_bytes(
        8, 2048, 548, 4)
    assert "if (chunk < 1 || (chunk < width && chunk % 32 != 0)) " \
        "return false;" in src
    assert "if (cap < 1 || (cap < width && cap % 32 != 0)) return false;" \
        in src
    assert "return cap < slots && slots <= (1 << 24) && " \
        "(slots & (slots - 1)) == 0;" in src
    # the d-wide row expansion is gone, in both placements
    assert "scratch" not in src and "atomicAdd(xrow" not in src
    assert not hasattr(sb, "_row_scratch") and not hasattr(sb, "_SCRATCH")


# --------------------------------------------------------------------------
# the chain's ring: mbarrier phases under random interleavings
# --------------------------------------------------------------------------


def _try_wait(done, parity):
    """mbarrier.try_wait.parity: true when the phase of this parity has
    completed, ``done`` phases having completed (phase -1 counts as
    complete)."""
    return done % 2 != parity


def _ring_walk(units, stages, seed):
    """The producers (one thread stands for all: they move together
    through the same barrier waits) and the consumer of chain_kernel, one
    move at a time, picked at random among those the barriers allow.
    Returns the units in the order the consumer read them."""
    rnd = random.Random(seed)
    full, empty = [0] * stages, [0] * stages
    held = [None] * stages
    prod, cons, read = 0, 0, []
    while cons < units:
        moves = []
        if prod < units:
            s, r = prod % stages, prod // stages
            if r == 0 or _try_wait(empty[s], (r - 1) & 1):
                moves.append("produce")
        s = cons % stages
        if _try_wait(full[s], (cons // stages) & 1):
            moves.append("consume")
        assert moves, "deadlock"
        if rnd.choice(moves) == "produce":
            s = prod % stages
            assert held[s] is None, "a slot refilled before it was read"
            held[s] = prod
            full[s] += 1
            prod += 1
        else:
            s = cons % stages
            assert held[s] == cons, "a unit read before it was staged"
            held[s] = None
            read.append(cons)
            empty[s] += 1
            cons += 1
    return read


@pytest.mark.parametrize("b,itemsize", [(p[0], p[1]) for p in CHAIN_PLANS])
def test_chain_ring_at_every_depth(b, itemsize):
    """Every depth a plan can take, at every unit width: the consumer reads
    each unit once, in order, after it was staged, and no slot is
    refilled before it was read, whatever the interleaving."""
    for cols in bc.CHAIN_COLS:
        units = _units(b, cols)
        for stages in sorted({1, 2, 3, 7, units}):
            if stages > units:
                continue
            for seed in range(3):
                assert _ring_walk(units, stages, seed) == list(range(units))


# --------------------------------------------------------------------------
# a numpy model of the right-looking chain, reading the staged units
# --------------------------------------------------------------------------


def _stage_unit(ring, gram, b, cols, slot, q):
    """The producers' copy of unit q into its slot (csrc/block_chain.cu):
    columns [q cols, (q + 1) cols) of rows base..B-1, entries j < i only,
    at a row stride of cols + 1 from the slot's offset."""
    ld = cols + 1
    off = ld * sum(bc.chain_slot_rows(b, cols, t) for t in range(slot))
    j0, base = q * cols, (q * cols) // 32 * 32
    for ri in range(b - base):
        i = base + ri
        for cc in range(cols):
            j = j0 + cc
            if j < i:
                ring[:, off + ri * ld + cc] = gram[:, i, j]
    return off


def right_looking_chain(scal, gram, idx, lam_n, coef_div, sig_eff, frozen,
                        loss, smoothing, stages, cols):
    """chain_kernel's arithmetic over all K shards at once: acc_i and a_i
    carried a row, each step's coefficient pushed into the rows still to
    come, the Gram read from the ring of staged units (the rest of the
    ring is NaN, so an entry read from the wrong place shows)."""
    k, _, b = scal.shape
    m0, y, qii, a0, mb, live = scal.unbind(1)
    ld = cols + 1
    ring = torch.full((k, ld * sum(bc.chain_slot_rows(b, cols, s)
                                   for s in range(stages))), float("nan"),
                      dtype=scal.dtype)
    acc = torch.zeros(k, b, dtype=scal.dtype)
    a = a0.clone()
    delta = torch.zeros_like(acc)
    coef = torch.zeros_like(acc)
    lam_n_t = torch.tensor(lam_n, dtype=scal.dtype)
    for q in range(_units(b, cols)):
        j0 = q * cols
        if not frozen:
            off = _stage_unit(ring, gram, b, cols, q % stages, q)
        for j in range(j0, min(b, j0 + cols)):
            margin = m0[:, j]
            if not frozen:
                margin = margin + sig_eff * (mb[:, j] + acc[:, j])
            new_a = losses.alpha_step(loss, a[:, j], y[:, j] * margin,
                                      qii[:, j], lam_n_t, smoothing=smoothing)
            dj = (new_a - a[:, j]) * live[:, j]
            cj = y[:, j] * dj / coef_div
            delta[:, j], coef[:, j] = dj, cj
            rows = torch.arange(j + 1, b)
            if not frozen and len(rows):
                base = j // 32 * 32
                g = ring[:, off + (rows - base) * ld + (j - j0)]
                acc[:, j + 1:] = acc[:, j + 1:] + cj[:, None] * g
            same = idx[:, j + 1:] == idx[:, j:j + 1]
            a[:, j + 1:] = a[:, j + 1:] + torch.where(same, dj[:, None], 0.0)
    return delta, coef


def _chain_case(case, qf, seed=11, k=3, b=200, d=10):
    """A block of B=200 draws (not a multiple of 32, so the last panel is
    cut).  ``repeats``: each step t past 40 redraws step t - g, g cycling
    over 1..40, so repeats fall inside units and across panel boundaries;
    ``garbage``: the diagonal and the upper triangle hold large values
    that a kernel reading them would carry into the result; ``masked``:
    the last 37 steps and a run in the middle are masked."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(k, 60, d)) * 0.4
    idx = rng.integers(0, 60, size=(k, b))
    if case == "repeats":
        for n, t in enumerate(range(40, b)):
            g = n % 40 + 1
            idx[:, t] = idx[:, t - g]
    ks = np.arange(k)[:, None]
    xb = X[ks, idx]
    gram = np.einsum("kjd,kid->kji", xb, xb)
    if case == "garbage":
        gram = np.tril(gram, -1) + np.triu(rng.normal(size=gram.shape) * 1e6)
    live = np.ones((k, b))
    if case == "masked":
        live[:, b - 37:] = 0.0
        live[:, 60:70] = 0.0
    scal = np.stack([xb @ (rng.normal(size=d) * 0.2),
                     np.where(rng.random((k, b)) > 0.5, 1.0, -1.0),
                     (xb * xb).sum(-1) * qf,
                     np.clip(rng.normal(0.4, 0.3, (k, b)), 0, 1),
                     rng.normal(size=(k, b)) * 0.1, live], axis=1)
    to = torch.as_tensor
    return to(scal), to(np.ascontiguousarray(gram)), \
        to(idx, dtype=torch.int32)


# each case at its own plan of the kernel: the whole triangle in units of
# 32, a ring of 2 slots of 16 columns, a single slot of 8 columns
CHAIN_CASES = [("repeats", (7, 32)), ("garbage", (2, 16)), ("masked", (1, 8))]


@pytest.mark.parametrize("case,plan", CHAIN_CASES,
                         ids=[c[0] for c in CHAIN_CASES])
@pytest.mark.parametrize("loss,smoothing", LOSSES)
@pytest.mark.parametrize("mode,sig_eff,qf", MODES)
def test_right_looking_chain_matches_plain(mode, sig_eff, qf, loss,
                                           smoothing, case, plan):
    frozen = mode == "frozen"
    scal, gram, idx = _chain_case(case, qf)
    kw = dict(lam_n=LAM_N, coef_div=LAM_N, sig_eff=sig_eff, frozen=frozen,
              loss=loss, smoothing=smoothing)
    want = bc.chain_block_batched_plain(scal, None if frozen else gram, idx,
                                        **kw)
    got = right_looking_chain(scal, gram, idx, stages=plan[0], cols=plan[1],
                              **kw)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=TOL)
    if case == "repeats":   # the repeats moved alpha: the case is live
        assert int((idx[:, 40:] == idx[:, 39:-1]).sum()) > 0
        assert float(want[0].abs().max()) > 0.0


# --------------------------------------------------------------------------
# a numpy model of the Gram from shared-memory hash tables
# --------------------------------------------------------------------------


def _butterfly(part):
    """sdca::warp_sum's order: lane l adds lane l ^ off, off = 16..1."""
    v = part.copy()
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ off]
    return v[0]


def _hash_slot(col, bits):
    """csrc/sparse_block.cu hash_slot: where the probe for column ``col``
    starts in a table of 2**bits slots, the top ``bits`` bits of col *
    kHashMul mod 2**32."""
    return 0 if bits == 0 else ((col * HASH_MUL) & 0xFFFFFFFF) >> (32 - bits)


class _Table:
    """One open-addressing table of gram_kernel, with its probe counts."""

    def __init__(self, slots):
        self.keys = np.full(slots, -1, np.int64)
        self.vals = np.zeros(slots)
        self.bits = slots.bit_length() - 1
        self.mask = slots - 1
        self.wraps = self.collisions = 0

    def _find(self, f):
        pos = _hash_slot(int(f), self.bits)
        while self.keys[pos] not in (-1, f):
            self.collisions += 1
            self.wraps += pos == self.mask
            pos = (pos + 1) & self.mask
        return pos

    def insert_chunk(self, cols, vals):
        """A 32-entry chunk: equal columns grouped, each group's values
        summed in lane order by its lowest lane, added to the slot."""
        groups = {}
        for f, v in zip(cols, vals):
            groups.setdefault(int(f), []).append(v)
        for f, vs in groups.items():
            s = vs[0] if len(vs) == 1 else sum(vs, 0.0)
            pos = self._find(f)
            self.keys[pos] = f
            self.vals[pos] = self.vals[pos] + s

    def lookup(self, f):
        pos = self._find(int(f))
        return self.vals[pos] if self.keys[pos] == f else None


def hash_gram(w, dw, gidx, gvals, cnts, sig_eff, frozen, blocks, slots,
              chunk=None, cap=None):
    """gram_kernel's walk: block t of each shard owns rows t + o * blocks;
    pass p builds their tables from entries [p cap, (p + 1) cap), chunk
    by chunk of 32 (and sums their margin bases on), then looks every
    later row's entries up, staged ``chunk`` at a time, lane-strided, one
    butterfly a table at the row's end: pass 0 writes the dot, a later
    pass adds its part where the owned row still had entries.  ``chunk``
    and ``cap`` None: the whole row (one pass).  Returns (gram, mb, the
    tables of every pass)."""
    k, b, width = gidx.shape
    chunk, cap = chunk or max(width, 1), cap or max(width, 1)
    gram = np.zeros((k, b, b))
    mb = np.zeros((k, b))
    built = []
    for s in range(k):
        for t in range(blocks):
            owned = list(range(t, b, blocks))
            cnt_of = [max(int(cnts[s, i]), 0) for i in owned]
            passes = 1 if frozen else max(
                [1] + [-(-c // cap) for c in cnt_of])
            mparts = [np.zeros(32) for _ in owned]
            for p in range(passes):
                tables = []
                for o, i in enumerate(owned):
                    cnt = cnt_of[o]
                    lo, hi = (0, cnt) if frozen else \
                        (p * cap, min(cnt, (p + 1) * cap))
                    table = _Table(slots)
                    for base in range(lo, hi, 32):
                        cols = gidx[s, i, base:min(hi, base + 32)]
                        vals = gvals[s, i, base:min(hi, base + 32)]
                        coord = w[cols] + (0 if frozen
                                           else sig_eff * dw[s, cols])
                        mparts[o][:len(cols)] += vals * coord
                        table.insert_chunk(cols, vals)
                    if p == (0 if frozen or cnt == 0 else (cnt - 1) // cap):
                        mb[s, i] = _butterfly(mparts[o])
                    tables.append(table)
                built += tables
                if frozen:
                    continue
                for j in range(t + 1, b):
                    cnt = max(int(cnts[s, j]), 0)
                    parts = [np.zeros(32) for _ in owned]
                    for c0 in range(0, max(cnt, 1), chunk):
                        for e in range(min(chunk, cnt - c0)):
                            lane = e % 32   # the lane that staged it
                            for o, (i, table) in enumerate(zip(owned,
                                                               tables)):
                                x = None if i >= j else \
                                    table.lookup(gidx[s, j, c0 + e])
                                if x is not None:
                                    parts[o][lane] += gvals[s, j, c0 + e] * x
                    for o, i in enumerate(owned):
                        if i < j and p == 0:
                            gram[s, j, i] = _butterfly(parts[o])
                        elif i < j and p * cap < cnt_of[o]:
                            gram[s, j, i] += _butterfly(parts[o])
    return (None if frozen else gram), mb, built


def _end_columns(slots, n, d):
    """n columns below d whose probe starts at the table's last slot."""
    out = [c for c in range(d)
           if _hash_slot(c, slots.bit_length() - 1) == slots - 1]
    assert len(out) >= n
    return out[:n]


def _gram_case(case, k=2, b=48, width=40, d=3000, seed=13):
    """Padded-CSR rows of one block.  ``tiny table``: full-width rows of
    distinct columns in a table of 64 slots (the least power of two above
    W), several columns hashing to the last slot, so probes collide and
    wrap; ``column 0 and repeats``: rows holding a real column 0 (first,
    inside, and alone before padding), columns repeated within a row
    (inside a chunk and across chunks) in rows i and j; ``masked and
    full``: masked rows (-1) among live ones and rows at the full width."""
    rng = np.random.default_rng(seed)
    gidx = np.zeros((k, b, width), np.int32)
    gvals = np.zeros((k, b, width))
    cnts = np.zeros((k, b), np.int32)
    pool = rng.choice(d, 120, replace=False)
    for s in range(k):
        for j in range(b):
            n = width if case != "column 0 and repeats" else \
                int(rng.integers(1, width + 1))
            gidx[s, j, :n] = rng.choice(pool, n, replace=False)
            gvals[s, j, :n] = rng.normal(size=n)
            cnts[s, j] = n
    if case == "tiny table":
        ends = _end_columns(64, 6, d)
        gidx[:, ::3, :6] = ends
    elif case == "column 0 and repeats":
        gidx[:, 0, 0], cnts[:, 0] = 0, 1
        gidx[:, 1, :4], cnts[:, 1] = [9, 0, 9, 5], 4
        gidx[:, 2, 0] = 0
        for j in range(3, b, 5):
            n = int(cnts[0, j])
            gidx[:, j, n // 2] = gidx[:, j, 0]          # within a chunk
            gidx[:, j, n - 1] = gidx[:, j, 1]           # maybe across
        gidx[:, 7, :width], cnts[:, 7] = gidx[:, 8, :width], width
        gidx[:, 7, 35] = gidx[:, 7, 2]                  # across chunks
    elif case == "masked and full":
        cnts[:, 5:9] = -1
        cnts[1, 30:] = -1
    w = rng.normal(size=d) * 0.3
    dw = rng.normal(size=(k, d)) * 0.1
    return gidx, gvals, cnts, w, dw


GRAM_CASES = ["tiny table", "column 0 and repeats", "masked and full"]


# (chunk, cap) of the model: whole rows in one pass; chunks of 32 in one
# pass; whole rows in two passes of 32 (the 40-entry rows split 32 + 8)
STAGINGS = [(None, None), (32, None), (None, 32)]


@pytest.mark.parametrize("chunk,cap", STAGINGS,
                         ids=["whole", "chunks", "passes"])
@pytest.mark.parametrize("blocks", [6, 48])
@pytest.mark.parametrize("sig_eff,frozen", [(4.0, False), (1.0, True)])
@pytest.mark.parametrize("case", GRAM_CASES)
def test_hash_gram_matches_plain(case, sig_eff, frozen, blocks, chunk, cap):
    """The hash-table walk at 8 rows a block (6 blocks) and at one (48),
    rows staged whole and in chunks, built in one pass and in two,
    against the plain version's dense expansion, within 1e-12."""
    gidx, gvals, cnts, w, dw = _gram_case(case)
    width = gidx.shape[-1]
    slots = 64 if case == "tiny table" else sb.table_slots(width)
    gram, mb, tables = hash_gram(w, dw, gidx, gvals, cnts, sig_eff, frozen,
                                 blocks, slots, chunk, cap)
    to = torch.as_tensor
    want_g, want_mb = sb.sparse_block_gram_plain(
        to(w), to(dw), to(gidx), to(gvals), to(cnts), sig_eff, frozen)
    np.testing.assert_allclose(mb, want_mb.numpy(), rtol=0, atol=TOL)
    if frozen:
        assert gram is None and want_g is None
        return
    np.testing.assert_allclose(gram, want_g.numpy(), rtol=0, atol=TOL)
    assert np.all(np.triu(gram[0]) == 0)
    if case == "tiny table":
        assert sum(t.wraps for t in tables) > 0
        assert sum(t.collisions for t in tables) > 0
    if case == "column 0 and repeats":  # row 1 = 9, 0, 9, 5: 0 meets 0
        assert gram[0, 1, 0] == pytest.approx(
            gvals[0, 0, 0] * gvals[0, 1, 1], abs=TOL)
    if case == "masked and full":
        assert np.all(gram[:, 5:9] == 0) and np.all(gram[:, :, 5:9] == 0)
        assert np.all(mb[:, 5:9] == 0) and np.all(mb[1, 30:] == 0)


@pytest.mark.parametrize("case", GRAM_CASES)
def test_chunks_and_passes_keep_the_bits(case):
    """Rows staged in chunks of 32 give the whole-row walk's bits (a lane
    holds the same entries in the same order), and so does the margin
    base built in passes; the Gram in passes differs only in rounding."""
    gidx, gvals, cnts, w, dw = _gram_case(case)
    slots = 64 if case == "tiny table" else sb.table_slots(gidx.shape[-1])
    args = (w, dw, gidx, gvals, cnts, 4.0, False, 6, slots)
    whole, chunks, passes = (hash_gram(*args, chunk, cap)[:2]
                             for chunk, cap in STAGINGS)
    assert np.array_equal(whole[0], chunks[0])
    assert np.array_equal(whole[1], chunks[1])
    assert np.array_equal(whole[1], passes[1])
    np.testing.assert_allclose(passes[0], whole[0], rtol=0, atol=TOL)


def test_tables_keep_an_empty_slot():
    """A table of the least power of two above W holds a full row of
    distinct columns with a slot to spare, so every miss ends."""
    gidx, gvals, cnts, w, dw = _gram_case("tiny table")
    table = _Table(64)
    for base in range(0, 40, 32):
        table.insert_chunk(gidx[0, 0, base:base + 32],
                           gvals[0, 0, base:base + 32])
    assert int((table.keys == -1).sum()) == 64 - 40
    assert table.lookup(2999 if 2999 not in gidx[0, 0] else 2998) is None


# --------------------------------------------------------------------------
# the wrappers: the plan into the C entry points; none on the CPU
# --------------------------------------------------------------------------


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _entry_arity(src, name):
    sig = re.search(rf'extern "C" int {name}\((.*?)\)', src, re.S).group(1)
    return sig.count(",") + 1


def _macro_arity(src, macro):
    """The parameters of the C entry points a macro defines."""
    sig = re.search(rf"#define {macro}\(NAME, T\)\s*\\\s*extern \"C\" int "
                    rf"NAME\((.*?)\)", src, re.S).group(1)
    return sig.count(",") + 1


def _kernel_route(monkeypatch, module):
    calls = []

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return 0
            return entry

    monkeypatch.setattr(kernels, "runs_plain", lambda device: False)
    monkeypatch.setattr(kernels, "require_cuda", lambda t, name: None)
    monkeypatch.setattr(kernels, "smem_optin", lambda device: OPTIN)
    monkeypatch.setattr(kernels, "sm_count", lambda device: SMS)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(module, "_library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Null())
    return calls


@pytest.mark.parametrize("stages", [None, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chain_wrapper_passes_the_plan(monkeypatch, dtype, stages):
    calls = _kernel_route(monkeypatch, bc)
    scal, gram, idx = _chain_case("masked", 1.0, b=256)
    before = bc.chain_block_batched.launches
    bc.chain_block_batched(scal.to(dtype), gram.to(dtype), idx, LAM_N,
                           LAM_N, 4.0, False, "hinge", stages=stages)
    (name, args), = calls
    assert name == bc._CHAIN_FN[dtype]
    src = kernels.SOURCES["block_chain"].read_text()
    assert len(args) == _macro_arity(src, "CHAIN_ENTRY")
    plan = bc.chain_plan(256, dtype.itemsize, OPTIN, stages)
    assert args[5:9] == (3, 256, plan[0], plan[1])
    assert bc.chain_block_batched.launches == before + 1
    bc.chain_block_batched.launches = before


@pytest.mark.parametrize("rows,slots", [(None, None), (2, 128), (4, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gram_wrapper_passes_the_plan(monkeypatch, dtype, rows, slots):
    calls = _kernel_route(monkeypatch, sb)
    gidx, gvals, cnts, w, dw = _gram_case("masked and full")
    to = torch.as_tensor
    before = sb.sparse_block_gram.launches
    sb.sparse_block_gram(to(w).to(dtype), to(dw).to(dtype), to(gidx),
                         to(gvals).to(dtype), to(cnts), 4.0, False,
                         rows_per_cta=rows, slots=slots)
    (name, args), = calls
    assert name == sb._GRAM_FN[dtype]
    src = kernels.SOURCES["sparse_block"].read_text()
    assert len(args) == _macro_arity(src, "GRAM_ENTRY")
    plan = sb.gram_plan(48, 40, dtype.itemsize, OPTIN, rows, slots)
    assert args[7:15] == (2, 48, 40, 3000, *plan[:4])
    assert sb.sparse_block_gram.launches == before + 1
    sb.sparse_block_gram.launches = before


def test_plain_routes_ignore_the_plans():
    """On the CPU no plan exists: every valid plan gives the plain
    version's result, bit for bit, with no launch."""
    scal, gram, idx = _chain_case("repeats", 4.0)
    kw = dict(lam_n=LAM_N, coef_div=LAM_N, sig_eff=4.0, frozen=False,
              loss="hinge")
    n3, n5 = bc.chain_block_batched.launches, sb.sparse_block_gram.launches
    want = bc.chain_block_batched(scal, gram, idx, **kw)
    for stages in (1, 3, 7, 50):
        got = bc.chain_block_batched(scal, gram, idx, stages=stages, **kw)
        assert all(torch.equal(g, x) for g, x in zip(got, want))
    to = torch.as_tensor
    gidx, gvals, cnts, w, dw = _gram_case("column 0 and repeats")
    args = (to(w), to(dw), to(gidx), to(gvals), to(cnts), 4.0, False)
    want = sb.sparse_block_gram(*args)
    for rows in sb.ROWS_PER_CTA:
        got = sb.sparse_block_gram(*args, rows_per_cta=rows, slots=64)
        assert all(torch.equal(g, x) for g, x in zip(got, want))
    assert (bc.chain_block_batched.launches,
            sb.sparse_block_gram.launches) == (n3, n5)


@pytest.mark.parametrize("stages", [0, -2, 1.5, False, True])
def test_chain_stages_refused_on_the_cpu_route(stages):
    scal, gram, idx = _chain_case("masked", 1.0)
    with pytest.raises(ValueError, match="stages must be an int"):
        bc.chain_block_batched(scal, gram, idx, LAM_N, LAM_N, 1.0, False,
                               "hinge", stages=stages)


@pytest.mark.parametrize("rows,slots", [(3, None), (True, None),
                                        (None, 40), (None, 48), (None, 1.0)])
def test_gram_plan_refused_on_the_cpu_route(rows, slots):
    gidx, gvals, cnts, w, dw = _gram_case("masked and full")
    to = torch.as_tensor
    with pytest.raises(ValueError, match="must be"):
        sb.sparse_block_gram(to(w), to(dw), to(gidx), to(gvals), to(cnts),
                             4.0, False, rows_per_cta=rows, slots=slots)


# --------------------------------------------------------------------------
# the apply (B6): its plan, and a numpy model of its slices, staging,
# compaction and column owners, bit for bit
# --------------------------------------------------------------------------

def _apply(slices, cols, itemsize, b=128, chunk=4096):
    return sb.ApplyPlan(slices, cols, chunk,
                        (cols + b + 3 * chunk) * itemsize
                        + (b + 1 + 3 * chunk + 16) * 4 + 4 * chunk + cols)


# (name, K, W, d, itemsize, the auto apply plan): the main paths' blocks
# (B = 128): rcv1-like and its hybrid residual (K = 8: 16 slices, 128
# blocks), the demo and the demo's padded-CSC columns into Delta-r (K = 4:
# 32 slices, 128 blocks), every slice in shared memory beside chunks of
# 4096 entries
APPLY_PLANS = [
    (name, k, width, d, isz, _apply(slices, cols, isz))
    for name, k, width, d, slices, cols in (
        ("rcv1-like", 8, 548, 47236, 16, 2953),
        ("rcv1-like residual", 8, 174, 47236, 16, 2953),
        ("demo", 4, 283, 9947, 32, 311),
        ("demo columns", 4, 1738, 2000, 32, 63))
    for isz in (4, 8)]


@pytest.mark.parametrize("name,k,width,d,itemsize,want", APPLY_PLANS,
                         ids=[f"{p[0]}-f{p[4] * 8}" for p in APPLY_PLANS])
def test_apply_plan_at_main_shapes(name, k, width, d, itemsize, want):
    plan = sb.apply_plan(k, 128, width, d, itemsize, OPTIN, SMS)
    assert plan == want
    assert k * plan.slices <= SMS < 2 * k * plan.slices
    assert plan.smem <= OPTIN
    assert plan.slices * plan.cols >= d > plan.slices * (plan.cols - 1)
    # the row width never enters the plan
    assert sb.apply_plan(k, 128, 20000, d, itemsize, OPTIN, SMS) == plan


def test_apply_plan_slices_and_refusals():
    plan = sb.apply_plan
    # one slice a shard: the whole Delta-w (189 KB in float32, 236 KB with
    # its byte a column) fits beside no chunk; two slices fit beside
    # chunks of 2048 in float32, of 256 in float64
    for itemsize in (4, 8):
        with pytest.raises(ValueError,
                           match="cannot hold a slice of d=47236"):
            plan(8, 128, 548, 47236, itemsize, OPTIN, SMS, 1)
    assert plan(8, 128, 548, 47236, 4, OPTIN, SMS, 2) == _apply(
        2, 23618, 4, chunk=2048)
    assert plan(8, 128, 548, 47236, 8, OPTIN, SMS, 2) == _apply(
        2, 23618, 8, chunk=256)
    # asked slices: ceil(d / slices) columns, at most the largest power of
    # two up to d
    assert plan(8, 128, 548, 47236, 4, OPTIN, SMS, 64)[:2] == (64, 739)
    assert plan(8, 128, 548, 47236, 8, OPTIN, SMS, 4)[:3] == (4, 11809,
                                                             2048)
    assert plan(4, 128, 10, 100, 4, OPTIN, SMS, 256)[:2] == (64, 2)
    assert plan(4, 128, 10, 5, 4, OPTIN, SMS)[:2] == (4, 2)
    assert plan(4, 128, 10, 1, 4, OPTIN, SMS)[:2] == (1, 1)
    # more shards than SMs: one slice each
    assert plan(200, 128, 10, 5000, 4, OPTIN, SMS)[:2] == (1, 5000)
    # a Delta-w too wide for 16 slices: 32 of them
    assert plan(8, 128, 548, 10 ** 6, 4, OPTIN, SMS)[:3] == (32, 31250,
                                                            2048)
    for bad in (0, -1, 3, 12, True, 1.5, "2"):
        with pytest.raises(ValueError, match="slices must be a power of two"):
            plan(8, 128, 548, 47236, 4, OPTIN, SMS, bad)
    for b in (0, sb.APPLY_MAX_B + 1):
        with pytest.raises(ValueError, match="takes 1 <= B"):
            plan(8, b, 548, 47236, 4, OPTIN, SMS)
    # the least slices: 32768, the largest power of two up to d, of 2
    # columns each beside the smallest chunk
    tiny = sb.apply_smem_bytes(2, sb.APPLY_CHUNKS[-1], 128, 4)
    assert plan(8, 128, 548, 47236, 4, tiny, SMS) == sb.ApplyPlan(
        32768, 2, sb.APPLY_CHUNKS[-1], tiny)
    with pytest.raises(ValueError, match="cannot hold"):
        plan(8, 128, 548, 47236, 4, tiny - 1, SMS)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("b", [1, 128, 1024])
@pytest.mark.parametrize("d", [1, 31, 2000, 9947, 47236, 10 ** 6, 10 ** 7])
def test_apply_plan_takes_every_d(d, b, itemsize):
    """Every Delta-w width at every block size the block round takes: a
    plan the kernel holds (apply_plan_ok), within an H100's shared memory;
    K S blocks fill the card where a slice fits, more slices where not."""
    for k in (1, 8):
        plan = sb.apply_plan(k, b, 548, d, itemsize, OPTIN, SMS)
        assert plan.slices & (plan.slices - 1) == 0 and plan.slices <= d
        assert plan.slices * plan.cols >= d > plan.slices * (plan.cols - 1)
        assert plan.chunk in sb.APPLY_CHUNKS
        assert plan.smem == sb.apply_smem_bytes(plan.cols, plan.chunk, b,
                                                itemsize) <= OPTIN
        fill = min(1 << ((SMS // k).bit_length() - 1),
                   1 << (d.bit_length() - 1))
        assert plan.slices >= fill
        if plan.slices > fill:
            # half as many slices fit beside no pieces
            assert sb.apply_smem_bytes(-(-d // (plan.slices // 2)),
                                       sb.APPLY_CHUNKS[-1], b,
                                       itemsize) > OPTIN


def test_apply_smem_matches_the_kernel():
    src = kernels.SOURCES["sparse_block"].read_text()
    assert ("  return ((size_t)cols + b + 3 * (size_t)chunk) * itemsize +\n"
            "         ((size_t)b + 1 + 3 * (size_t)chunk + kApplyWarps) * "
            "sizeof(int) +\n"
            "         2 * (size_t)chunk * sizeof(short) + (size_t)cols;") in src
    assert "constexpr int kApplyThreads = 512;" in src
    assert sb.APPLY_WARPS == 512 // 32
    assert sb.apply_smem_bytes(2953, 4096, 128, 4) == _apply(16, 2953,
                                                             4).smem
    assert "if (b < 1 || b > 32767 || d < 1 || slices < 1 || cols < 1) " \
        "return false;" in src
    assert "if ((slices & (slices - 1)) != 0 || slices > d) return false;" \
        in src
    assert sb.APPLY_MAX_B == 32767
    assert "if (chunk < 32 || chunk % 32 != 0) return false;" in src
    assert all(c % 32 == 0 for c in sb.APPLY_CHUNKS)
    assert "const bool own = f >= 0 && (f & (kApplyWarps - 1)) == warp;" \
        in src
    assert "lv[to] = mul_rn(cs[rb[e]], vb[e]);" in src
    # no atomics, and no barrier a row
    body = src[src.index("__global__ void __launch_bounds__(kApplyThreads) "
                         "apply_kernel"):src.index("size_t apply_smem")]
    assert "atomic" not in body
    assert body.count("__syncthreads();") == 6


def apply_model(dw, gidx, gvals, cnts, coefs, slices, cols, chunk):
    """apply_kernel's walk in numpy, in dw's dtype: block (t, k) loads
    columns t + i slices (i < cols) of shard k's dw; the shard's live
    prefixes stream in chunks of ``chunk`` entries (warp w of the 16
    staging rows ja + w, ja + w + 16, ... of the chunk, each entry with
    its row); each chunk is compacted by the warps' segments, 32 entries a
    ballot, to the slice's entries with their products coef * v rounded;
    warp w folds the list 32 entries at a time into the columns f with f %
    16 == w, a column met twice in a window summed in lane order by its
    lowest lane; the columns an entry reached are written back.  Returns
    (dw, the longest fold of one column in one window)."""
    dw = dw.copy()
    ft = dw.dtype.type
    k, b, width = gidx.shape
    d = dw.shape[1]
    nw = sb.APPLY_WARPS
    longest = 0
    for s in range(k):
        off = np.concatenate([[0], np.cumsum(np.clip(cnts[s], 0, width))])
        total = int(off[-1])
        for t in range(slices):
            owned = np.arange(t, d, slices)
            assert len(owned) <= cols
            dws = dw[s, owned].copy()
            hit = np.zeros(len(owned), bool)
            for g0 in range(0, total, chunk):
                g1 = min(total, g0 + chunk)
                n = g1 - g0
                cb = np.full(n, -1, np.int64)
                vb = np.zeros(n, dw.dtype)
                rb = np.full(n, -1, np.int64)
                ja = int(np.searchsorted(off[:b], g0, side="right")) - 1
                for w in range(nw):
                    for j in range(ja + w, b, nw):
                        if off[j] >= g1:
                            break
                        s0, s1 = max(off[j], g0) - off[j], \
                            min(off[j + 1], g1) - off[j]
                        at = off[j] - g0
                        cb[at + s0:at + s1] = gidx[s, j, s0:s1]
                        vb[at + s0:at + s1] = gvals[s, j, s0:s1]
                        rb[at + s0:at + s1] = j
                assert (rb >= 0).all()      # every entry staged once
                seg = -(-n // (32 * nw)) * 32
                listed = []
                for w in range(nw):
                    e0, e1 = w * seg, min(n, w * seg + seg)
                    for base in range(e0, e1, 32):
                        for e in range(base, min(e1, base + 32)):
                            f = int(cb[e])
                            if 0 <= f < d and f % slices == t:
                                listed.append((f // slices,
                                               ft(coefs[s, rb[e]])
                                               * ft(vb[e])))
                assert sum(min(n, w * seg + seg) - min(n, w * seg)
                           for w in range(nw)) == n
                for w in range(nw):
                    for base in range(0, len(listed), 32):
                        groups = {}
                        for f, p in listed[base:base + 32]:
                            if f % nw == w:
                                groups.setdefault(f, []).append(p)
                        for f, ps in groups.items():
                            acc = dws[f]
                            for p in ps:
                                acc = ft(acc + p)
                            dws[f] = acc
                            hit[f] = True
                            longest = max(longest, len(ps))
            dw[s, owned[hit]] = dws[hit]
    return dw, longest


def _apply_case(case, dtype, seed=17):
    """A block's rows for the apply: ``_gram_case``'s cases (full-width
    rows whose columns hash to one slot; column 0 and columns repeated
    within a row, inside a 32-entry chunk and across chunks; masked rows
    among rows at the full width), and ``hot column``: one column in
    every live row, some rows holding it twice; with coefficients and a
    Delta-w in ``dtype``."""
    base = "column 0 and repeats" if case == "hot column" else case
    gidx, gvals, cnts, _, dw = _gram_case(base)
    rng = np.random.default_rng(seed)
    if case == "hot column":
        gidx[:, :, 0] = 1733
        gidx[:, ::4, 3] = 1733
        cnts[:, ::4] = np.maximum(cnts[:, ::4], 4)
    coefs = rng.normal(size=cnts.shape) * np.where(cnts[..., None] > 0, 1,
                                                   0)[..., 0]
    return (dw.astype(dtype), gidx, gvals.astype(dtype), cnts,
            coefs.astype(dtype))


APPLY_CASES = GRAM_CASES + ["hot column"]


@pytest.mark.parametrize("chunk", [32, 4096])
@pytest.mark.parametrize("slices", [1, 8, 64])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", APPLY_CASES)
def test_apply_model_is_the_plain_version_bit_for_bit(case, dtype, slices,
                                                      chunk):
    """The model of the kernel equals the plain version's scatter_add_ on
    the CPU bit for bit: one slice a shard and many, d = 3000 not a
    multiple of 64 slices, rows staged in chunks of 32 entries (a row
    repeating a column across chunks) and whole in one chunk."""
    dw, gidx, gvals, cnts, coefs = _apply_case(case, dtype)
    d = dw.shape[1]
    got, longest = apply_model(dw, gidx, gvals, cnts, coefs, slices,
                               -(-d // slices), chunk)
    to = torch.as_tensor
    want = sb.sparse_block_apply_plain(to(dw.copy()), to(gidx), to(gvals),
                                       to(cnts), to(coefs)).numpy()
    assert got.dtype == want.dtype == dtype
    assert np.array_equal(got, want)
    assert not np.array_equal(got, dw)
    if case == "hot column" and chunk == 4096:
        # the hot column's window folds many rows in one register
        assert longest >= 4
    if case == "column 0 and repeats":
        assert longest >= 2


def test_apply_order_is_a_left_fold():
    """Why the order matters: the plain version folds a column's adds in
    (row, slot) order, and another order gives other float32 bits."""
    vals = np.array([1.0, 1e8, -1e8, 3.0], np.float32)
    gidx = np.zeros((1, 4, 1), np.int32)
    cnts = np.ones((1, 4), np.int32)
    coefs = np.ones((1, 4), np.float32)
    dw = np.zeros((1, 2), np.float32)
    to = torch.as_tensor
    want = sb.sparse_block_apply_plain(to(dw.copy()), to(gidx),
                                       to(vals.reshape(1, 4, 1)), to(cnts),
                                       to(coefs)).numpy()
    got, _ = apply_model(dw, gidx, vals.reshape(1, 4, 1), cnts, coefs, 2, 1,
                         32)
    assert want[0, 0] == got[0, 0] == np.float32(3.0)
    assert np.float32(np.float32(1.0) + np.float32(3.0)) == 4.0


@pytest.mark.parametrize("slices", [None, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_apply_wrapper_passes_the_plan(monkeypatch, dtype, slices):
    calls = _kernel_route(monkeypatch, sb)
    dw, gidx, gvals, cnts, coefs = _apply_case("masked and full", np.float64)
    to = torch.as_tensor
    before = sb.sparse_block_apply.launches
    out = to(dw).to(dtype)
    assert sb.sparse_block_apply(out, to(gidx), to(gvals).to(dtype),
                                 to(cnts), to(coefs).to(dtype),
                                 slices=slices) is out
    (name, args), = calls
    assert name == sb._APPLY_FN[dtype]
    src = kernels.SOURCES["sparse_block"].read_text()
    assert len(args) == _macro_arity(src, "APPLY_ENTRY")
    plan = sb.apply_plan(2, 48, 40, 3000, dtype.itemsize, OPTIN, SMS, slices)
    assert args[5:12] == (2, 48, 40, 3000, *plan[:3])
    assert plan.slices == (64 if slices is None else 4)
    assert sb.sparse_block_apply.launches == before + 1
    sb.sparse_block_apply.launches = before


def test_apply_plain_route_ignores_the_plan():
    dw, gidx, gvals, cnts, coefs = _apply_case("hot column", np.float32)
    to = torch.as_tensor
    n6 = sb.sparse_block_apply.launches
    want = sb.sparse_block_apply(to(dw.copy()), to(gidx), to(gvals),
                                 to(cnts), to(coefs))
    for slices in (1, 4, 1024):
        got = sb.sparse_block_apply(to(dw.copy()), to(gidx), to(gvals),
                                    to(cnts), to(coefs), slices=slices)
        assert torch.equal(got, want)
    assert sb.sparse_block_apply.launches == n6
    for bad in (0, -4, 3, True, 2.0):
        with pytest.raises(ValueError, match="slices must be"):
            sb.sparse_block_apply(to(dw.copy()), to(gidx), to(gvals),
                                  to(cnts), to(coefs), slices=bad)
