"""The sparse SDCA kernels' plan (B1 and its hot-panel branch B1h,
``cocoa_torch/csrc/sparse_sdca.cu``), on the CPU where the kernels cannot
run: ``sparse_plan`` at the main shapes and its refusals, its byte count
against the kernel's constants, the wrapper's call into the C entry
points, a model of the producers' ring with the consumer's alpha
forwarding, and the plain route, which takes no plan, against the JAX
kernel in interpret mode."""

import random
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from cocoa_tpu.data.sharding import shard_dataset as jax_shard  # noqa: E402
from cocoa_tpu.data.synth import synth_sparse as jax_synth_sparse  # noqa: E402
from cocoa_tpu.ops.pallas_sparse import pallas_sparse_sdca_round  # noqa: E402
from cocoa_tpu.utils.prng import sample_indices_per_shard  # noqa: E402
from cocoa_torch import interop, kernels  # noqa: E402
from cocoa_torch.ops import sparse_sdca as sp  # noqa: E402

OPTIN = 232448  # an H100's opt-in shared memory per block
MAX = sp.MAX_STAGES
K, H, LAM, N_HOT = 4, 29, 0.01, 128
TOL = 1e-12  # float64: the two packages sum in different orders

# (name, width, d, n_hot, itemsize, plan with dw asked into shared memory,
# plan with it kept in global memory): rcv1-like rows (548 wide, d 47 236),
# the demo's (283, d 9947), the demo's padded-CSC lasso columns (1738
# values, d = n = 2000), the rcv1-like hybrid at --hotCols=auto (a
# 174-wide residual beside 5248 lanes: in registers in float32, past the
# float64 cap), the demo's (102 beside 896), the
# full-width demo panel (9984 lanes, past the register cap) and the
# columns of a tall lasso design (100 000 values, wider than a slot)
PLANS = [
    ("rcv1-like", 548, 47236, 0, 4, (True, 6, 548, False),
     (False, 7, 548, False)),
    ("rcv1-like", 548, 47236, 0, 8, (False, 7, 548, False),
     (False, 7, 548, False)),
    ("demo", 283, 9947, 0, 4, (True, 7, 283, False), (False, 7, 283, False)),
    ("demo", 283, 9947, 0, 8, (True, 7, 283, False), (False, 7, 283, False)),
    ("demo lasso columns", 1738, 2000, 0, 4, (True, 7, 1738, False),
     (False, 7, 1738, False)),
    ("demo lasso columns", 1738, 2000, 0, 8, (True, 6, 1738, False),
     (False, 6, 1738, False)),
    ("rcv1-like hybrid", 174, 47236, 5248, 4, (True, 7, 174, True),
     (False, 7, 174, True)),
    ("rcv1-like hybrid", 174, 47236, 5248, 8, (False, 7, 174, False),
     (False, 7, 174, False)),
    ("demo hybrid", 102, 9947, 896, 4, (True, 7, 102, True),
     (False, 7, 102, True)),
    ("demo full panel", 1, 9947, 9984, 4, (True, 7, 1, False),
     (False, 7, 1, False)),
    ("demo full panel", 1, 9947, 9984, 8, (True, 7, 1, False),
     (False, 7, 1, False)),
    ("tall lasso columns", 100000, 1024, 0, 4, (True, 7, 2688, False),
     (False, 7, 2752, False)),
    ("tall lasso columns", 100000, 1024, 0, 8, (True, 7, 1600, False),
     (False, 7, 1632, False)),
]


@pytest.mark.parametrize("name,width,d,n_hot,itemsize,in_smem,in_global",
                         PLANS, ids=[f"{p[0]}-f{p[4] * 8}" for p in PLANS])
def test_sparse_plan_at_main_shapes(name, width, d, n_hot, itemsize, in_smem,
                                    in_global):
    """Every plan fits the opt-in; the ring holds whole rows as deep as
    fit, or MAX_STAGES slots of the widest multiple of MIN_SLOT entries,
    and then the rows stream their tails (no width refused); the panel
    lanes are in registers up to the cap; dw_in_smem=False still stages."""
    for asked, want in ((True, in_smem), (False, in_global)):
        plan = sp.sparse_plan(width, d, itemsize, OPTIN, asked, None, n_hot)
        assert plan == want
        in_sm, stages, slot, regs = plan
        assert regs == (0 < n_hot <= sp.HOT_REGS[itemsize] * sp.PANEL_THREADS)
        assert 1 <= stages <= MAX
        used = sp.plan_bytes(d, n_hot, itemsize, in_sm, regs, stages, slot)
        assert used <= OPTIN
        if slot == width:
            assert stages == MAX or sp.plan_bytes(
                d, n_hot, itemsize, in_sm, regs, stages + 1, slot) > OPTIN
        else:
            assert slot % sp.MIN_SLOT == 0 and sp.MIN_SLOT <= slot < width
            assert stages == MAX
            assert sp.plan_bytes(d, n_hot, itemsize, in_sm, regs, stages,
                                 slot + sp.MIN_SLOT) > OPTIN
    # which widths stream: only the tall design's columns
    assert (in_smem[2] < width) == (name == "tall lasso columns")


def test_sparse_plan_explicit_stages_and_refusals():
    plan = sp.sparse_plan
    # rcv1-like float32: whole rows up to six slots beside dw_k; seven
    # slots are 512 wide, and the few longer rows read their tails
    for s in range(1, 7):
        assert plan(548, 47236, 4, OPTIN, stages=s) == (True, s, 548, False)
    assert plan(548, 47236, 4, OPTIN, stages=7) == (True, 7, 512, False)
    assert plan(548, 47236, 4, OPTIN, False, 7) == (False, 7, 548, False)
    assert plan(174, 47236, 4, OPTIN, stages=1, n_hot=5248) == \
        (True, 1, 174, True)
    # an opt-in that holds five MIN_SLOT-wide slots but not seven
    small = 5 * sp.slot_bytes(sp.MIN_SLOT, 4) + 8
    assert plan(548, 100, 4, small, False, 5) == (False, 5, 32, False)
    # dw_k (400 bytes) stays beside one slot of (small - 400 - 24) // 12
    # entries, cut to a multiple of MIN_SLOT
    assert plan(548, 100, 4, small, True, 1) == (True, 1, 128, False)
    with pytest.raises(ValueError, match="cannot stage 7 slots"):
        plan(548, 100, 4, small, False, 7)
    with pytest.raises(ValueError, match="cannot stage auto slots"):
        plan(548, 100, 4, small)
    for bad in (0, MAX + 1, -1, 2.0, True, "3"):
        with pytest.raises(ValueError, match="stages must be an int"):
            plan(548, 47236, 4, OPTIN, stages=bad)


def test_plan_bytes_match_the_kernel():
    """The plan's constants and byte count are the kernel's, read from the
    source; no __syncthreads sits in a step loop."""
    src = kernels.SOURCES["sparse_sdca"].read_text()
    assert f"kMaxStages = {MAX};" in src
    assert f"kMinSlot = {sp.MIN_SLOT};" in src
    assert f"kPanelThreads = {sp.PANEL_THREADS};" in src
    assert (f"kHotRegs = sizeof(T) == 4 ? {sp.HOT_REGS[4]} : "
            f"{sp.HOT_REGS[8]};") in src
    assert "kReduce = 2 * (kPanelWarps + 4);" in src
    assert sp.REDUCE_SLOTS == 2 * (sp.PANEL_THREADS // 32 + 4)
    assert "return (size_t)slot * (2 * itemsize + 4) + 3 * itemsize + 12;" \
        in src
    assert ("state_in_smem ? (size_t)d + (n_hot > 0 && !hot_in_regs ? "
            "n_hot : 0) : 0;") in src
    assert ("return ((n_hot > 0 ? kReduce : 0) + state) * itemsize +\n"
            "         (size_t)stages * slot_bytes(slot, itemsize);") in src
    assert sp.slot_bytes(548, 4) == 548 * 12 + 24
    assert sp.plan_bytes(47236, 0, 4, True, False, 6, 548) == \
        47236 * 4 + 6 * (548 * 12 + 24)
    assert sp.plan_bytes(9947, 9984, 8, True, False, 7, 1) == \
        (40 + 9947 + 9984) * 8 + 7 * (20 + 36)
    assert sp.plan_bytes(47236, 5248, 4, True, True, 7, 174) == \
        (40 + 47236) * 4 + 7 * (174 * 12 + 24)
    # each kernel's two __syncthreads: after the zeroing, before the write
    assert src.count("__syncthreads()") == 4
    # two named barriers a slot beside __syncthreads' 0 and the step's 15
    assert 2 * MAX < 15


def _entry_arity(src, name):
    sig = re.search(rf'extern "C" int {name}\((.*?)\)', src, re.S).group(1)
    return sig.count(",") + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("hybrid", [False, True])
def test_wrapper_passes_the_plan(monkeypatch, dtype, hybrid):
    """With the device rule pointed at the kernel, the wrapper computes
    the plan and calls the C entry point with as many arguments as the
    source declares, the plan's in its place; the plan is not replaced."""
    k, n_shard, width, d, h, n_hot = 2, 6, 5, 40, 9, 600
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
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(sp, "_library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Null())
    rng = np.random.default_rng(0)
    t = lambda *s: torch.as_tensor(rng.random(s)).to(dtype)  # noqa: E731
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32)  # noqa: E731
    hot = dict(hot_cols=i32(rng.integers(0, d, (k, n_hot))),
               hot_panel=t(k, n_shard, n_hot)) if hybrid else {}
    before = (sp.sparse_sdca_round.launches,
              sp.sparse_sdca_round.hybrid_launches)
    sp.sparse_sdca_round(
        t(d), t(k, n_shard), i32(rng.integers(0, d, (k, n_shard, width))),
        t(k, n_shard, width), t(k, n_shard), t(k, n_shard),
        i32(rng.integers(0, n_shard, (k, h))), LAM, 12, stages=3,
        dw_in_smem=False, **hot)
    (name, args), = calls
    itemsize = 8 if dtype == torch.float64 else 4
    assert name == (sp._HYBRID_FN if hybrid else sp._FN)[dtype]
    assert len(args) == _entry_arity(
        kernels.SOURCES["sparse_sdca"].read_text(), name)
    plan = sp.sparse_plan(width, d, itemsize, OPTIN, False, 3,
                          n_hot if hybrid else 0)
    assert plan == (False, 3, width, hybrid)
    tail = args[-5:-1] if hybrid else args[-4:-1]
    assert tail == ((0, 3, width, 1) if hybrid else (0, 3, width))
    after = (sp.sparse_sdca_round.launches,
             sp.sparse_sdca_round.hybrid_launches)
    assert after == (before[0] + (not hybrid), before[1] + hybrid)
    sp.sparse_sdca_round.launches, sp.sparse_sdca_round.hybrid_launches = \
        before


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# --------------------------------------------------------------------------
# the ring: S producers, one consumer, alpha forwarded from registers
# --------------------------------------------------------------------------


def window_repeats(idxs, span):
    """chip_smoke.py window_repeats' pattern: step t = 3 mod 4 redraws the
    row of step t - g, g cycling over 2..span-1."""
    out = idxs.copy()
    gaps = range(2, span)
    for j, t in enumerate(range(3, out.shape[1], 4)):
        g = gaps[j % len(gaps)]
        if t >= g:
            out[:, t] = out[:, t - g]
    return out


def _draws(stages, h, n_rows, seed):
    """Draws with repeats at distance 1 (chip_smoke.py round_inputs: every
    fourth step redraws the step before it) and at 2..S+2."""
    rng = np.random.default_rng(seed)
    idxs = rng.integers(0, n_rows, (1, h))
    idxs[:, 1::4] = idxs[:, 0::4][:, :idxs[:, 1::4].shape[1]]
    return window_repeats(idxs, stages + 3)[0]


def _forward(hist_i, hist_a, step, i, staged, stages):
    """The consumer's choice (csrc/sparse_sdca.cu consume): lane l holds
    the row and a' of the last step t = l mod 32; the newest of the last
    S - 1 steps that drew row i wins over the staged value."""
    backs = [(step - 1 - lane) & 31 for lane in range(32)]
    hits = [b for lane, b in enumerate(backs)
            if hist_i[lane] == i and b < stages - 1]
    if not hits:
        return staged
    return hist_a[(step - 1 - min(hits)) & 31]


def _ring_walk(draws, stages, n_rows, seed, stale_first):
    """One interleaving of the producers and the consumer, picked at
    random among the moves the named barriers allow.  A producer's read of
    alpha sees any version written from its slot's last release on
    (``stale_first``: the oldest such).  Returns the alphas the consumer
    used, the sequential ones, and how many staged values were stale."""
    h = len(draws)
    rnd = random.Random(seed)
    writes = {r: [(-h - 1, 0.25 + r / (4 * n_rows))] for r in range(n_rows)}
    seq = {r: v[0][1] for r, v in writes.items()}
    full = [None] * stages          # the step a slot holds, once filled
    held = {}                       # slot -> (step, row, staged alpha)
    released = [True] * stages      # empty: may be refilled
    nxt = list(range(stages))       # each producer's next step
    hist_i, hist_a = [-1] * 32, [0.0] * 32
    used, want, stale, step = [], [], 0, 0
    while step < h:
        moves = ["consume"] if full[step % stages] == step else []
        moves += [p for p in range(stages) if nxt[p] < h and released[p]]
        move = rnd.choice(moves)
        if move == "consume":
            p = step % stages
            s, i, staged = held[p]
            assert s == step, "a slot read before its step was filled"
            a = _forward(hist_i, hist_a, step, i, staged, stages)
            used.append(a)
            want.append(seq[i])
            stale += staged != seq[i]
            new_a = 0.5 * a + (step + 1) / (2 * h)
            seq[i] = 0.5 * seq[i] + (step + 1) / (2 * h)
            hist_i[step & 31], hist_a[step & 31] = i, new_a
            writes[i].append((step, new_a))
            full[p] = None
            released[p] = step + stages < h
            step += 1
        else:
            p = move
            assert released[p] and full[p] is None, \
                "a slot refilled before it was released"
            s = nxt[p]
            i = int(draws[s])
            # the versions a read after the release of step s - S may see
            oldest = max(j for j, (at, _) in enumerate(writes[i])
                         if at <= s - stages)
            versions = writes[i][oldest:]
            staged = versions[0][1] if stale_first else \
                rnd.choice(versions)[1]
            held[p] = (s, i, staged)
            full[p] = s
            released[p] = False
            nxt[p] = s + stages
    return used, want, stale


@pytest.mark.parametrize("stages", list(range(1, MAX + 1)))
def test_ring_forwards_every_repeat(stages):
    """Under draws with repeats at every distance from 1 to S + 2, every
    step's alpha equals the sequential read, whatever a staged read saw;
    every slot is read only after its step is filled and refilled only
    after it is released.  The staged value alone would be wrong for S >
    1 (the test would catch a kernel without forwarding)."""
    h, n_rows = 200, 23
    total_stale = 0
    for seed in range(6):
        draws = _draws(stages, h, n_rows, seed)
        dist = {t - u for t in range(h) for u in range(max(0, t - stages - 2),
                                                        t)
                if draws[t] == draws[u]}
        assert set(range(1, stages + 3)) <= dist
        for stale_first in (True, False):
            used, want, stale = _ring_walk(draws, stages, n_rows, seed,
                                           stale_first)
            assert used == want
            total_stale += stale
    assert (total_stale > 0) == (stages > 1)


# --------------------------------------------------------------------------
# the plain route: no plan, against the JAX kernel in interpret mode
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shards():
    data_j = jax_synth_sparse(160, 300, nnz_mean=12, seed=5)
    out = {}
    for n_hot in (0, N_HOT):
        ds_j = jax_shard(data_j, k=K, layout="sparse", dtype=jnp.float64,
                         hot_cols=n_hot)
        arrays = {f: np.asarray(v) for f, v in ds_j.shard_arrays().items()}
        out[n_hot] = (ds_j, interop.dataset_from_numpy(
            arrays, "sparse", ds_j.n, ds_j.num_features, device="cpu"))
    return out


def _round_args(ds_j, ds_t, seed=2):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=ds_j.num_features) * 0.1
    alpha = np.clip(rng.normal(size=(K, ds_j.n_shard)) * 0.3 + 0.3, 0, 1) \
        * np.asarray(ds_j.mask)
    idxs = sample_indices_per_shard(3, range(1, 2), H, ds_j.counts)[:, 0]
    idxs[:, 1::4] = idxs[:, 0::4][:, :idxs[:, 1::4].shape[1]]
    idxs = np.ascontiguousarray(window_repeats(idxs, MAX + 3))
    hot = {} if ds_t.X_hot is None else dict(hot_cols=ds_t.hot_cols,
                                             hot_panel=ds_t.X_hot)
    port = (torch.as_tensor(w), torch.as_tensor(alpha), ds_t.sp_indices,
            ds_t.sp_values, ds_t.labels, ds_t.sq_norms,
            torch.as_tensor(idxs, dtype=torch.int32), LAM, ds_j.n)
    return w, alpha, idxs, port, hot


@pytest.mark.parametrize("n_hot", [0, N_HOT])
def test_plain_route_ignores_the_plan(shards, n_hot):
    """On the CPU the plan does not exist: every valid depth and placement
    gives the plain version's result, with no launch, and that result is
    the JAX kernel's (interpret mode) on draws with repeats at every
    distance inside and past the deepest ring."""
    ds_j, ds_t = shards[n_hot]
    w, alpha, idxs, port, hot = _round_args(ds_j, ds_t)
    kw = dict(mode="plus", sigma=float(K), **hot)
    launches = (sp.sparse_sdca_round.launches,
                sp.sparse_sdca_round.hybrid_launches)
    want = sp.sparse_sdca_round(*port, **kw)
    for stages in range(1, MAX + 1):
        got = sp.sparse_sdca_round(*port, stages=stages, dw_in_smem=False,
                                   **kw)
        for g, x in zip(got, want):
            assert torch.equal(g, x)
    assert (sp.sparse_sdca_round.launches,
            sp.sparse_sdca_round.hybrid_launches) == launches
    sa = ds_j.shard_arrays()
    jax_hot = {} if not n_hot else dict(hot_cols=sa["hot_cols"],
                                        hot_panel=sa["X_hot"])
    dw_j, a_j = pallas_sparse_sdca_round(
        jnp.asarray(w), jnp.asarray(alpha), sa["sp_indices"],
        sa["sp_values"], sa["labels"], sa["sq_norms"], jnp.asarray(idxs),
        LAM, ds_j.n, mode="plus", sigma=float(K), interpret=True, **jax_hot)
    np.testing.assert_allclose(want[0].numpy(), np.asarray(dw_j), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(want[1].numpy(), np.asarray(a_j), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("stages", [0, -2, MAX + 1, 1.5, False, True])
@pytest.mark.parametrize("n_hot", [0, N_HOT])
def test_stages_refused_on_the_cpu_route(shards, stages, n_hot):
    ds_j, ds_t = shards[n_hot]
    *_, port, hot = _round_args(ds_j, ds_t)
    with pytest.raises(ValueError, match="stages must be an int"):
        sp.sparse_sdca_round(*port, stages=stages, **hot)
