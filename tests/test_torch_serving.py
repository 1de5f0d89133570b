"""The port's serving stack (cocoa_torch/serving/, ``--serve``) held
against the JAX package's (cocoa_tpu/serving/) on the CPU.

The same inputs, made with numpy from a seed and saved with
``cocoa_tpu.checkpoint.save``, go through both packages: the query
grammar and the buckets, the packed bf16/int8 words, ``dequantize`` and
the certificate bit for bit, the scorer's margins for every form, the hot
panel and the catalogue (each within 1e-5 of sum_j |w_j x_j| of JAX's,
with its sign where it exceeds that), the events, the TCP protocol line
for line, and every rejection of ``--serve``'s flags with the JAX CLI's
message and exit code.  Within the port, bit for bit: f32 serving against
``shard_margins``, a catalogue against solo servers (across a swap too),
the certificate fallback against an f32 control, and a swap against a
cold restart.
"""

import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import DEMO_NUM_FEATURES, SMALL_TEST, SMALL_TRAIN  # noqa: E402
from cocoa_tpu import checkpoint as jax_ckpt  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_tpu import serving as jax_serving  # noqa: E402
from cocoa_tpu.serving import quantize as jax_quantize  # noqa: E402
from cocoa_tpu.serving.watcher import \
    emit_model_swap as jax_emit_swap  # noqa: E402
from cocoa_tpu.telemetry import events as jax_events  # noqa: E402
from cocoa_torch import checkpoint, cli, serving  # noqa: E402
from cocoa_torch.data import load_libsvm  # noqa: E402
from cocoa_torch.ops import rows  # noqa: E402
from cocoa_torch.serving import quantize  # noqa: E402
from cocoa_torch.serving.watcher import emit_model_swap  # noqa: E402
from cocoa_torch.telemetry import events as tele_events  # noqa: E402
from cocoa_torch.telemetry import schema  # noqa: E402
from cocoa_torch.telemetry import tracing  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 24
HOT = np.array([2, 5, 7, 11], np.int64)
# the cross-package tolerance: of sum_j |w_j x_j|
REL = 1e-5


@pytest.fixture
def buses(tmp_path):
    """Both packages' buses armed, each on its own JSONL."""
    paths = (tmp_path / "jax.jsonl", tmp_path / "port.jsonl")
    for bus, path in zip((jax_events.get_bus(), tele_events.get_bus()),
                         paths):
        bus.reset()
        bus.configure(jsonl_path=str(path))
    yield paths
    jax_events.get_bus().reset()
    tele_events.get_bus().reset()


def _read(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _save(ck, w, round_t, gap=None):
    """A model written by the JAX package."""
    return jax_ckpt.save(str(ck), "CoCoA+", round_t,
                         np.asarray(w, np.float32), None, gap=gap)


def _queries(rng, n, max_nnz=8, d=D):
    out = []
    for _ in range(n):
        nnz = int(rng.integers(1, max_nnz + 1))
        idx = np.sort(rng.choice(d, size=nnz, replace=False)).astype(np.int32)
        out.append((idx, rng.standard_normal(nnz)))
    return out


def _port_stack(ck, sd="f32", hot_ids=None, buckets=(4, 16), n_tenants=None,
                calibration=None, flip_guard=None, batcher=False):
    w, info = serving.load_model(checkpoint.latest(str(ck), "CoCoA+"))
    slots = serving.ModelSlots(w, info, dtype=sd, calibration=calibration,
                               flip_guard=flip_guard, device="cpu")
    scorer = serving.BatchScorer(D, dtype=sd, buckets=buckets, max_nnz=8,
                                 hot_ids=hot_ids, n_tenants=n_tenants,
                                 device="cpu")
    w_dev, scale, _, form = slots.current()
    scorer.warmup(w_dev, scale, form)
    if not batcher:
        return slots, scorer
    return slots, scorer, serving.MicroBatcher(scorer, slots, sla_s=0.01,
                                               algorithm="CoCoA+",
                                               calibration=calibration)


def _jax_stack(ck, sd="f32", hot_ids=None, buckets=(4, 16), n_tenants=None,
               calibration=None, flip_guard=None, batcher=False):
    w, info = jax_serving.load_model(jax_ckpt.latest(str(ck), "CoCoA+"))
    slots = jax_serving.ModelSlots(w, info, dtype=sd,
                                   calibration=calibration,
                                   flip_guard=flip_guard)
    scorer = jax_serving.BatchScorer(D, dtype=sd, buckets=buckets,
                                     max_nnz=8, hot_ids=hot_ids,
                                     n_tenants=n_tenants)
    scorer.warmup(slots.current()[0], slots.current()[1])
    if not batcher:
        return slots, scorer
    return slots, scorer, jax_serving.MicroBatcher(
        scorer, slots, sla_s=0.01, algorithm="CoCoA+",
        calibration=calibration)


def _port_score(slots, scorer, queries, bucket, tenants=None):
    w_dev, scale, _, form = slots.current()
    idx, val, hot = scorer.assemble(queries, bucket)
    tenant = (None if tenants is None
              else scorer.assemble_tenants(tenants, bucket))
    return scorer.score(w_dev, idx, val, hot, scale, tenant, form).numpy()


def _jax_score(slots, scorer, queries, bucket, tenants=None):
    w_dev, scale, _ = slots.current()
    idx, val, hot = scorer.assemble(queries, bucket)
    tenant = (None if tenants is None
              else scorer.assemble_tenants(tenants, bucket))
    return np.asarray(scorer.score(w_dev, idx, val, hot, scale, tenant))


def _hold(port, want, w_served, queries, tenants=None):
    """Each margin within REL of sum_j |w_j x_j| of JAX's, with its sign
    wherever |margin| exceeds that bound."""
    for r, (qi, qv) in enumerate(queries):
        w = w_served if tenants is None else w_served[tenants[r]]
        bound = REL * float(np.abs(np.asarray(w, np.float64)[qi]
                                   * np.float32(qv)).sum())
        assert abs(float(port[r]) - float(want[r])) <= bound, (r, port[r],
                                                                want[r])
        if abs(float(want[r])) > bound:
            assert np.sign(port[r]) == np.sign(want[r])


# --- the query grammar and the buckets ---------------------------------------


@pytest.mark.parametrize("line", [
    "1:0.5 3:-2 24:1e-3", "24:1", "  2:1   5:+3.5  ", "25:1.0", "0:1",
    "3:", "x:1", "3:abc", "1:1 2:1 3:1", "", "   ", "2:1 2:3"])
def test_parse_query_matches_jax(line):
    outs = []
    for parse in (serving.parse_query, jax_serving.parse_query):
        try:
            idx, val = parse(line, D, 2 if line.startswith("1:1 2:1") else 8)
            outs.append((idx.dtype, idx.tolist(), val.dtype, val.tolist()))
        except ValueError as e:
            outs.append((type(e).__name__, str(e)))
    assert outs[0] == outs[1]


def test_pick_bucket_matches_jax():
    buckets = (4, 16, 64)
    for n in range(1, 65):
        assert serving.pick_bucket(n, buckets) == \
            jax_serving.pick_bucket(n, buckets)
    with pytest.raises(ValueError) as a:
        serving.pick_bucket(65, buckets)
    with pytest.raises(ValueError) as b:
        jax_serving.pick_bucket(65, buckets)
    assert str(a.value) == str(b.value)


# --- the packed forms --------------------------------------------------------


def _edge_floats():
    """Ties, +-0, subnormals, the largest finite floats and a random
    spread, as float32."""
    bits = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x00008000,
                     0x00018000, 0x00000001, 0x80000001, 0x007FFFFF,
                     0x807FFFFF, 0x00000000, 0x80000000, 0x7F7FFFFF,
                     0xFF7FFFFF, 0x7F7F8000, 0x7F7F7FFF, 0x3F800001],
                    np.uint32)
    rng = np.random.default_rng(1)
    spread = (rng.standard_normal(1001)
              * np.exp(rng.uniform(-30, 30, 1001))).astype(np.float32)
    return np.concatenate([bits.view(np.float32), spread])


@pytest.mark.parametrize("sd", ["bf16", "int8"])
def test_packed_words_dequantize_and_bound_bit_for_bit(sd):
    w = _edge_floats()
    if sd == "int8":   # the int8 scale of a model with infinities is NaN
        w = w[np.isfinite(w)]
    for x in (w, w[:1001], w[:7]):
        mine, theirs = quantize.quantize(x, sd), jax_quantize.quantize(x, sd)
        assert mine.packed.dtype == theirs.packed.dtype
        assert np.array_equal(mine.packed, theirs.packed)
        assert mine.scale == theirs.scale
        dq = quantize.dequantize(mine, x.size)
        assert np.array_equal(dq.view(np.uint32),
                              jax_quantize.dequantize(theirs, x.size)
                              .view(np.uint32))
    finite = np.nan_to_num(w, posinf=0, neginf=0)[:D]
    qs = [(q.astype(np.int32), v) for q, v in _queries(
        np.random.default_rng(2), 40)]
    wq = quantize.dequantize(quantize.quantize(finite, sd), D)
    assert quantize.margin_error_bound(finite, wq, qs) == \
        jax_quantize.margin_error_bound(finite, wq, qs)


@pytest.mark.parametrize("sd", ["bf16", "int8"])
def test_gather_dequant_is_dequantize(sd):
    """Every lane the scoring path widens is the dequantized model's."""
    w = np.random.default_rng(3).standard_normal(37).astype(np.float32)
    qm = quantize.quantize(w, sd)
    words = quantize.device_words(qm, "cpu")
    idx = torch.arange(37)
    got = rows.gather_dequant(words, idx, sd)
    if sd == "int8":
        got = got * float(qm.scale)
    assert torch.equal(got, torch.from_numpy(quantize.dequantize(qm, 37)))


def test_resolve_serve_dtype_matches_jax():
    for spelling in ("f32", "float32", "BF16", "bfloat16", "int8",
                     np.float32, None):
        assert quantize.resolve_serve_dtype(spelling) == \
            jax_quantize.resolve_serve_dtype(spelling)
    with pytest.raises(ValueError) as a:
        quantize.resolve_serve_dtype("fp16")
    with pytest.raises(ValueError) as b:
        jax_quantize.resolve_serve_dtype("fp16")
    assert str(a.value) == str(b.value)


# --- the scorer against JAX's ----------------------------------------------


@pytest.mark.parametrize("hot", [False, True], ids=["plain", "hot"])
@pytest.mark.parametrize("sd", ["f32", "bf16", "int8"])
def test_scorer_margins_match_jax(tmp_path, sd, hot):
    rng = np.random.default_rng(4)
    w32 = rng.standard_normal(D).astype(np.float32)
    _save(tmp_path, w32, 10)
    hot_ids = HOT if hot else None
    port = _port_stack(tmp_path, sd, hot_ids)
    jax = _jax_stack(tmp_path, sd, hot_ids)
    assert port[0].served_dtype == jax[0].served_dtype == sd
    # a query repeating a hot id: the panel sums the duplicates
    queries = _queries(rng, 11) + [(np.array([2, 2, 9], np.int32),
                                    np.array([1.0, 2.0, -1.5]))]
    for n in (1, 4, 12):
        bucket = serving.pick_bucket(n, port[1].buckets)
        for a, b in zip(port[1].assemble(queries[:n], bucket),
                        jax[1].assemble(queries[:n], bucket)):
            assert (a is None and b is None) or np.array_equal(a, b)
        got = _port_score(*port, queries[:n], bucket)
        want = _jax_score(*jax, queries[:n], bucket)
        assert got.shape == want.shape == (bucket,)
        assert np.all(got[n:] == 0)
        wq = quantize.dequantize(quantize.quantize(w32, sd), D)
        _hold(got, want, wq, queries[:n])


def test_catalogue_margins_match_jax(tmp_path):
    T = 3
    rng = np.random.default_rng(5)
    W = rng.standard_normal((T, D)).astype(np.float32)
    _save(tmp_path, W, 10)
    port = _port_stack(tmp_path, n_tenants=T)
    jax = _jax_stack(tmp_path, n_tenants=T)
    queries = _queries(rng, 9)
    tenants = [int(t) for t in rng.integers(0, T, 9)]
    got = _port_score(*port, queries, 16, tenants)
    want = _jax_score(*jax, queries, 16, tenants)
    _hold(got, want, W, queries, tenants)


def test_scorer_rejections(tmp_path):
    """Form, scale and tenant mismatches are refused with the numbers."""
    w32 = np.random.default_rng(6).standard_normal(D).astype(np.float32)
    _save(tmp_path, w32, 10)
    slots, scorer = _port_stack(tmp_path, "int8")
    idx, val, hot = scorer.assemble([], 4)
    w_dev, scale, _, form = slots.current()
    with pytest.raises(serving.QueryError, match=r"form mismatch.*int8"):
        scorer.score(w_dev, idx, val, hot, scale, None, "bf16")
    with pytest.raises(serving.QueryError, match=r"form mismatch.*\(24,\)"):
        scorer.score(torch.zeros(20), idx, val, hot, None, None, "f32")
    with pytest.raises(serving.QueryError, match="scale mismatch"):
        scorer.score(w_dev, idx, val, hot, None, None, form)
    with pytest.raises(serving.QueryError, match="scale mismatch"):
        scorer.score(torch.zeros(D), idx, val, hot, 1.0, None, "f32")
    with pytest.raises(serving.QueryError, match="single model"):
        scorer.score(w_dev, idx, val, hot, scale, np.zeros(4, np.int32),
                     form)
    _save(tmp_path / "cat", np.zeros((2, D), np.float32), 7)
    cslots, cscorer = _port_stack(tmp_path / "cat", n_tenants=2)
    with pytest.raises(serving.QueryError, match="catalogue of 2"):
        cscorer.score(cslots.current()[0], idx, val, None, None, None)
    with pytest.raises(ValueError, match="serve dtype mismatch"):
        serving.MicroBatcher(scorer, cslots)
    with pytest.raises(serving.QueryError, match=r"\(12,\).*\(24,\)"):
        slots.swap(np.zeros(12, np.float32), slots.info._replace(seq=1))


# --- bit for bit within the port ---------------------------------------------


@pytest.mark.parametrize("hot", [False, True], ids=["plain", "hot"])
def test_f32_serving_is_shard_margins_bit_for_bit(tmp_path, hot):
    """An f32 model with no scale gives the evaluator's margins: the batch
    taken as one shard of shard_margins' layout."""
    rng = np.random.default_rng(7)
    w32 = rng.standard_normal(D).astype(np.float32)
    _save(tmp_path, w32, 10)
    slots, scorer = _port_stack(tmp_path, hot_ids=HOT if hot else None)
    queries = _queries(rng, 13)
    idx, val, hot_panel = scorer.assemble(queries, 16)
    got = _port_score(slots, scorer, queries, 16)
    shard = {"sp_indices": torch.from_numpy(idx)[None],
             "sp_values": torch.from_numpy(val)[None]}
    if hot:
        shard["X_hot"] = torch.from_numpy(hot_panel)[None]
        shard["hot_cols"] = torch.from_numpy(HOT)[None]
    want = rows.shard_margins(torch.from_numpy(w32), shard)[0]
    assert torch.equal(torch.from_numpy(got), want)


def test_catalogue_is_solo_servers_bit_for_bit_across_a_swap(tmp_path):
    T = 3
    rng = np.random.default_rng(8)
    W1 = rng.standard_normal((T, D)).astype(np.float32)
    _save(tmp_path / "cat", W1, 10, gap=1e-3)
    for t in range(T):
        _save(tmp_path / f"solo{t}", W1[t], 10, gap=1e-3)
    cat = _port_stack(tmp_path / "cat", n_tenants=T, batcher=True)
    solos = [_port_stack(tmp_path / f"solo{t}", batcher=True)
             for t in range(T)]
    queries = _queries(rng, 6)

    def compare_all():
        for t in range(T):
            for qi, qv in queries:
                a = cat[2].score_sync(qi, qv, timeout=10.0, tenant=t)
                b = solos[t][2].score_sync(qi, qv, timeout=10.0)
                assert a == b, (t, a, b)
            tenants = [t] * len(queries)
            assert np.array_equal(
                _port_score(*cat[:2], queries, 16, tenants),
                _port_score(*solos[t][:2], queries, 16))

    try:
        compare_all()
        W2 = (W1 * 0.7 + 1.0).astype(np.float32)
        _save(tmp_path / "cat", W2, 20, gap=1e-4)
        assert serving.SwapWatcher(cat[0], str(tmp_path / "cat"),
                                   "CoCoA+").poll_once()
        for t in range(T):
            _save(tmp_path / f"solo{t}", W2[t], 20, gap=1e-4)
            assert serving.SwapWatcher(solos[t][0],
                                       str(tmp_path / f"solo{t}"),
                                       "CoCoA+").poll_once()
        compare_all()
    finally:
        for s in [cat] + solos:
            s[2].stop()


@pytest.mark.parametrize("sd", ["bf16", "int8"])
def test_forced_fallback_is_f32_control_bit_for_bit(tmp_path, sd):
    rng = np.random.default_rng(9)
    w32 = rng.standard_normal(D).astype(np.float32)
    _save(tmp_path, w32, 10)
    calib = serving.CalibrationBuffer(D, max_nnz=8, seed=3)
    slots, scorer = _port_stack(tmp_path, sd, calibration=calib,
                                flip_guard=0.0)
    assert slots.served_dtype == "f32" and slots.fallbacks_total == 1
    w_dev, scale, _, form = slots.current()
    assert scale is None and form == "f32" and w_dev.dtype == torch.float32
    ctrl = _port_stack(tmp_path)
    queries = _queries(rng, 7)
    assert np.array_equal(_port_score(slots, scorer, queries, 16),
                          _port_score(*ctrl, queries, 16))
    jslots, _ = _jax_stack(tmp_path, sd, calibration=jax_serving
                           .CalibrationBuffer(D, max_nnz=8, seed=3),
                           flip_guard=0.0)
    assert jslots.last_bound == slots.last_bound


def test_swap_is_cold_restart_bit_for_bit(tmp_path, buses):
    rng = np.random.default_rng(10)
    w = rng.standard_normal(D).astype(np.float32)
    _save(tmp_path, w, 10, gap=1e-3)
    slots, scorer = _port_stack(tmp_path, "int8")
    watcher = serving.SwapWatcher(slots, str(tmp_path), "CoCoA+")
    queries = _queries(rng, 5)
    for gen in range(3):
        w = (w * 0.7 + gen).astype(np.float32)
        _save(tmp_path, w, 20 + 10 * gen, gap=1e-4)
        assert watcher.poll_once()
    assert watcher.swaps_total == 3 and slots.info.round == 40
    cold = _port_stack(tmp_path, "int8")
    assert np.array_equal(_port_score(slots, scorer, queries, 16),
                          _port_score(*cold, queries, 16))
    # the model_quantize events: one a publish, as JAX's
    quant = [e for e in _read(buses[1]) if e["event"] == "model_quantize"]
    assert [e["swap_seq"] for e in quant] == [0, 1, 2, 3, 0]
    assert all(e["served"] == "int8" and e["fallback"] == 0 for e in quant)


@pytest.mark.parametrize("sd", ["bf16", "int8"])
def test_model_quantize_events_match_jax(tmp_path, buses, sd):
    """The certificate's events, a load and a swap, with the JAX
    package's bound, scale, flips and fallback, bit for bit."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal(D).astype(np.float32)
    _save(tmp_path, w, 10)
    qs = _queries(rng, 30)
    stacks = []
    for make, calib in ((_port_stack, serving.CalibrationBuffer),
                        (_jax_stack, jax_serving.CalibrationBuffer)):
        buf = calib(D, max_nnz=8, seed=4)
        for qi, qv in qs:
            buf.record(qi, qv)
        stacks.append(make(tmp_path, sd, calibration=buf))
    _save(tmp_path, w * 0.5, 20)
    for slots, watch in ((stacks[0][0], serving.SwapWatcher),
                         (stacks[1][0], jax_serving.SwapWatcher)):
        assert watch(slots, str(tmp_path), "CoCoA+").poll_once()
    keys = ("algorithm", "serve_dtype", "served", "round", "swap_seq",
            "bound", "calib_n", "flips", "fallback", "scale")
    ev = [[{k: e[k] for k in keys} for e in _read(p)
           if e["event"] == "model_quantize"] for p in buses]
    assert ev[1] == ev[0] and len(ev[0]) == 2


# --- the batcher, the watcher ------------------------------------------------


def test_batcher_one_fetch_per_request_batch(tmp_path, buses):
    w = np.arange(D, dtype=np.float32)
    _save(tmp_path, w, 5, gap=2e-3)
    tracing.configure(enabled=True, worker=0)
    try:
        slots, scorer, batcher = _port_stack(tmp_path, batcher=True)
        queries = _queries(np.random.default_rng(12), 20)
        pendings = [batcher.submit(qi, qv) for qi, qv in queries]
        for (qi, qv), p in zip(queries, pendings):
            m = p.result(timeout=10.0)
            want = float((w.astype(np.float64)[qi]
                          * np.float32(qv).astype(np.float64)).sum())
            assert abs(m - want) <= REL * max(1.0, abs(want))
            assert p.model_round == 5 and p.served_dtype == "f32"
        for _ in range(3):
            batcher.score_sync(np.array([0], np.int32), np.array([1.0]),
                               timeout=10.0)
        batcher.stop()
    finally:
        tracing.reset()
    recs = _read(buses[1])
    fetches = [r for r in recs if r["event"] == "host_transfer"]
    batches = [r for r in recs if r["event"] == "serve_request"]
    assert all(r["label"] == "serve_fetch" for r in fetches)
    assert len(fetches) == len(batches) == batcher.batches_total \
        == batcher.fetches_total >= 4
    assert sum(r["n"] for r in batches) == 23
    for r in batches:
        assert r["bucket"] in scorer.buckets and 0 < r["fill_ratio"] <= 1
        assert r["latency_max_s"] >= r["latency_mean_s"] > 0
        assert r["model_round"] == 5
    phases = {r["phase"] for r in recs if r["event"] == "span"}
    assert {"serve_admit", "serve_score"} <= phases
    assert schema.check_file(str(buses[1])) == []


def test_watcher_swap_and_gap_age_match_jax(tmp_path, buses):
    w = np.zeros(D, np.float32)
    _save(tmp_path, w, 10, gap=1e-2)
    port = _port_stack(tmp_path)
    jax = _jax_stack(tmp_path)
    emit_model_swap("CoCoA+", port[0].info)
    jax_emit_swap("CoCoA+", jax[0].info)
    age0 = port[0].gap_age_s()
    assert age0 >= 0.0
    _save(tmp_path, w + 1, 20, gap=1e-3)
    watchers = (serving.SwapWatcher(port[0], str(tmp_path), "CoCoA+"),
                jax_serving.SwapWatcher(jax[0], str(tmp_path), "CoCoA+"))
    assert all(wt.poll_once() for wt in watchers)
    assert not any(wt.poll_once() for wt in watchers)
    assert port[0].info == jax[0].info
    assert port[0].info.round == 20 and port[0].info.gap == 1e-3
    assert port[0].gap_age_s() <= age0 + 1.0
    keys = ("algorithm", "round", "path", "birth_ts", "gap", "swap_seq",
            "tenant_gaps", "tenant_cert_ts")
    ev = [[{k: e[k] for k in keys} for e in _read(p)
           if e["event"] == "model_swap"] for p in buses]
    assert ev[0] == ev[1] and len(ev[0]) == 2
    assert schema.check_file(str(buses[1])) == []
    # a width change is refused once, loudly, and not retried
    jax_ckpt.save(str(tmp_path), "CoCoA+", 30, np.zeros(12, np.float32))
    assert not watchers[0].poll_once() and not watchers[0].poll_once()
    assert watchers[0].rejected_total == 1 and port[0].info.round == 20


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_catalogue_meta_cross_reads(tmp_path, writer):
    """A (T, d) catalogue's per-tenant meta, written by either package,
    is read by the other's load_model."""
    W = np.arange(3 * D, dtype=np.float32).reshape(3, D)
    gaps, ts = [1e-3, 2e-3, 3e-3], [100.0, 200.5, 300.25]
    save = jax_ckpt.save if writer == "jax" else checkpoint.save
    save(str(tmp_path), "CoCoA+", 9, W, None, gap=1e-3, tenant_gaps=gaps,
         tenant_cert_ts=ts)
    for load, latest in ((serving.load_model, checkpoint.latest),
                         (jax_serving.load_model, jax_ckpt.latest)):
        w, info = load(latest(str(tmp_path), "CoCoA+"))
        assert np.array_equal(np.asarray(w), W)
        assert info.tenant_gaps == tuple(gaps)
        assert info.tenant_cert_ts == tuple(ts)
    with pytest.raises(ValueError, match="one entry per tenant row"):
        checkpoint.save(str(tmp_path), "CoCoA+", 10, W, tenant_gaps=[1.0],
                        tenant_cert_ts=[1.0])
    with pytest.raises(ValueError, match="only ride a stacked"):
        checkpoint.save(str(tmp_path), "CoCoA+", 10, W[0],
                        tenant_gaps=[1.0], tenant_cert_ts=[1.0])


# --- the TCP protocol --------------------------------------------------------


LINES = ["1:1.0;3:2.0;99:1.0", "2:1.5", "5:1 5:2 8:-1", "0:1", "3:",
         ";", "1:1;;2:2", "tenant=1;2:1", "trace=ab;2:1.0;4:2",
         "trace=XY;2:1", "trace=ab", "trace=ab:12;2:1", "trace=ab:zz;2:1",
         "1:1 2:1 3:1 4:1 5:1 6:1 7:1 8:1 9:1", "7:0.25"]


def _serve(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _converse(addr, lines):
    with socket.create_connection(addr, timeout=10) as s:
        f = s.makefile("rwb")
        out = []
        for line in lines + ["shutdown"]:
            f.write((line + "\n").encode())
            f.flush()
            out.append(json.loads(f.readline()))
        return out


def _entries(resp):
    return resp if isinstance(resp, list) else [resp]


def _line_queries(line):
    """The queries a server parses out of ``line`` (None where the query
    is rejected), its trace and tenant prefixes peeled."""
    for prefix in ("trace=", "tenant="):
        if line.startswith(prefix) and ";" in line:
            line = line.partition(";")[2]
    out = []
    for text in (t for t in line.split(";") if t.strip()):
        try:
            out.append(serving.parse_query(text, D, 8))
        except ValueError:
            out.append(None)
    return out


def _same_lines(lines, got, want, w_served):
    """Key by key: errors, rounds, dtypes, tenants and the trace object's
    id, bucket, round and dtype equal; margins held by :func:`_hold`."""
    for line, a, b in zip(lines + ["shutdown"], got, want):
        assert type(a) is type(b), line
        ea, eb = _entries(a), _entries(b)
        assert len(ea) == len(eb), line
        for x, y in zip(ea, eb):
            assert set(x) == set(y), line
            for k in y:
                if k == "trace":
                    assert set(x[k]) == set(y[k])
                    for key in ("id", "bucket", "round", "dtype"):
                        assert x[k][key] == y[k][key], (line, key)
                elif k != "margin":
                    assert x[k] == y[k], (line, k)
        if line != "shutdown" and any("margin" in y for y in eb):
            qs = _line_queries(line)
            held = [(q, x["margin"], y["margin"]) for q, x, y in
                    zip(qs, ea, eb) if "margin" in y]
            tenants = [y.get("tenant") for y in eb if "margin" in y]
            _hold([h[1] for h in held], [h[2] for h in held], w_served,
                  [h[0] for h in held],
                  None if tenants[0] is None else tenants)


@pytest.mark.parametrize("sd", ["f32", "int8"])
def test_server_protocol_matches_jax_line_for_line(tmp_path, sd):
    rng = np.random.default_rng(13)
    w = rng.standard_normal(D).astype(np.float32)
    _save(tmp_path, w, 7)
    port = _port_stack(tmp_path, sd, batcher=True)
    jax = _jax_stack(tmp_path, sd, batcher=True)
    servers = [_serve(serving.MarginServer(port[2], D, 8, port=0,
                                           trace_sample=1)),
               _serve(jax_serving.MarginServer(jax[2], D, 8, port=0,
                                               trace_sample=1))]
    try:
        got, want = (_converse(srv.address, LINES) for srv in servers)
    finally:
        for srv in servers:
            srv.close()
        port[2].stop()
        jax[2].stop()
    _same_lines(LINES, got, want,
                quantize.dequantize(quantize.quantize(w, sd), D))


def test_catalogue_protocol_matches_jax(tmp_path):
    T = 3
    W = np.arange(T * D, dtype=np.float32).reshape(T, D) / 10
    _save(tmp_path, W, 7)
    port = _port_stack(tmp_path, n_tenants=T, batcher=True)
    jax = _jax_stack(tmp_path, n_tenants=T, batcher=True)
    lines = ["tenant=1;2:1.0", "2:1.0", "tenant=3;2:1.0", "tenant=x;2:1.0",
             "tenant=1", "tenant=2;2:1.0;99:1.0", "trace=ab;tenant=0;3:1"]
    servers = [_serve(serving.MarginServer(port[2], D, 8, port=0,
                                           n_tenants=T)),
               _serve(jax_serving.MarginServer(jax[2], D, 8, port=0,
                                               n_tenants=T))]
    try:
        got, want = (_converse(srv.address, lines) for srv in servers)
    finally:
        for srv in servers:
            srv.close()
        port[2].stop()
        jax[2].stop()
    _same_lines(lines, got, want, W)


# --- the CLI -----------------------------------------------------------------


def _cli_args(d):
    return [f"--chkptDir={d}", f"--numFeatures={D}"]


REJECTIONS = [
    ["--serveBatch=4"], ["--statusPort=0"], ["--traceSample=2"],
    ["--serveDtype=bf16", "--numRounds=3"],
    ["--serve", "CK", "--numRounds=5"],
    ["--serve", "CK", "--gapTarget=1e-3"],
    ["--serve", "CK", "--dtype=float64"],
    ["--serve", "CK", "--resume"],
    ["--serve", "CK", "--sigmaSchedule=trial", "--lambda=1"],
    ["--serve", f"--numFeatures={D}"],
    ["--serve", "CK", "--hotCols=auto"],
    ["--serve", "CK", "--serveReplicas=0"],
    ["--serve", "CK", "--serveReplicas=abc"],
    ["--serve", "CK", "--serveReplicas=2", "--serveRoute=bogus"],
    ["--serve", "CK", "--serveRoute=rr"],
    ["--serve", "CK", "--serveReplicas=2", "--hotCols=auto",
     f"--trainFile={SMALL_TRAIN}"],
    ["--serve", "--chkptDir=X"],
    ["--serve=abc", "CK"], ["--serve=70000", "CK"],
    ["--serve", "CK", "--serveBatch=0"],
    ["--serve", "CK", "--serveBatch=4,x"],
    ["--serve", "CK", "--serveSlaMs=-1"],
    ["--serve", "CK", "--serveDtype=fp16"],
    ["--serve", "CK", "--traceSample=-2"],
    ["--serve", "CK", "--statusPort=0"],
    ["--serve", "CK", "--statusPort=70000", "--metrics=m.prom"],
    ["--serve", "CK", "--serveMaxNnz=0"],
    ["--serve", "CK", "--hotCols=bogus", "TRAIN"],
    ["--serve", "CK", "--hotCols=auto", "--trainFile=missing.svm"],
    ["--serve", "CAT", "--serveDtype=bf16"],
    ["--serve", "CAT", "--hotCols=auto", "TRAIN"],
    ["--serve", "WIDE"],
    ["--serve", "CK", "--trace"],
]


@pytest.mark.parametrize("argv", REJECTIONS,
                         ids=[" ".join(a) for a in REJECTIONS])
def test_serve_rejections_match_jax_cli(tmp_path, capsys, argv):
    """The same stderr line and exit code as the JAX CLI (which has no
    --device; the port's takes --device=cpu on top)."""
    ck, cat, wide = tmp_path / "ck", tmp_path / "cat", tmp_path / "wide"
    _save(ck, np.ones(D, np.float32), 3)
    _save(cat, np.ones((2, D), np.float32), 3)
    _save(wide, np.ones(D - 4, np.float32), 3)
    train = tmp_path / "train.svm"
    rng = np.random.default_rng(14)
    train.write_text("".join(
        f"{1 if r % 2 else -1} " + " ".join(
            f"{c + 1}:{rng.standard_normal():.3f}" for c in
            sorted(rng.choice(D, 5, replace=False))) + "\n"
        for r in range(30)))
    sub = {"CK": _cli_args(ck), "CAT": _cli_args(cat),
           "WIDE": _cli_args(wide), "TRAIN": [f"--trainFile={train}"]}
    full = [x for a in argv for x in sub.get(a, [a])]
    full = [a.replace("m.prom", str(tmp_path / "m.prom")) for a in full]
    results = []
    for main, extra in ((jax_cli.main, []), (cli.main, ["--device=cpu"])):
        rc = main(full + extra)
        err = [ln for ln in capsys.readouterr().err.splitlines()
               if ln.startswith("error:")]
        results.append((rc, err))
    assert results[1] == results[0] and len(results[0][1]) == 1


def test_unported_flags_still_refused_beside_serve(capsys):
    for flag in cli._NOT_PORTED:
        assert cli.main(["--serve", f"--{flag}=1", "--device=cpu"]) == 2
        assert f"--{flag} is not yet ported" in capsys.readouterr().err
    assert not set(cli._SERVE_FLAGS) & set(cli._NOT_PORTED)
    assert len(cli._NOT_PORTED) == 5


def _spawn_server(argv):
    proc = subprocess.Popen(
        [sys.executable, "-m", "cocoa_torch.cli", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT)
    head = []
    for line in proc.stdout:
        head.append(line)
        if "listening on" in line:
            host, port = line.split("listening on ")[1].split()[0].split(":")
            return proc, (host, int(port)), head
    proc.wait(10)
    raise AssertionError("server never announced:\n" + "".join(head))


def test_cli_serves_jax_trained_demo_checkpoint(tmp_path, capsys):
    """The JAX CLI trains the demo for 4 rounds with checkpoints; the
    port's CLI serves the newest CoCoA+ generation on the CPU, and its
    margins are that model's w.x for the demo's test rows."""
    ck = tmp_path / "ck"
    assert jax_cli.main([f"--trainFile={SMALL_TRAIN}",
                         f"--numFeatures={DEMO_NUM_FEATURES}",
                         "--numSplits=4", "--numRounds=4", "--debugIter=2",
                         "--chkptIter=2", f"--chkptDir={ck}", "--mesh=1",
                         "--quiet", "--localIterFrac=0.1",
                         "--lambda=.001"]) == 0
    capsys.readouterr()
    path = jax_ckpt.latest(str(ck), "CoCoA+")
    w = np.asarray(jax_ckpt.load(path)[1], np.float64)
    test = load_libsvm(SMALL_TEST, DEMO_NUM_FEATURES)
    proc, addr, _ = _spawn_server([
        "--serve=0", f"--chkptDir={ck}", f"--numFeatures={DEMO_NUM_FEATURES}",
        "--device=cpu", "--serveBatch=16,64", "--quiet"])
    try:
        lines, want = [], []
        for r in range(40):
            lo, hi = test.indptr[r], test.indptr[r + 1]
            idx, val = test.indices[lo:hi], test.values[lo:hi]
            lines.append(" ".join(f"{i + 1}:{v!r}" for i, v in
                                  zip(idx.tolist(), val.tolist())))
            want.append((float((w[idx] * np.float32(val)).sum()),
                         float(np.abs(w[idx] * val).sum())))
        resp = _converse(addr, [";".join(lines[:20])] + lines[20:])
        got = resp[0] + resp[1:-1]
        assert resp[-1] == {"ok": "shutting down"}
        assert proc.wait(30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    for g, (m, scale) in zip(got, want):
        assert g["round"] == 4 and g["dtype"] == "f32"
        assert abs(g["margin"] - m) <= REL * scale + 1e-7
