#!/usr/bin/env python3
"""Probe of CUDA graph conditional nodes under PyTorch, on the card.

    python3 probe_conditional.py        # from the repository root, one GPU

The device-resident run (``--deviceLoop``, solvers/base.py
``DeviceLoopRunner``) captures each chunk of rounds behind IF nodes whose
predicates live in device memory: whether the run is still live, and
which branch the chunk runs.  This script prints what that rests on:

1. torch's version, the CUDA runtime it was built with and the driver's
   version, and whether torch exposes the conditional-node API
   (``CUDAGraph.get_currently_capturing_graph``,
   ``begin_capture_to_if_node``, ``end_capture_to_conditional_node``);
2. a nested IF (live, then branch) around one launch of the sparse SDCA
   kernel (B1, ctypes-launched on the current stream) and the torch ops
   that fold its result into static buffers, captured on a side stream
   into a graph pool as ``ChunkRunner`` captures, replayed with each
   predicate pair: the body runs only when both are true, and then equals
   an eager launch bit for bit;
3. a predicate computed inside the graph from a device counter that the
   graph itself advances (``live = i < n``), replayed past n: the counter
   stops at n;
4. the draw kernel inside an IF body, reading its first round from a
   device counter the graph advances;
5. the time of one replay whose IF bodies are all skipped, and of one
   whose body runs, by CUDA events.

Each check prints ``ok`` or the error it met; the last line is one JSON
object with the results.  :func:`probe` is what chip_smoke.py phase 14
calls.
"""

from __future__ import annotations

import ctypes
import json
import sys
import traceback

import torch


def versions() -> dict:
    """torch, its CUDA runtime, the driver, and the API's presence."""
    drv = None
    try:
        lib = ctypes.CDLL("libcuda.so.1")
        v = ctypes.c_int()
        if lib.cuDriverGetVersion(ctypes.byref(v)) == 0:
            drv = v.value
    except OSError:
        pass
    g = torch.cuda.CUDAGraph
    return {"torch": torch.__version__, "cuda_runtime": torch.version.cuda,
            "driver": drv,
            "api": all(hasattr(g, a) for a in (
                "get_currently_capturing_graph", "begin_capture_to_if_node",
                "end_capture_to_conditional_node"))}


class _If:
    """One IF node around the code in its ``with`` block, inside a
    capture."""

    def __init__(self, pred):
        self.pred = pred

    def __enter__(self):
        self.g = torch.cuda.CUDAGraph.get_currently_capturing_graph()
        self.g.begin_capture_to_if_node(self.pred)

    def __exit__(self, *exc):
        self.g.end_capture_to_conditional_node()
        return False


def _capture(fn, pool, stream):
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin(pool)
        try:
            fn()
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass
            raise
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    return graph


def probe() -> dict:
    from cocoa_torch.data import shard_dataset
    from cocoa_torch.data.synth import synth_sparse
    from cocoa_torch.ops.sparse_sdca import sparse_sdca_round
    from cocoa_torch.solvers import base
    from cocoa_torch.utils import prng

    out = versions()
    print(f"probe: torch {out['torch']}, CUDA runtime {out['cuda_runtime']}, "
          f"driver {out['driver']}, conditional-node API "
          f"{'present' if out['api'] else 'absent'}")
    if not out["api"]:
        return out
    dev = torch.device("cuda")
    ds = shard_dataset(synth_sparse(2000, 5000, nnz_mean=20, seed=0), 4,
                       layout="sparse", dtype=torch.float32, device=dev)
    h = 50
    w0 = torch.full((ds.num_features,), 0.01, device=dev)
    a0 = torch.full((ds.k, ds.n_shard), 0.2, device=dev) * ds.mask
    idxs = base.IndexSampler("reference", 0, h, ds.counts) \
        .round_indices(1).to(dev).contiguous()
    args = (ds.sp_indices, ds.sp_values, ds.labels, ds.sq_norms, idxs,
            1e-3, ds.n)

    def b1(w, a):
        dw, a_in = sparse_sdca_round(w, a, *args, mode="plus", sigma=4.0)
        return w + dw.sum(0), a_in

    want_w, want_a = b1(w0, a0)  # eager: loads the library, sets attributes
    torch.cuda.synchronize()
    pool = torch.cuda.graph_pool_handle()
    stream = torch.cuda.Stream()
    checks = {}

    def run(name, fn):
        try:
            fn()
            checks[name] = "ok"
        except Exception as e:  # the probe reports every failure and goes on
            checks[name] = f"{type(e).__name__}: {e}"
            traceback.print_exc()
        print(f"probe: {name}: {checks[name]}")

    def nested_if():
        live = torch.ones((), dtype=torch.bool, device=dev)
        pick = torch.ones((), dtype=torch.bool, device=dev)
        sw, sa = w0.clone(), a0.clone()

        def body():
            with _If(live):
                with _If(pick):
                    w, a = b1(sw, sa)
                    sw.copy_(w)
                    sa.copy_(a)

        graph = _capture(body, pool, stream)
        for lv, pk in ((False, True), (True, False), (True, True)):
            sw.copy_(w0)
            sa.copy_(a0)
            live.fill_(lv)
            pick.fill_(pk)
            graph.replay()
            torch.cuda.synchronize()
            ran = lv and pk
            ew, ea = (want_w, want_a) if ran else (w0, a0)
            if not (torch.equal(sw, ew) and torch.equal(sa, ea)):
                raise AssertionError(f"live={lv} pick={pk}: the body "
                                     f"{'did not run' if ran else 'ran'} "
                                     f"or differs from the eager launch")

    def in_graph_pred():
        i = torch.zeros((), dtype=torch.int64, device=dev)
        live = torch.zeros((), dtype=torch.bool, device=dev)
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        n = 3

        def body():
            torch.lt(i, n, out=live)
            with _If(live):
                acc.add_(torch.ones_like(acc) * 2.0)
                i.add_(1)

        graph = _capture(body, pool, stream)
        for _ in range(5):
            graph.replay()
        torch.cuda.synchronize()
        if int(i) != n or float(acc) != 2.0 * n:
            raise AssertionError(f"counter {int(i)}, sum {float(acc)}; want "
                                 f"{n}, {2.0 * n}")

    def draw_in_if():
        t0 = torch.ones((), dtype=torch.int64, device=dev)
        counts = torch.as_tensor(ds.counts, dtype=torch.int64).to(dev)
        live = torch.ones((), dtype=torch.bool, device=dev)
        tabs = torch.zeros((2, 2, ds.k, h), dtype=torch.int32, device=dev)
        slot = torch.zeros((), dtype=torch.int64, device=dev)
        prng.draw_tables("reference", 0, h, counts, t0, 2)  # warm-up

        def body():
            with _If(live):
                tabs.index_copy_(0, slot.reshape(1), prng.draw_tables(
                    "reference", 0, h, counts, t0, 2).unsqueeze(0))
                t0.add_(2)
                slot.add_(1)

        graph = _capture(body, pool, stream)
        t0.fill_(1)
        slot.zero_()
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
        want = prng.host_tables("reference", 0, h, ds.counts, 1, 4)
        if not torch.equal(tabs.reshape(4, ds.k, h).cpu(), want):
            raise AssertionError("the draw kernel's tables differ from the "
                                 "host's")

    def timing():
        live = torch.zeros((), dtype=torch.bool, device=dev)
        sw, sa = w0.clone(), a0.clone()

        def body():
            for _ in range(8):
                with _If(live):
                    w, a = b1(sw, sa)
                    sw.copy_(w)
                    sa.copy_(a)

        graph = _capture(body, pool, stream)
        res = {}
        for lv in (False, True):
            live.fill_(lv)
            graph.replay()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                graph.replay()
            stop.record()
            torch.cuda.synchronize()
            res["taken" if lv else "skipped"] = start.elapsed_time(stop) / 20
        out["replay_ms_8_ifs"] = res
        print(f"probe: one replay of 8 IF bodies (B1 at {ds.k} x {h}): "
              f"skipped {res['skipped']:.4f} ms, taken {res['taken']:.4f} ms")

    run("nested IF around B1", nested_if)
    run("predicate computed in the graph", in_graph_pred)
    run("draw kernel in an IF body", draw_in_if)
    run("replay timing", timing)
    out["checks"] = checks
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("error: probe_conditional.py needs a CUDA device",
              file=sys.stderr)
        return 1
    out = probe()
    print(json.dumps(out))
    return 0 if out.get("api") and all(
        v == "ok" for v in out.get("checks", {}).values()) else 1


if __name__ == "__main__":
    sys.exit(main())
