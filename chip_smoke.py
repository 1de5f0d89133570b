#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``cocoa_torch``).

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, each printed as it runs; any failed check exits non-zero:

1. the card's name and power limit (nvidia-smi); build the CUDA kernel
   and time the build;
2. each kernel against its plain PyTorch version on the same CUDA tensors:
   the sparse SDCA round on the demo shards and on rcv1-like shards, for
   modes cocoa/plus/frozen x losses hinge/smooth_hinge/logistic x
   float32/float64 x dw in shared or global memory, with repeated draws
   and a real column 0 followed by padding; then the kernel's (both dw
   placements) and the plain version's time at the main path's shape;
3. the bundled demo through the CLI entry point (CoCoA+ and CoCoA,
   --math=fast, float32): the gap falls and stays >= 0, CoCoA+ ends below
   1e-2, alpha stays in [0, 1], one launch per round, and every debugIter
   gap is within relative 1e-3 of the same run through the plain version;
4. the main path: rcv1-like data (20 242 x 47 236, about 75 nonzeros a
   row, from a seed) through the CLI at K=8, H=253, lambda=1e-4, with
   CUDA events around each of its kernel launches.

The line before the last lists every kernel with its launches on the main
path, its error against the plain version and its times; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script fails before printing a result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from cocoa_torch import cli, kernels
from cocoa_torch.data import load_libsvm, shard_dataset
from cocoa_torch.data.synth import synth_sparse, write_libsvm
from cocoa_torch.ops import sparse_sdca as sp
from cocoa_torch.solvers import base
from cocoa_torch.solvers import cocoa as cocoa_mod

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
DEMO_TRAIN = ROOT / "data" / "small_train.dat"
DEMO_TEST = ROOT / "data" / "small_test.dat"

# H100 SXM published peaks (NVIDIA data sheet): HBM3 3.35 TB/s; FP32 and
# FP64 outside the tensor cores 67 and 34 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

# kernel vs plain: the kernel sums a row's products in warp-strided order
# with fused multiply-adds and reads each margin in-kernel, the plain
# version takes the round's margins X.w up front; the rounding difference
# passes through H dependent steps.  Relative to max(1, max |plain|).
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
MODES = (("cocoa", 1.0), ("plus", None), ("frozen", 1.0))
LOSSES = ("hinge", "smooth_hinge", "logistic")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call, CUDA events around ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def round_inputs(ds, h: int, seed: int):
    """Random w and alpha, and reference-mode draws with forced repeats
    (every fourth step redraws the row of the step before it)."""
    rng = np.random.default_rng(seed)
    dev, dt = ds.device, ds.dtype
    w = torch.as_tensor(rng.normal(size=ds.num_features) * 0.1).to(dev, dt)
    alpha = np.clip(rng.normal(size=(ds.k, ds.n_shard)) * 0.3 + 0.3, 0, 1)
    alpha = torch.as_tensor(alpha * ds.mask.cpu().numpy()).to(dev, dt)
    idxs = base.IndexSampler("reference", seed, h, ds.counts) \
        .round_indices(1).clone()
    idxs[:, 1::4] = idxs[:, 0::4][:, :idxs[:, 1::4].shape[1]]
    return w, alpha, idxs.to(dev).contiguous()


def column0_rows(ds, idxs):
    """Rows 0-2 of shard 0 become crafted rows, drawn again and again at
    the round's first steps: a real column 0 followed by padding, column 0
    inside the row, and a column repeated within the row."""
    spi, spv, sq = ds.sp_indices.clone(), ds.sp_values.clone(), \
        ds.sq_norms.clone()
    rows = [0, 1, 2]
    crafted = ([(0, 0.9)], [(3, 0.2), (0, 0.5), (11, 0.1)],
               [(7, 0.3), (7, 0.2), (2, 0.6)])
    for r, slots in zip(rows, crafted):
        spi[0, r] = 0
        spv[0, r] = 0
        for j, (f, v) in enumerate(slots):
            spi[0, r, j] = f
            spv[0, r, j] = v
        sq[0, r] = sum(v * v for _, v in slots)
    idxs = idxs.clone()
    order = [0, 1, 0, 2, 1, 0, 2, 2][:idxs.shape[1]]
    idxs[0, :len(order)] = torch.as_tensor([rows[o] for o in order])
    return spi, spv, sq, idxs


def compare_case(ds, w, alpha, idxs, lam, mode, sigma, loss, smem,
                 arrays=None):
    spi, spv, sq = arrays or (ds.sp_indices, ds.sp_values, ds.sq_norms)
    args = (w, alpha, spi, spv, ds.labels, sq, idxs, lam, ds.n)
    kw = dict(mode=mode, sigma=sigma, loss=loss, smoothing=1.0)
    dw_k, a_k = sp.sparse_sdca_round(*args, dw_in_smem=smem, **kw)
    dw_p, a_p = sp.sparse_sdca_round_plain(*args, **kw)
    torch.cuda.synchronize()
    err = max(float((dw_k - dw_p).abs().max()),
              float((a_k - a_p).abs().max()))
    scale = max(1.0, float(dw_p.abs().max()), float(a_p.abs().max()))
    ok = bool(torch.isfinite(dw_k).all() and torch.isfinite(a_k).all())
    return err, ok and err <= TOL[ds.dtype] * scale


def phase_kernel_vs_plain(shapes):
    """Every mode x loss x dtype x dw placement case at both shapes, plus
    the crafted column-0 rows.  ``dw_in_smem=True`` is shared memory only
    where dw fits (not rcv1-like float64).  Returns the largest error."""
    worst = 0.0
    for name, (data, k, h, lam) in shapes.items():
        for dt, smem in [(dt, smem) for dt in (torch.float32, torch.float64)
                         for smem in (True, False)]:
            ds = shard_dataset(data, k, layout="sparse", dtype=dt,
                               device="cuda")
            w, alpha, idxs = round_inputs(ds, h, seed=3)
            tag = f"{name} {str(dt)[6:]} dw_in_smem={smem}"
            for mode, sigma in MODES:
                for loss in LOSSES:
                    err, ok = compare_case(ds, w, alpha, idxs, lam, mode,
                                           sigma or float(k), loss, smem)
                    print(f"  {tag} {mode}/{loss}: max_abs_err {err:.3e}")
                    check(ok, f"{tag} {mode}/{loss} kernel != plain "
                              f"(err {err:.3e})")
                    worst = max(worst, err)
            spi, spv, sq, idxs0 = column0_rows(ds, idxs)
            for mode, loss in (("plus", "hinge"), ("cocoa", "logistic")):
                err, ok = compare_case(ds, w, alpha, idxs0, lam, mode,
                                       float(k), loss, smem, (spi, spv, sq))
                print(f"  {tag} column-0 rows {mode}/{loss}: "
                      f"max_abs_err {err:.3e}")
                check(ok, f"{tag} column-0 rows {mode}/{loss}")
                worst = max(worst, err)
    return worst


def phase_timing(data, k, h, lam):
    """Kernel (dw in shared memory, then in global memory) and plain ms
    per round at the main path's shape (float32, CoCoA+, hinge), and the
    bound for the same work."""
    ds = shard_dataset(data, k, layout="sparse", dtype=torch.float32,
                       device="cuda")
    w, alpha, idxs = round_inputs(ds, h, seed=5)
    row_len = sp.row_lengths(ds.sp_values)
    args = (w, alpha, ds.sp_indices, ds.sp_values, ds.labels, ds.sq_norms,
            idxs, lam, ds.n)
    kw = dict(mode="plus", sigma=float(k), loss="hinge")
    ms = cuda_ms(lambda: sp.sparse_sdca_round(*args, row_len=row_len, **kw),
                 50)
    global_ms = cuda_ms(lambda: sp.sparse_sdca_round(
        *args, row_len=row_len, dw_in_smem=False, **kw), 50)
    plain_ms = cuda_ms(lambda: sp.sparse_sdca_round_plain(*args, **kw), 3)
    # each input read once, each output written once: the sampled rows'
    # slots (int32 column + value), w, the (K, d) dw written, alpha read
    # and written, and per step the draw, y, |x|^2 and row length
    isz = 4
    nnz = int(row_len.gather(1, idxs.long()).sum())
    n_bytes = (nnz * (4 + isz) + ds.num_features * isz
               + k * ds.num_features * isz + 2 * k * ds.n_shard * isz
               + k * h * (4 + 2 * isz + 4))
    flops = 6 * nnz  # margin: w + s*dw and the product-sum; scatter: 2
    bound_ms = max(n_bytes / HBM_BYTES_PER_S,
                   flops / PEAK_FLOPS[torch.float32]) * 1e3
    bound_by = ("bytes" if n_bytes / HBM_BYTES_PER_S
                >= flops / PEAK_FLOPS[torch.float32] else "operations")
    return ms, global_ms, plain_ms, bound_ms, bound_by, n_bytes, nnz


def run_cli(argv):
    """cocoa_torch.cli through its entry point; stdout is captured and
    returned with the results."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, results = cli.run(argv)
    check(rc == 0, f"cli exited {rc} for {' '.join(argv)}")
    return buf.getvalue(), results


def check_run(results, label: str):
    for r in results:
        gaps = [rec.gap for rec in r.trajectory.records]
        check(all(np.isfinite(g) and g >= 0 for g in gaps),
              f"{label} {r.algorithm}: gaps not finite and >= 0: {gaps}")
        check(gaps[-1] < gaps[0], f"{label} {r.algorithm}: gap did not fall")
        a_min, a_max = float(r.alpha.min()), float(r.alpha.max())
        check(0.0 <= a_min and a_max <= 1.0,
              f"{label} {r.algorithm}: alpha outside [0, 1]: "
              f"[{a_min}, {a_max}]")
        check(bool(torch.isfinite(r.w).all()), f"{label}: w not finite")
        print(f"  {label} {r.algorithm}: round:gap@wall-ms "
              + " ".join(f"{rec.round}:{rec.gap:.6g}@{rec.wall_time * 1e3:.1f}"
                         for rec in r.trajectory.records))


def main() -> int:
    if not torch.cuda.is_available():
        print("error: chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(exist_ok=True)
    kind = torch.cuda.get_device_name(0)

    # --- phase 1: the card, the build
    print("phase 1: the card (nvidia-smi name, power.limit):")
    print(nvidia_smi())
    t0 = time.perf_counter()
    log = kernels.build("sparse_sdca")
    print(f"phase 1: built sparse_sdca in {time.perf_counter() - t0:.1f} s")
    print("  nvcc: " + " | ".join(
        ln.strip() for ln in log.splitlines() if "registers" in ln))

    # --- phase 2: kernel vs plain on the card
    demo = load_libsvm(str(DEMO_TRAIN), 9947)
    t0 = time.perf_counter()
    rcv1 = synth_sparse(20242, 47236, nnz_mean=75, seed=0)
    print(f"phase 2: rcv1-like data {rcv1.n} x {rcv1.num_features}, "
          f"{int(rcv1.indptr[-1])} nonzeros, max row {rcv1.max_nnz}, made in "
          f"{time.perf_counter() - t0:.1f} s")
    demo_h = max(1, int(0.1 * demo.n / 4))
    rcv1_h = max(1, int(0.1 * rcv1.n / 8))
    worst = phase_kernel_vs_plain({
        "demo": (demo, 4, demo_h, 1e-3),
        "rcv1-like": (rcv1, 8, rcv1_h, 1e-4),
    })
    ms, global_ms, plain_ms, bound_ms, bound_by, n_bytes, nnz = \
        phase_timing(rcv1, 8, rcv1_h, 1e-4)
    demo_ms = phase_timing(demo, 4, demo_h, 1e-3)
    print(f"phase 2: all cases agree (max_abs_err {worst:.3e}); rcv1-like "
          f"f32 plus/hinge round: kernel {ms:.4f} ms (dw in global memory "
          f"{global_ms:.4f} ms), plain {plain_ms:.2f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}: {n_bytes} B, {nnz} sampled "
          f"nonzeros); demo round: kernel {demo_ms[0]:.4f} ms (dw in "
          f"global memory {demo_ms[1]:.4f} ms), plain {demo_ms[2]:.2f} ms, "
          f"bound {demo_ms[3]:.5f} ms")

    # --- phase 3: the demo through the CLI, kernel and plain
    demo_argv = [f"--trainFile={DEMO_TRAIN}", f"--testFile={DEMO_TEST}",
                 "--numFeatures=9947", "--numSplits=4", "--numRounds=100",
                 "--localIterFrac=0.1", "--lambda=.001", "--math=fast",
                 "--dtype=float32"]
    sp.sparse_sdca_round.launches = 0
    out, res = run_cli(demo_argv)
    launches = sp.sparse_sdca_round.launches
    (OUT / "chip_smoke_demo.log").write_text(out)
    check(launches == 200, f"demo: {launches} launches for 200 rounds")
    check_run(res, "demo")
    check(res[0].trajectory.records[-1].gap < 1e-2,
          "demo CoCoA+ gap did not reach 1e-2")
    def plain_round(*args, row_len=None, **kw):
        return sp.sparse_sdca_round_plain(*args, **kw)

    with mock.patch.object(cocoa_mod, "sparse_sdca_round", plain_round):
        _, res_plain = run_cli(demo_argv)
    for r, p in zip(res, res_plain):
        for a, b in zip(r.trajectory.records, p.trajectory.records):
            rel = abs(a.gap - b.gap) / abs(b.gap)
            check(rel <= 1e-3, f"demo {r.algorithm} round {a.round}: kernel "
                               f"gap {a.gap} vs plain {b.gap} (rel {rel:.2e})")
    print(f"phase 3: demo ok, {launches} launches for 200 rounds, gaps "
          f"within rel 1e-3 of the plain run")

    # --- phase 4: the main path, rcv1-like at full width
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rcv1_like.svm")
        write_libsvm(rcv1, path)
        argv = [f"--trainFile={path}", "--numFeatures=47236",
                "--numSplits=8", "--localIterFrac=0.1", "--lambda=1e-4",
                "--math=fast", "--dtype=float32", "--numRounds=200",
                "--debugIter=25"]
        events = []

        def timed_round(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = sp.sparse_sdca_round(*args, **kw)
            stop.record()
            events.append((start, stop))
            return out

        sp.sparse_sdca_round.launches = 0
        t0 = time.perf_counter()
        with mock.patch.object(cocoa_mod, "sparse_sdca_round", timed_round):
            out, res = run_cli(argv)
        wall = time.perf_counter() - t0
        main_launches = sp.sparse_sdca_round.launches
        torch.cuda.synchronize()
        path_ms = sum(a.elapsed_time(b) for a, b in events) / len(events)
    (OUT / "chip_smoke_rcv1.log").write_text(out)
    check(main_launches == 400,
          f"rcv1-like: {main_launches} launches for 400 rounds")
    check_run(res, "rcv1-like")
    for r in res:
        per_round = r.trajectory.records[-1].wall_time / 200 * 1e3
        print(f"  rcv1-like {r.algorithm}: {per_round:.3f} ms per round "
              f"wall clock (evals included)")
    print(f"phase 4: rcv1-like ok in {wall:.1f} s (load included), "
          f"{main_launches} launches for 400 rounds; {path_ms:.4f} ms per "
          f"launch on this path (CUDA events around each wrapper call, its "
          f"alpha copy included); phase 2 at this shape: kernel {ms:.4f} "
          f"ms, plain {plain_ms:.2f} ms per round")

    print(json.dumps({"kernels": [{
        "name": "sparse_sdca_round", "route": "cuda",
        "source": "cocoa_torch/csrc/sparse_sdca.cu",
        "replaces": "cocoa_tpu/ops/pallas_sparse.py:311",
        "launches": main_launches, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
