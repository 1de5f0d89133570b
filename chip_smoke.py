#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``cocoa_torch``).

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, each printed as it runs; any failed check exits non-zero:

1. the card's name and power limit (nvidia-smi); build the three kernel
   libraries (one nvcc each, all started together) and time the build;
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
   CUDA events around each of its kernel launches;
5. the block kernels against their plain versions on the same CUDA
   tensors, at the shapes of the three block configurations: the chain
   (B3), the sparse Gram (B5) and the sparse apply (B6) on a demo and an
   rcv1-like block (K x 128 draws with repeats, crafted rows, a masked
   tail), the fused block (B4) and the chain at B=256 on an epsilon-like
   block (8 x 128 x 2000 and 8 x 256), every mode x loss x dtype; then
   each kernel's, its plain version's and a library call's time (B5 also
   with its rows expanded in global memory, float32 and float64);
6. the block path (--blockSize): the demo and rcv1-like data through the
   CLI with --blockSize=auto (the sparse-Gram branch: B5, B3, B6), the
   rcv1-like gaps within relative 1e-3 of phase 4's sequential run; then
   epsilon-like data (400 000 x 2000, made on the card) through
   run_cocoa at B=128 (the fused branch, B4) and B=256 (the split branch,
   B3), with the launches of every kernel counted per round, and the two
   runs' gaps within relative 1e-3 of each other.

The line before the last lists every kernel with its launches on the main
path, its error against the plain version and its times; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script fails before printing a result.
"""

from __future__ import annotations

import concurrent.futures
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
from cocoa_torch.config import DebugParams, Params
from cocoa_torch.data import load_libsvm, shard_dataset
from cocoa_torch.data.synth import synth_dense_sharded, synth_sparse, \
    write_libsvm
from cocoa_torch.ops import block_chain as bc
from cocoa_torch.ops import sparse_block as sb
from cocoa_torch.ops import sparse_sdca as sp
from cocoa_torch.ops.local_sdca import dense_rows, mode_factors
from cocoa_torch.ops.rows import row_lengths
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


BLOCK = 128
KERNELS = {"B1": sp.sparse_sdca_round, "B3": bc.chain_block_batched,
           "B4": bc.fused_block, "B5": sb.sparse_block_gram,
           "B6": sb.sparse_block_apply}


def counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def agree(tag, got, want, dtype, worst, name, floors=None):
    """Kernel outputs ``got`` against the plain version's ``want`` (pairs
    of tensors; a None pair is skipped), each within TOL relative to its
    own scale max(floor, max |plain|): ``floors`` gives one floor per
    output (default 0, relative to the output's own largest entry), e.g.
    1 for alpha deltas, which live in [-1, 1].  The largest error is kept
    in ``worst[name]``."""
    torch.cuda.synchronize()
    floors = floors or (0.0,) * len(want)
    err = 0.0
    for g, w, floor in zip(got, want, floors):
        check((g is None) == (w is None), f"{tag}: outputs differ in kind")
        if w is None:
            continue
        e = float((g - w).abs().max())
        scale = max(floor, float(w.abs().max()))
        check(bool(torch.isfinite(g).all()) and e <= TOL[dtype] * scale,
              f"{tag} kernel != plain (err {e:.3e}, scale {scale:.3e})")
        err = max(err, e)
    print(f"  {tag}: max_abs_err {err:.3e}")
    worst[name] = max(worst.get(name, 0.0), err)


def sparse_block_inputs(data, k, h, dt, seed=3):
    """The first block of a sparse round on the card: B draws with forced
    repeats and shard 0's crafted column-0 rows, steps past H masked."""
    ds = shard_dataset(data, k, layout="sparse", dtype=dt, device="cuda")
    w, alpha, idxs = round_inputs(ds, h, seed)
    spi, spv, sq, idxs = column0_rows(ds, idxs)
    n = min(h, BLOCK)
    bidx = torch.zeros(k, BLOCK, dtype=torch.long, device="cuda")
    bidx[:, :n] = idxs[:, :n]
    live_b = torch.arange(BLOCK, device="cuda") < h
    ks = torch.arange(k, device="cuda")[:, None]
    rng = np.random.default_rng(seed)
    return dict(
        ds=ds, w=w, alpha=alpha, sq=sq, bidx=bidx,
        bidx32=bidx.to(torch.int32),
        live=live_b.to(dt).expand(k, BLOCK).contiguous(),
        gidx=spi[ks, bidx].contiguous(), gvals=spv[ks, bidx].contiguous(),
        cnts=torch.where(live_b, row_lengths(spv).gather(1, bidx),
                         -1).to(torch.int32),
        dw=torch.as_tensor(rng.normal(size=(k, ds.num_features)) * 0.01)
        .to("cuda", dt))


def chain_scal(bi, mb, qf, dt):
    ds, bidx = bi["ds"], bi["bidx"]
    return torch.stack([mb, ds.labels.gather(1, bidx),
                        bi["sq"].gather(1, bidx) * qf,
                        bi["alpha"].gather(1, bidx), torch.zeros_like(mb),
                        bi["live"]], dim=1).to(dt)


def phase_block_sparse(name, data, k, h, lam, worst):
    """B5, B3 and B6 against their plain versions on one block of a
    sparse round, every mode x loss x dtype; B5 with the row expanded in
    shared and in global memory (float64 at rcv1-like width is global
    only: 378 KB); B6 launched twice must agree bit for bit (its adds are
    ordered)."""
    for dt in (torch.float32, torch.float64):
        bi = sparse_block_inputs(data, k, h, dt)
        lam_n = lam * bi["ds"].n
        rows = (bi["gidx"], bi["gvals"], bi["cnts"])
        for mode, sigma in MODES:
            sig_eff, qf = mode_factors(mode, sigma or float(k))
            frozen = mode == "frozen"
            tag = f"{name} {str(dt)[6:]} {mode}"
            args = (bi["w"], bi["dw"], *rows, sig_eff, frozen)
            gram, mb = sb.sparse_block_gram_plain(*args)
            for smem in (True, False):
                agree(f"{tag} sparse_block_gram row_in_smem={smem}",
                      sb.sparse_block_gram(*args, row_in_smem=smem),
                      (gram, mb), dt, worst, "B5")
            scal = chain_scal(bi, mb, qf, dt)
            for loss in LOSSES:
                kw = dict(lam_n=lam_n, coef_div=lam_n, sig_eff=sig_eff,
                          frozen=frozen, loss=loss)
                want = bc.chain_block_batched_plain(scal, gram, bi["bidx32"],
                                                    **kw)
                agree(f"{tag}/{loss} chain_block_batched",
                      bc.chain_block_batched(scal, gram, bi["bidx32"], **kw),
                      want, dt, worst, "B3", (1.0, 1.0 / lam_n))
            coefs = want[1]
            got = sb.sparse_block_apply(bi["dw"].clone(), *rows, coefs)
            agree(f"{tag} sparse_block_apply", [got],
                  [sb.sparse_block_apply_plain(bi["dw"].clone(), *rows,
                                               coefs)], dt, worst, "B6")
            check(torch.equal(got, sb.sparse_block_apply(
                bi["dw"].clone(), *rows, coefs)),
                f"{tag} sparse_block_apply differs between two launches")


def dense_block_inputs(eps, b, dt, seed=5):
    """A block of B draws (forced repeats, the last 28 steps masked) of an
    epsilon-like round: the gathered rows and their step scalars."""
    k, d = eps.k, eps.num_features
    idxs = base.IndexSampler("reference", seed, b, eps.counts) \
        .round_indices(1).to("cuda").long()
    idxs[:, 1::4] = idxs[:, 0::4]
    rng = np.random.default_rng(seed)

    def put(a):
        return torch.as_tensor(a).to("cuda", dt)

    alpha = put(np.clip(rng.normal(size=(k, eps.n_shard)) * 0.3 + 0.3, 0, 1))
    live = (torch.arange(b, device="cuda") < b - 28).to(dt)
    return dict(
        xb=dense_rows({"X": eps.X}, idxs, d).to(dt), bidx32=idxs.int(),
        yb=eps.labels.gather(1, idxs).to(dt),
        sq=eps.sq_norms.gather(1, idxs).to(dt),
        a0=alpha.gather(1, idxs), live=live.expand(k, b).contiguous(),
        w=put(rng.normal(size=d) * 0.1), dw=put(rng.normal(size=(k, d)) * 0.01))


def phase_block_dense(eps, lam, worst):
    """B4 at B=128 (the fused branch) and B3 at B=256 on the split
    branch's inputs (the full symmetric Gram), every mode x loss x dtype."""
    lam_n = lam * eps.n
    for dt in (torch.float32, torch.float64):
        for b in (BLOCK, 2 * BLOCK):
            bi = dense_block_inputs(eps, b, dt)
            for mode, sigma in MODES:
                sig_eff, qf = mode_factors(mode, sigma or float(eps.k))
                frozen = mode == "frozen"
                v = bi["w"].expand_as(bi["dw"]).contiguous() if frozen \
                    else bi["w"] + sig_eff * bi["dw"]
                with bc.fp32_matmul():
                    mbase = torch.matmul(bi["xb"], v[:, :, None])[..., 0]
                    gram = torch.matmul(bi["xb"], bi["xb"].transpose(1, 2))
                scal = torch.stack([mbase, bi["yb"], bi["sq"] * qf, bi["a0"],
                                    torch.zeros_like(mbase), bi["live"]], 1)
                for loss in LOSSES:
                    kw = dict(lam_n=lam_n, coef_div=lam_n, sig_eff=sig_eff,
                              frozen=frozen, loss=loss)
                    tag = f"epsilon-like {str(dt)[6:]} B={b} {mode}/{loss}"
                    if b == BLOCK:
                        fargs = (bi["xb"], bi["bidx32"], bi["yb"],
                                 bi["sq"] * qf, bi["a0"], bi["live"], v)
                        agree(f"{tag} fused_block", bc.fused_block(*fargs, **kw),
                              bc.fused_block_plain(*fargs, **kw), dt, worst,
                              "B4", (1.0, 0.0))
                    else:
                        agree(f"{tag} chain_block_batched",
                              bc.chain_block_batched(scal, gram, bi["bidx32"],
                                                     **kw),
                              bc.chain_block_batched_plain(
                                  scal, gram, bi["bidx32"], **kw),
                              dt, worst, "B3", (1.0, 1.0 / lam_n))


def bound(n_bytes, flops):
    """(ms, "bytes" | "operations"): the larger of the bytes over HBM3's
    rate and the float32 operations over the FP32 peak."""
    t_b = n_bytes / HBM_BYTES_PER_S
    t_f = flops / PEAK_FLOPS[torch.float32]
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def phase_block_timing(rcv1, eps, results):
    """Each block kernel's, its plain version's and a library call's ms
    per launch at the main path's shapes (float32, CoCoA+, hinge): B5, B3
    and B6 on an rcv1-like block, B4 on an epsilon-like block (B=128) and
    B3 on its split shape (B=256); with each launch's bound."""
    f32, isz = torch.float32, 4
    bi = sparse_block_inputs(rcv1, 8, 253, f32, seed=7)
    k, d, lam_n = 8, bi["ds"].num_features, 1e-4 * bi["ds"].n
    sig = float(k)
    rows = (bi["gidx"], bi["gvals"], bi["cnts"])
    gargs = (bi["w"], bi["dw"], *rows, sig, False)
    gram, mb = sb.sparse_block_gram_plain(*gargs)
    scal = chain_scal(bi, mb, sig, f32)
    kw = dict(lam_n=lam_n, coef_div=lam_n, sig_eff=sig, frozen=False,
              loss="hinge")
    coefs = bc.chain_block_batched_plain(scal, gram, bi["bidx32"], **kw)[1]
    c = bi["cnts"].clamp(min=0).double()
    nnz = float(c.sum())
    pairs = float((c * torch.arange(BLOCK, device="cuda")).sum())
    vals = sb.live_values(bi["gvals"], bi["cnts"])
    cols = bi["gidx"].long()
    v = bi["w"] + sig * bi["dw"]
    flat = (torch.arange(k, device="cuda")[:, None, None] * d + cols).reshape(-1)
    dw_t = bi["dw"].clone()

    def densify_gram():
        xd = torch.zeros(k, BLOCK, d, device="cuda").scatter_add_(2, cols, vals)
        return torch.bmm(xd, xd.transpose(1, 2)), torch.bmm(xd, v[:, :, None])

    results["B5"] = dict(
        ms=cuda_ms(lambda: sb.sparse_block_gram(*gargs), 50),
        plain_ms=cuda_ms(lambda: sb.sparse_block_gram_plain(*gargs), 3),
        library_ms=cuda_ms(densify_gram, 20),
        bound=bound(nnz * (4 + isz) + 2 * nnz * isz + k * BLOCK * 4
                    + k * BLOCK * BLOCK * isz + k * BLOCK * isz,
                    2 * pairs + 4 * nnz))
    results["B3"] = dict(
        ms=cuda_ms(lambda: bc.chain_block_batched(scal, gram, bi["bidx32"],
                                                  **kw), 50),
        plain_ms=cuda_ms(lambda: bc.chain_block_batched_plain(
            scal, gram, bi["bidx32"], **kw), 3),
        library_ms=None,
        bound=bound(k * 6 * BLOCK * isz + k * BLOCK * 4
                    + k * BLOCK * (BLOCK - 1) // 2 * isz
                    + 2 * k * BLOCK * isz,
                    3 * k * BLOCK * (BLOCK - 1) // 2 + 20 * k * BLOCK))
    results["B6"] = dict(
        ms=cuda_ms(lambda: sb.sparse_block_apply(dw_t, *rows, coefs), 50),
        plain_ms=cuda_ms(lambda: sb.sparse_block_apply_plain(
            dw_t, *rows, coefs), 3),
        library_ms=cuda_ms(lambda: dw_t.view(-1).index_add_(
            0, flat, (coefs[..., None] * vals).reshape(-1)), 50),
        bound=bound(nnz * (4 + isz) + k * BLOCK * (4 + isz)
                    + 2 * nnz * isz, 2 * nnz))
    results["B5"]["nnz"] = nnz
    # the rows expanded in a global scratch (d past shared memory, or
    # float64 at rcv1-like width), float32 forced and float64 as it runs
    results["B5"]["global_ms"] = cuda_ms(
        lambda: sb.sparse_block_gram(*gargs, row_in_smem=False), 50)
    b64 = sparse_block_inputs(rcv1, 8, 253, torch.float64, seed=7)
    g64 = (b64["w"], b64["dw"], b64["gidx"], b64["gvals"], b64["cnts"], sig,
           False)
    results["B5"]["f64_ms"] = cuda_ms(lambda: sb.sparse_block_gram(*g64), 50)

    kd = eps.k
    lam_e = 1e-3 * eps.n
    for b in (BLOCK, 2 * BLOCK):
        di = dense_block_inputs(eps, b, f32, seed=9)
        de = eps.num_features
        v = di["w"] + float(kd) * di["dw"]
        kwe = dict(lam_n=lam_e, coef_div=lam_e, sig_eff=float(kd),
                   frozen=False, loss="hinge")
        if b == BLOCK:
            fargs = (di["xb"], di["bidx32"], di["yb"], di["sq"] * kd,
                     di["a0"], di["live"], v)
            results["B4"] = dict(
                ms=cuda_ms(lambda: bc.fused_block(*fargs, **kwe), 20),
                plain_ms=cuda_ms(lambda: bc.fused_block_plain(*fargs, **kwe),
                                 3),
                library_ms=None,
                bound=bound(kd * b * de * isz + 2 * kd * de * isz
                            + 6 * kd * b * isz,
                            2 * kd * b * de + kd * de * b * (b - 1)
                            + 2 * kd * b * de + 3 * kd * b * (b - 1) // 2))
        else:
            with bc.fp32_matmul():
                mbase = torch.matmul(di["xb"], v[:, :, None])[..., 0]
                g256 = torch.matmul(di["xb"], di["xb"].transpose(1, 2))
            s256 = torch.stack([mbase, di["yb"], di["sq"] * kd, di["a0"],
                                torch.zeros_like(mbase), di["live"]], 1)
            results["B3"]["split_ms"] = cuda_ms(
                lambda: bc.chain_block_batched(s256, g256, di["bidx32"],
                                               **kwe), 20)
            results["B3"]["split_bound"] = bound(
                kd * 6 * b * isz + kd * b * 4 + kd * b * (b - 1) // 2 * isz
                + 2 * kd * b * isz, 3 * kd * b * (b - 1) // 2 + 20 * kd * b)
    return results


def check_same_gaps(label, res, ref, rel=1e-3):
    for r, p in zip(res, ref):
        ra, pa = r.trajectory.records, p.trajectory.records
        check([a.round for a in ra] == [b.round for b in pa],
              f"{label}: eval rounds differ")
        for a, b in zip(ra, pa):
            err = abs(a.gap - b.gap) / abs(b.gap)
            check(err <= rel, f"{label} {r.algorithm} round {a.round}: gap "
                              f"{a.gap} vs {b.gap} (rel {err:.2e})")


def phase_block_path(sparse_runs, eps):
    """The block path through its entry points, every kernel's launches
    counted from 0 just before each run and read just after.
    ``sparse_runs``: (label, CLI argv, the sequential run's results, H)
    for the demo and rcv1-like data.  Returns ({run: counts}, {run: ms
    per round})."""
    launched, per_round = {}, {}
    for label, argv, seq, h in sparse_runs:
        rounds, blocks = 400 if label == "rcv1-like" else 200, -(-h // BLOCK)
        reset_counts()
        out, res = run_cli(argv + ["--blockSize=auto"])
        launched[label] = counts()
        (OUT / f"chip_smoke_{label}_block.log").write_text(out)
        check("blockSize=auto: using 128 for the sparse layout" in out,
              f"{label}: --blockSize=auto did not pick 128 sparse-Gram")
        want = {"B1": 0, "B3": rounds * blocks, "B4": 0,
                "B5": rounds * blocks, "B6": rounds * blocks}
        check(launched[label] == want,
              f"{label} block run launches {launched[label]}, want {want}")
        check_run(res, f"{label} block")
        check_same_gaps(f"{label} block vs sequential", res, seq)
        per_round[label] = [r.trajectory.records[-1].wall_time / (rounds // 2)
                            * 1e3 for r in res]
        print(f"phase 6: {label} --blockSize=auto ok: launches per round "
              f"B5/B3/B6 = {blocks}/{blocks}/{blocks}, gaps within rel 1e-3 "
              f"of the sequential run; ms per round (evals included) "
              f"CoCoA+ {per_round[label][0]:.3f}, CoCoA "
              f"{per_round[label][1]:.3f}")
    rounds, h = 30, eps.n // eps.k // 10
    params = Params(n=eps.n, num_rounds=rounds, local_iters=h, lam=1e-3)
    runs = {}
    for b, route, kern in ((BLOCK, "fused", "B4"), (2 * BLOCK, "split", "B3")):
        check(cocoa_mod.block_route("dense", b, torch.float32) == route,
              f"epsilon-like B={b} does not route {route}")
        label = f"epsilon-like B={b} {route}"
        reset_counts()
        w, alpha, traj = cocoa_mod.run_cocoa(
            eps, params, DebugParams(debug_iter=10, seed=0), plus=True,
            math="fast", block_size=b, quiet=True)
        torch.cuda.synchronize()
        launched[label] = counts()
        nb = -(-h // b)
        want = {name: 0 for name in KERNELS}
        want[kern] = rounds * nb
        check(launched[label] == want,
              f"{label} launches {launched[label]}, want {want}")
        runs[b] = [cli.RunResult(traj.algorithm, w, alpha, traj)]
        check_run(runs[b], label)
        per_round[label] = traj.records[-1].wall_time / rounds * 1e3
        print(f"phase 6: {label} ok: {nb} {kern} launches per round, "
              f"{per_round[label]:.3f} ms per round (evals included)")
    # the same draws and the same math, in blocks of 128 on the fused kernel
    # and of 256 through TF32-free matmuls: a Gram or Delta-w rounded to
    # TF32 or bf16 would part the gaps
    fused, split = runs[BLOCK], runs[2 * BLOCK]
    check_same_gaps("epsilon-like fused vs split", fused, split)
    print("phase 6: epsilon-like fused B=128 vs split B=256 gaps within rel "
          "1e-3: " + " ".join(
              f"{a.round}:{a.gap:.6g}/{b.gap:.6g}"
              for a, b in zip(fused[0].trajectory.records,
                              split[0].trajectory.records)))
    return launched, per_round


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
    with concurrent.futures.ThreadPoolExecutor(len(kernels.SOURCES)) as pool:
        logs = dict(zip(kernels.SOURCES,
                        pool.map(kernels.build, kernels.SOURCES)))
    print(f"phase 1: built {', '.join(logs)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        print(f"  nvcc {name}: " + " | ".join(
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
    worst_b1 = phase_kernel_vs_plain({
        "demo": (demo, 4, demo_h, 1e-3),
        "rcv1-like": (rcv1, 8, rcv1_h, 1e-4),
    })
    ms, global_ms, plain_ms, bound_ms, bound_by, n_bytes, nnz = \
        phase_timing(rcv1, 8, rcv1_h, 1e-4)
    demo_ms = phase_timing(demo, 4, demo_h, 1e-3)
    print(f"phase 2: all cases agree (max_abs_err {worst_b1:.3e}); rcv1-like "
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
    demo_seq = res
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
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "rcv1_like.svm")
    write_libsvm(rcv1, path)
    rcv1_argv = [f"--trainFile={path}", "--numFeatures=47236",
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
        out, res = run_cli(rcv1_argv)
    wall = time.perf_counter() - t0
    main_launches = sp.sparse_sdca_round.launches
    torch.cuda.synchronize()
    path_ms = sum(a.elapsed_time(b) for a, b in events) / len(events)
    (OUT / "chip_smoke_rcv1.log").write_text(out)
    check(main_launches == 400,
          f"rcv1-like: {main_launches} launches for 400 rounds")
    check_run(res, "rcv1-like")
    rcv1_seq = res
    for r in res:
        per_round = r.trajectory.records[-1].wall_time / 200 * 1e3
        print(f"  rcv1-like {r.algorithm}: {per_round:.3f} ms per round "
              f"wall clock (evals included)")
    print(f"phase 4: rcv1-like ok in {wall:.1f} s (load included), "
          f"{main_launches} launches for 400 rounds; {path_ms:.4f} ms per "
          f"launch on this path (CUDA events around each wrapper call, its "
          f"alpha copy included); phase 2 at this shape: kernel {ms:.4f} "
          f"ms, plain {plain_ms:.2f} ms per round")

    # --- phase 5: the block kernels against their plain versions
    t0 = time.perf_counter()
    eps = synth_dense_sharded(400_000, 2000, 8, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"phase 5: epsilon-like data {eps.n} x {eps.num_features} made on "
          f"the card in {time.perf_counter() - t0:.1f} s")
    worst = {}
    phase_block_sparse("demo", demo, 4, demo_h, 1e-3, worst)
    phase_block_sparse("rcv1-like", rcv1, 8, rcv1_h, 1e-4, worst)
    phase_block_dense(eps, 1e-3, worst)
    timing = phase_block_timing(rcv1, eps, {})
    print("phase 5: all block cases agree (max_abs_err " + ", ".join(
        f"{n} {e:.3e}" for n, e in sorted(worst.items())) + ")")
    for name, t in sorted(timing.items()):
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        print(f"  {name}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.3f} ms, library {lib} ms, bound "
              f"{t['bound'][0]:.5f} ms ({t['bound'][1]})")
    print(f"  B3 at the split shape (8 x 256): {timing['B3']['split_ms']:.4f} "
          f"ms, bound {timing['B3']['split_bound'][0]:.5f} ms; rcv1-like "
          f"block nonzeros {timing['B5']['nnz']:.0f}; B5 with rows in the "
          f"global scratch: float32 {timing['B5']['global_ms']:.4f} ms, "
          f"float64 {timing['B5']['f64_ms']:.4f} ms")

    # --- phase 6: the block path through its entry points
    launched, per_round = phase_block_path(
        [("demo", demo_argv, demo_seq, demo_h),
         ("rcv1-like", rcv1_argv, rcv1_seq, rcv1_h)], eps)
    tmp.cleanup()
    seq_ms = [r.trajectory.records[-1].wall_time / 200 * 1e3
              for r in rcv1_seq]
    print(f"phase 6: rcv1-like ms per round, block path vs sequential "
          f"(evals included): CoCoA+ {per_round['rcv1-like'][0]:.3f} vs "
          f"{seq_ms[0]:.3f}, CoCoA {per_round['rcv1-like'][1]:.3f} vs "
          f"{seq_ms[1]:.3f}")

    block_launches = {name: sum(c[name] for c in launched.values())
                      for name in ("B3", "B4", "B5", "B6")}
    for name, n in block_launches.items():
        check(n > 0, f"{name} never launched on the block path")
    sources = {"B3": ("chain_block_batched", "block_chain",
                      "cocoa_tpu/ops/pallas_chain.py:190"),
               "B4": ("fused_block", "block_chain",
                      "cocoa_tpu/ops/pallas_chain.py:452"),
               "B5": ("sparse_block_gram", "sparse_block",
                      "cocoa_tpu/ops/pallas_sparse.py:773"),
               "B6": ("sparse_block_apply", "sparse_block",
                      "cocoa_tpu/ops/pallas_sparse.py:909")}
    rows = [{
        "name": "sparse_sdca_round", "route": "cuda",
        "source": "cocoa_torch/csrc/sparse_sdca.cu",
        "replaces": "cocoa_tpu/ops/pallas_sparse.py:311",
        "launches": main_launches, "max_abs_err": worst_b1,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]
    for name, (fn, src, tpu) in sources.items():
        t = timing[name]
        rows.append({
            "name": fn, "route": "cuda", "source": f"cocoa_torch/csrc/{src}.cu",
            "replaces": tpu, "launches": block_launches[name],
            "max_abs_err": worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
