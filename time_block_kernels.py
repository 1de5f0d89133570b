"""Time the block chain (B3), the sparse block Gram (B5) and the sparse
block apply (B6) of a checkout at the shapes of ``chip_smoke.py`` phases 5
and 11, to hold two versions of the kernels against each other on the
same card.

    python3 time_block_kernels.py [--root=DIR]

imports ``cocoa_torch`` and ``chip_smoke`` from DIR (default: this file's
directory; any checkout of the port, e.g. an earlier commit unpacked with
``git archive``) and builds the inputs with DIR's own ``chip_smoke``
helpers (``sparse_block_inputs``, ``chain_scal``, ``dense_block_inputs``;
seeded, the same in every checkout), CoCoA+/hinge, float32 unless named:
B3 on the rcv1-like sparse block (8 x 128), on the epsilon-like split
shapes (8 x 256 and 8 x 512, the full Gram in full float32) and in frozen
mode; B5 and B6 on the rcv1-like block in float32 and float64 and on
the rcv1-like hybrid residual (``--hotCols=auto``); B6 also on a demo
block (4 x 128) and on the demo's padded-CSC columns into Delta-r (4 x
128, W=1738, n=2000, ProxCoCoA+'s lasso coefficients), each with the
plain chain's coefficients; and B4, whose chain is not B3's, on the
epsilon-like fused block (8 x 128 x 2000), so that its digest shows it
unchanged.  Each is timed at the wrapper's auto plan twice: ``ms`` by DIR's ``chip_smoke.cuda_ms`` (CUDA
events around 50 back-to-back wrapper calls after a warm-up, 20 at the
split shapes), which includes the wrapper's host time where that is the
longer, and ``device_ms`` by replaying the same calls captured in one
CUDA graph (the kernels alone, back to back); each is printed with a
digest of one launch's outputs and their largest difference from the
plain version (B6: one launch on a fresh clone of Delta-w, and
``cpu_equal``, whether it equals the plain version run on CPU copies bit
for bit; its timed launches advance one Delta-w in place).  Prints the
card, then one JSON object.  Run it for two
checkouts in one call, in turns, to compare them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("error: time_block_kernels.py needs a CUDA device",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from cocoa_torch.data import hybrid, load_libsvm
    from cocoa_torch.data.columns import shard_columns
    from cocoa_torch.data.synth import synth_dense_sharded, synth_sparse
    from cocoa_torch.ops import block_chain as bc
    from cocoa_torch.ops import sparse_block as sb

    f32, f64 = torch.float32, torch.float64
    k, h = 8, 253

    def device_ms(fn, reps):
        """ms per call of ``reps`` calls captured in one CUDA graph,
        replayed three times between CUDA events."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            graph.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / (3 * reps)

    def record(fn, plain, reps=50):
        """ms per launch (wrapper calls, and the kernels alone in a CUDA
        graph), one launch's digest and its largest difference from the
        plain version."""
        got, want = fn(), plain()
        torch.cuda.synchronize()
        digest = hashlib.sha256(b"".join(
            t.cpu().numpy().tobytes() for t in got if t is not None)) \
            .hexdigest()[:16]
        err = max(float((g - x).abs().max())
                  for g, x in zip(got, want) if x is not None)
        return dict(ms=cs.cuda_ms(fn, reps), device_ms=device_ms(fn, reps),
                    digest=digest, max_abs_err=err)

    def apply_record(dw, rows, coefs, reps=50):
        """B6: ms and device_ms of launches advancing one Delta-w in
        place, and one launch on a fresh clone: its digest, its largest
        difference from the plain version on the card, and whether it
        equals the plain version run on CPU copies bit for bit."""
        got = sb.sparse_block_apply(dw.clone(), *rows, coefs)
        want = sb.sparse_block_apply_plain(dw.clone(), *rows, coefs)
        on_cpu = sb.sparse_block_apply_plain(
            dw.cpu().clone(), *(r.cpu() for r in rows), coefs.cpu())
        torch.cuda.synchronize()
        work = dw.clone()
        return dict(
            ms=cs.cuda_ms(lambda: sb.sparse_block_apply(work, *rows, coefs),
                          reps),
            device_ms=device_ms(lambda: sb.sparse_block_apply(
                work, *rows, coefs), reps),
            digest=hashlib.sha256(got.cpu().numpy().tobytes())
            .hexdigest()[:16],
            max_abs_err=float((got - want).abs().max()),
            cpu_equal=torch.equal(got.cpu(), on_cpu))

    print(f"{cs.nvidia_smi()}; {root}")
    rcv1 = synth_sparse(*cs.RCV1_SHAPE, nnz_mean=75, seed=0)
    out = {}
    hot_w, _ = hybrid.resolve_hot_cols("auto", rcv1, k, f32)
    for name, dt, hot in (("rcv1-like", f32, 0), ("rcv1-like f64", f64, 0),
                          ("rcv1-like residual", f32, hot_w)):
        bi = cs.sparse_block_inputs(rcv1, k, h, dt, seed=7, hot_cols=hot)
        rows = (bi["gidx"], bi["gvals"], bi["cnts"])
        gargs = (bi["w"], bi["dw"], *rows, float(k), False)
        out[f"B5 {name}"] = record(
            lambda: sb.sparse_block_gram(*gargs),
            lambda: sb.sparse_block_gram_plain(*gargs))
        gram, mb = sb.sparse_block_gram_plain(*gargs)
        scal = cs.chain_scal(bi, mb, float(k), dt)
        lam_n = 1e-4 * bi["ds"].n
        kw = dict(lam_n=lam_n, coef_div=lam_n, sig_eff=float(k),
                  frozen=False, loss="hinge")
        coefs = bc.chain_block_batched_plain(scal, gram, bi["bidx32"],
                                             **kw)[1]
        out[f"B6 {name}"] = apply_record(bi["dw"], rows, coefs)
        if name != "rcv1-like":
            continue
        out["B3 rcv1-like 8 x 128"] = record(
            lambda: bc.chain_block_batched(scal, gram, bi["bidx32"], **kw),
            lambda: bc.chain_block_batched_plain(scal, gram, bi["bidx32"],
                                                 **kw))
        kz = dict(kw, frozen=True, sig_eff=0.0)
        out["B3 rcv1-like 8 x 128 frozen"] = record(
            lambda: bc.chain_block_batched(scal, None, bi["bidx32"], **kz),
            lambda: bc.chain_block_batched_plain(scal, None, bi["bidx32"],
                                                 **kz))
    del rcv1
    demo = load_libsvm(str(cs.DEMO_TRAIN), 9947)
    bi = cs.sparse_block_inputs(demo, 4, 50, f32, seed=7)
    rows = (bi["gidx"], bi["gvals"], bi["cnts"])
    gram, mb = sb.sparse_block_gram_plain(bi["w"], bi["dw"], *rows, 4.0,
                                          False)
    lam_n = 1e-3 * bi["ds"].n
    coefs = bc.chain_block_batched_plain(
        cs.chain_scal(bi, mb, 4.0, f32), gram, bi["bidx32"], lam_n=lam_n,
        coef_div=lam_n, sig_eff=4.0, frozen=False, loss="hinge")[1]
    out["B6 demo 4 x 128"] = apply_record(bi["dw"], rows, coefs)
    cols = shard_columns(demo, 4, dtype=f32, device="cuda",
                         layout="sparse")[0]
    bi = cs.prox_block_inputs(cols, cs.BLOCK, f32, seed=9)
    rows = (bi["gidx"], bi["gvals"], bi["cnts"])
    gram, mb = sb.sparse_block_gram_plain(bi["r"], bi["dr"], *rows, 4.0,
                                          False)
    scal = torch.stack([mb, bi["yb"], bi["sq"] * 4.0, bi["a0"],
                        torch.zeros_like(mb), bi["live"]], 1)
    coefs = bc.chain_block_batched_plain(scal, gram, bi["bidx32"],
                                         **cs.lasso_kw(0.1, 4.0, 0.0))[1]
    out[f"B6 demo columns 4 x 128 W={rows[0].shape[-1]}"] = apply_record(
        bi["dr"], rows, coefs)
    del demo, cols, bi
    eps = synth_dense_sharded(*cs.EPS_SHAPE, seed=0, device="cuda")
    kd, lam_e = eps.k, 1e-3 * eps.n
    kwe = dict(lam_n=lam_e, coef_div=lam_e, sig_eff=float(kd), frozen=False,
               loss="hinge")
    for b in (cs.BLOCK, 2 * cs.BLOCK, 4 * cs.BLOCK):
        di = cs.dense_block_inputs(eps, b, f32, seed=9)
        v = di["w"] + float(kd) * di["dw"]
        if b == cs.BLOCK:
            fargs = (di["xb"], di["bidx32"], di["yb"], di["sq"] * kd,
                     di["a0"], di["live"], v)
            out["B4 epsilon-like 8 x 128"] = record(
                lambda: bc.fused_block(*fargs, **kwe),
                lambda: bc.fused_block_plain(*fargs, **kwe), 20)
            continue
        with bc.fp32_matmul():
            mbase = torch.matmul(di["xb"], v[:, :, None])[..., 0]
            gb = torch.matmul(di["xb"], di["xb"].transpose(1, 2))
        sc = torch.stack([mbase, di["yb"], di["sq"] * kd, di["a0"],
                          torch.zeros_like(mbase), di["live"]], 1)
        out[f"B3 epsilon-like split 8 x {b}"] = record(
            lambda: bc.chain_block_batched(sc, gb, di["bidx32"], **kwe),
            lambda: bc.chain_block_batched_plain(sc, gb, di["bidx32"],
                                                 **kwe), 20)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
