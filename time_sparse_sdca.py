"""Time the sparse SDCA round (B1) and its hot-panel branch (B1h) of a
checkout at the shapes of ``chip_smoke.py`` phases 2 and 10, to hold two
versions of the kernels against each other on the same card.

    python3 time_sparse_sdca.py [--root=DIR]

imports ``cocoa_torch`` and ``chip_smoke`` from DIR (default: this file's
directory; any checkout of the port, e.g. an earlier commit unpacked with
``git archive``) and runs DIR's own ``chip_smoke.phase_timing`` (B1,
CoCoA+/hinge, float32) at the rcv1-like and demo shapes and
``chip_smoke.hybrid_timing`` (B1h beside the unsplit B1) at the rcv1-like
and demo ``--hotCols=auto`` panels, on the main paths' draws (seeded, the
same in every checkout).  Beside each it times frozen mode and prints a
digest of one launch's (dw, alpha) with its largest difference from the
plain version, so that two checkouts' float32 results can be compared bit
for bit.  Prints the card, then one JSON object.  Run it for two
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
        print("error: time_sparse_sdca.py needs a CUDA device",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from cocoa_torch.data import hybrid, load_libsvm, shard_dataset
    from cocoa_torch.data.synth import synth_sparse
    from cocoa_torch.ops import sparse_sdca as sp

    f32 = torch.float32

    def launch_digest(ds, k, h, lam, hot):
        """Frozen mode's ms, and one CoCoA+/hinge launch's digest and its
        largest difference from the plain version, on the timed draws."""
        w, alpha, idxs = cs.round_inputs(ds, h, seed=5, repeats=False)
        args = (w, alpha, ds.sp_indices, ds.sp_values, ds.labels,
                ds.sq_norms, idxs, lam, ds.n)
        rl = sp.row_lengths(ds.sp_values)
        got = sp.sparse_sdca_round(*args, row_len=rl, mode="plus",
                                   sigma=float(k), **hot)
        want = sp.sparse_sdca_round_plain(*args, mode="plus", sigma=float(k),
                                          **hot)
        torch.cuda.synchronize()
        digest = hashlib.sha256(b"".join(
            t.cpu().numpy().tobytes() for t in got)).hexdigest()[:16]
        frozen = cs.cuda_ms(lambda: sp.sparse_sdca_round(
            *args, row_len=rl, mode="frozen", sigma=1.0, **hot), 50)
        return dict(frozen_ms=frozen, digest=digest, h=h,
                    max_abs_err=max(float((g - x).abs().max())
                                    for g, x in zip(got, want)))

    print(f"{cs.nvidia_smi()}; {root}")
    demo = load_libsvm(str(cs.DEMO_TRAIN), 9947)
    rcv1 = synth_sparse(*cs.RCV1_SHAPE, nnz_mean=75, seed=0)
    out = {}
    for name, data, k, lam in (("rcv1-like", rcv1, 8, 1e-4),
                               ("demo", demo, 4, 1e-3)):
        h = max(1, int(0.1 * data.n / k))
        ms, global_ms, plain_ms, bound_ms, _, _, _ = cs.phase_timing(
            data, k, h, lam)
        ds = shard_dataset(data, k, layout="sparse", dtype=f32,
                           device="cuda")
        out[f"B1 {name}"] = dict(ms=ms, global_ms=global_ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 **launch_digest(ds, k, h, lam, {}))
        width, _ = hybrid.resolve_hot_cols("auto", data, k, f32)
        ds_h = shard_dataset(data, k, layout="sparse", dtype=f32,
                             device="cuda", hot_cols=width)
        t = cs.hybrid_timing(data, ds_h, k, h, lam)
        out[f"B1h {name}"] = dict(
            ms=t["ms"], global_ms=t["global_ms"], unsplit_ms=t["unsplit_ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound"][0], n_hot=width,
            **launch_digest(ds_h, k, h, lam, dict(hot_cols=ds_h.hot_cols,
                                                  hot_panel=ds_h.X_hot)))
        del ds, ds_h
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
