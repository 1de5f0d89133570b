"""Time the dense SDCA round (B2) of a checkout at the shapes of
``chip_smoke.py`` phase 7, to hold two versions of the kernel against each
other on the same card.

    python3 time_dense_sdca.py [--root=DIR]

imports ``cocoa_torch`` and ``chip_smoke`` from DIR (default: this file's
directory; any checkout of the port, e.g. an earlier commit unpacked with
``git archive``) and runs DIR's own
``chip_smoke.dense_timing`` on the main paths' draws (seeded, the same in
every checkout): epsilon-like CoCoA+, the lasso design's prox round, the
demo's dense shards in float32 and float64, and the prox round of a tall
lasso design whose columns are wider than a shared-memory slot.  Prints the card, then one JSON
object {shape: dense_timing's result}.  Run it for two checkouts in one
call, in turns, to compare them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# chip_smoke.py TALL_LASSO_SHAPE: (n, d, K), rows of n values
TALL_LASSO_SHAPE = (100_000, 1024, 8)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("error: time_dense_sdca.py needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from cocoa_torch.data import load_libsvm, shard_dataset
    from cocoa_torch.data.synth import synth_dense_sharded, \
        synth_lasso_columns

    print(f"{cs.nvidia_smi()}; {root}")
    eps = synth_dense_sharded(*cs.EPS_SHAPE, seed=0, device="cuda")
    lasso, _, lam_max = synth_lasso_columns(*cs.LASSO_SHAPE, seed=0,
                                            device="cuda")
    demo = load_libsvm(str(cs.DEMO_TRAIN), 9947)
    demo_h = max(1, int(0.1 * demo.n / 4))
    ln, ld, lk = cs.LASSO_SHAPE
    out = {"epsilon-like": cs.dense_timing(
        eps, cs.EPS_SHAPE[0] // cs.EPS_SHAPE[2] // 10, 1e-3, eps.n, "plus",
        "hinge", 1.0, 20)}
    del eps
    out["lasso design"] = cs.dense_timing(lasso, ld // lk // 10,
                                          0.3 * lam_max, 1, "prox", "lasso",
                                          0.0, 50)
    for dt in (torch.float32, torch.float64):
        ds = shard_dataset(demo, 4, layout="dense", dtype=dt, device="cuda")
        out[f"demo dense {str(dt)[6:]}"] = cs.dense_timing(
            ds, demo_h, 1e-3, demo.n, "plus", "hinge", 1.0, 50)
    tall, _, tall_max = synth_lasso_columns(*TALL_LASSO_SHAPE, seed=1,
                                            device="cuda")
    out["tall lasso design"] = cs.dense_timing(tall, 40, 0.3 * tall_max, 1,
                                               "prox", "lasso", 0.0, 20)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
