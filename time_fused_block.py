"""Time the fused block kernel (B4) of a checkout on the epsilon-like block
of ``chip_smoke.py`` phase 5, to hold two versions of the kernel against
each other on the same card.

    python3 time_fused_block.py [--root=DIR]

imports ``cocoa_torch`` and ``chip_smoke`` from DIR (default: this file's
directory; any checkout of the port, e.g. an earlier commit unpacked with
``git archive``), builds the block with DIR's
``chip_smoke.dense_block_inputs`` (8 x 128 draws of the epsilon-like
shards, seed 9, the same in every checkout) and times DIR's
``cocoa_torch.ops.block_chain.fused_block`` with ``chip_smoke.cuda_ms``
in float32: CoCoA+/hinge (phase 5's timed case) and frozen mode (no
Gram), and, where the checkout's kernel takes a cluster size, at each of
1, 2, 4 and 8 blocks a shard.  Prints the card, then one JSON object.
Run it for two checkouts in one call, in turns, to compare them.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

CLUSTERS = (1, 2, 4, 8)
REPS = 50


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("error: time_fused_block.py needs a CUDA device",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from cocoa_torch.data.synth import synth_dense_sharded
    from cocoa_torch.ops import block_chain as bc

    print(f"{cs.nvidia_smi()}; {root}")
    eps = synth_dense_sharded(*cs.EPS_SHAPE, seed=0, device="cuda")
    bi = cs.dense_block_inputs(eps, cs.BLOCK, torch.float32, seed=9)
    k, lam_n = eps.k, 1e-3 * eps.n
    kw = dict(lam_n=lam_n, coef_div=lam_n, sig_eff=float(k), frozen=False,
              loss="hinge")
    args = (bi["xb"], bi["bidx32"], bi["yb"], bi["sq"] * k, bi["a0"],
            bi["live"], bi["w"] + float(k) * bi["dw"])
    frozen = (*args[:3], bi["sq"], *args[4:6],
              bi["w"].expand(k, eps.num_features).contiguous())
    kwz = dict(kw, sig_eff=0.0, frozen=True)
    out = {"plus/hinge": cs.cuda_ms(lambda: bc.fused_block(*args, **kw),
                                    REPS),
           "frozen": cs.cuda_ms(lambda: bc.fused_block(*frozen, **kwz),
                                REPS)}
    if "cluster" in inspect.signature(bc.fused_block).parameters:
        out["plan"] = bc.fused_plan(cs.BLOCK, eps.num_features, 4)
        for c in CLUSTERS:
            out[f"cluster={c}"] = cs.cuda_ms(
                lambda: bc.fused_block(*args, cluster=c, **kw), REPS)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
