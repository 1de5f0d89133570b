"""Time the block round's alpha update, and the block rounds around it,
of a checkout, to hold two versions against each other on the same card.

    python3 time_block_round.py [--root=DIR] [--alpha=own|sorted|atomic]

imports ``cocoa_torch`` and ``chip_smoke`` from DIR (default: this file's
directory; any checkout of the port, e.g. an earlier commit unpacked with
``git archive``) and times, by CUDA-graph replay (``chip_smoke.graph_ms``)
in float32, CoCoA+/hinge:

- ``rcv1_block``: DIR's ``local_sdca_block_batched`` over one round of
  rcv1-like shards (``chip_smoke.RCV1_SHAPE``, K=8, H=253) at B=128, the
  sparse-Gram route (B5, B3, B6), on reference draws (with replacement);
- ``eps_fused``: one round of epsilon-like shards (``chip_smoke.
  EPS_SHAPE``, K=8, H=5000) at B=128, the fused route (40 B4 a round),
  on reference draws;
- ``*_update``: the alpha update of one block alone, (K, 128) deltas into
  those shards' (K, n_shard) alpha, at a block of the same draws.

Each round also runs twice outside the graph: ``*_stable`` says whether
the two gave the same bits.  ``--alpha`` picks the update: ``own`` DIR's
(``ops/local_sdca.py _block_alpha_add``: from the commit that made the
update order-stable, the masked form, which sums a block's duplicate
slots through a (K, B, B) index-equality mask and writes every slot's
total with ``scatter_``; in an older checkout its ``scatter_add_``),
``sorted`` the other order-stable form, ``index_put_`` with
``accumulate`` on the flattened alpha (a stable sort, then each row's
deltas in slot order), ``atomic`` the ``scatter_add_`` of the rounds
before the update was made order-stable.  Prints the card, then one JSON
object.  Run it for two checkouts, or two forms, in turns in one call to
compare them; ``chip_smoke.py`` phase 19 (d) calls :func:`measure`
in-process.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPS = {"rcv1_block": 20, "eps_fused": 3}
UPDATE_REPS = 200
FORMS = ("own", "sorted", "atomic")


def sorted_alpha_add(a_vec, bidx, delta):
    """The sorted form: the (K, B) slots into the flattened (K*n_shard)
    alpha by ``index_put_`` with ``accumulate`` (on the card a stable sort
    of the keys, then each row's deltas in slot order)."""
    import torch

    k, n = a_vec.shape
    flat = (bidx + n * torch.arange(k, device=bidx.device)[:, None]
            ).reshape(-1)
    a_vec.view(-1).index_put_((flat,), delta.reshape(-1), accumulate=True)


def atomic_alpha_add(a_vec, bidx, delta):
    """The update before it was made order-stable: atomics on the card."""
    a_vec.scatter_add_(1, bidx, delta)


def block_sets(cs, rcv1=None):
    """{name: (dataset, lambda, route)}: the rcv1-like sparse shards (of
    ``rcv1``, else made from its seed) and the epsilon-like dense shards,
    on the card."""
    import torch

    from cocoa_torch.data import shard_dataset
    from cocoa_torch.data.synth import synth_dense_sharded, synth_sparse

    if rcv1 is None:
        rcv1 = synth_sparse(*cs.RCV1_SHAPE, nnz_mean=75, seed=0)
    return {"rcv1_block": (shard_dataset(rcv1, 8, layout="sparse",
                                         dtype=torch.float32,
                                         device="cuda"), 1e-4,
                           "sparse_gram"),
            "eps_fused": (synth_dense_sharded(*cs.EPS_SHAPE, seed=0,
                                              device="cuda"), 1e-3,
                          "fused")}


def measure(sets, cs, form: str = "own") -> dict:
    """Each set's round and update times with the update ``form``
    (module docstring), the module's own update put back after."""
    import torch

    from cocoa_torch.ops import local_sdca as ls
    from cocoa_torch.ops.rows import row_lengths
    from cocoa_torch.solvers.base import IndexSampler

    own = getattr(ls, "_block_alpha_add", None)
    fn = {"own": own or atomic_alpha_add, "sorted": sorted_alpha_add,
          "atomic": atomic_alpha_add}[form]
    out = {"alpha": form if own is not None else "scatter_add_"}
    if own is not None:
        ls._block_alpha_add = fn
    try:
        for name, (ds, lam, route) in sets.items():
            h = ds.n // ds.k // 10
            idxs = IndexSampler("reference", 0, h, ds.counts).chunk_indices(
                7, 1)[0].to("cuda")
            shards = ds.shard_arrays()
            if route == "sparse_gram":
                shards = {**shards, "sp_row_len": row_lengths(ds.sp_values)}
            gen = torch.Generator(device="cuda").manual_seed(3)
            w = torch.randn(ds.num_features, generator=gen,
                            device="cuda") * 1e-2
            alpha = torch.rand(ds.k, ds.n_shard, generator=gen,
                               device="cuda") * 0.5 * ds.mask

            def round_fn():
                return ls.local_sdca_block_batched(
                    w, alpha, shards, idxs, lam, ds.n, mode="plus",
                    sigma=float(ds.k), block=cs.BLOCK, route=route)

            first, second = round_fn(), round_fn()
            torch.cuda.synchronize()
            out[f"{name}_stable"] = all(torch.equal(a, b)
                                        for a, b in zip(first, second))
            out[f"{name}_ms"] = cs.graph_ms(round_fn, REPS[name])
            blocks = idxs.long()[:, :h - h % cs.BLOCK].reshape(
                ds.k, -1, cs.BLOCK)
            srt = blocks.sort(-1).values
            out[f"{name}_repeat_blocks"] = float(
                (srt[..., 1:] == srt[..., :-1]).any(-1).float().mean())
            bidx = blocks[:, 0].contiguous()
            delta = torch.randn(bidx.shape, generator=gen,
                                device="cuda") * 1e-3
            a0 = alpha.clone()
            out[f"{name}_update_ms"] = cs.graph_ms(
                lambda: fn(a0, bidx, delta), UPDATE_REPS)
    finally:
        if own is not None:
            ls._block_alpha_add = own
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--alpha", default="own", choices=FORMS)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("error: time_block_round.py needs a CUDA device",
              file=sys.stderr)
        return 1
    import chip_smoke as cs

    print(f"{cs.nvidia_smi()}; {root}; alpha={args.alpha}")
    print(json.dumps(measure(block_sets(cs), cs, args.alpha)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
