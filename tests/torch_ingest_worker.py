"""One rank of a CPU gang for tests/test_torch_ingest.py and
tests/test_torch_slab_cache.py.

    python tests/torch_ingest_worker.py RANK WORLD PORT FILE D CASES.json

Joins a gloo gang of WORLD ranks at 127.0.0.1:PORT and, for each case of
CASES.json (a list of dicts: ``name``, ``k``, ``layout``, ``hot``,
``eval_dense``, ``dtype``, and ``caches``, a cache directory a rank or
absent), streams this rank's shards of the LIBSVM FILE (D features) and
builds the same shards from the whole parse with ``shard_dataset(...,
part=...)``.  Prints one line ``RESULT <json>`` a case: whether the two
are equal field by field (``torch.equal``, dtypes and shapes included),
the pass-1 and pass-2 facts, and the index this rank assembled.  A case
that raises prints ``RESULT`` with its error, and the gang goes on.
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from cocoa_torch.data import load_libsvm, shard_dataset  # noqa: E402
from cocoa_torch.data.ingest import (build_index,  # noqa: E402
                                     stream_shard_dataset)
from cocoa_torch.data.slab_cache import SlabCache  # noqa: E402
from cocoa_torch.parallel import distributed  # noqa: E402

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


def equal(a, b) -> bool:
    fa, fb = a.shard_arrays(), b.shard_arrays()
    return (fa.keys() == fb.keys()
            and all(fa[f].dtype == fb[f].dtype and torch.equal(fa[f], fb[f])
                    for f in fa)
            and (a.counts == b.counts).all() and a.n == b.n
            and a.k == b.k and a.shard_lo == b.shard_lo
            and (a.global_counts == b.global_counts).all())


def run_case(path, d, rank, world, data, case):
    part = (rank, world)
    caches = case.get("caches")
    cache = SlabCache(caches[rank]) if caches else None
    kw = dict(layout=case["layout"], dtype=DTYPES[case.get("dtype",
                                                           "float64")],
              device="cpu", part=part, eval_dense=case.get("eval_dense",
                                                           False),
              hot_cols=case.get("hot", 0))
    index = build_index(path, d, cache=cache)
    ds, info = stream_shard_dataset(path, d, case["k"], index=index,
                                    cache=cache, **kw)
    whole = shard_dataset(data, case["k"], **kw)
    digest = hashlib.sha256(index.row_off.tobytes() + index.row_nnz.tobytes()
                            + index.hist.tobytes()).hexdigest()
    return {"equal": bool(equal(ds, whole)), "rows": info.rows,
            "nnz": info.nnz, "bytes_read": info.bytes_read,
            "scan_bytes": index.scan_bytes, "status": info.cache_status,
            "shards_cached": info.shards_cached,
            "resid": info.residual_max_nnz, "index": digest,
            "width": (0 if ds.sp_indices is None
                      else int(ds.sp_indices.shape[-1]))}


def main() -> int:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    path, d = sys.argv[4], int(sys.argv[5])
    with open(sys.argv[6]) as f:
        cases = json.load(f)
    distributed.maybe_initialize(f"127.0.0.1:{port}", rank, world,
                                 timeout_s=120.0)
    data = load_libsvm(path, d)
    for case in cases:
        try:
            out = run_case(path, d, rank, world, data, case)
        except Exception as e:  # reported beside the case, not raised
            out = {"error": repr(e)}
        out.update(name=case["name"], rank=rank)
        print("RESULT " + json.dumps(out), flush=True)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
