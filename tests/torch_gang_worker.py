"""One rank of a CPU gang for tests/test_torch_gang.py.

    python tests/torch_gang_worker.py RANK WORLD PORT DATA.npz CASES.json

Joins a gloo gang of WORLD ranks at 127.0.0.1:PORT, builds this rank's
shards of the dataset in DATA.npz for each case of CASES.json (a list of
dicts, see ``run_case``), runs it in float64 and prints one line
``RESULT <json>`` per case: w, the whole alpha (gathered over the host
group), the eval records and the all-reduces the run made.  A case that
raises prints ``RESULT`` with its error, and the gang goes on.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.data import shard_dataset  # noqa: E402
from cocoa_torch.data.columns import shard_columns  # noqa: E402
from cocoa_torch.data.libsvm import LibsvmData  # noqa: E402
from cocoa_torch.parallel import distributed  # noqa: E402
from cocoa_torch.parallel.fanout import all_reduce_sum  # noqa: E402
from cocoa_torch.parallel.mesh import make_mesh  # noqa: E402
from cocoa_torch.solvers import run_cocoa  # noqa: E402
from cocoa_torch.solvers.dist_gd import run_dist_gd  # noqa: E402
from cocoa_torch.solvers.minibatch_cd import run_minibatch_cd  # noqa: E402
from cocoa_torch.solvers.prox_cocoa import run_prox_cocoa  # noqa: E402
from cocoa_torch.solvers.sgd import run_sgd  # noqa: E402


def run_case(data, mesh, case: dict):
    """One case: ``solver`` cocoa | cd | sgd | dist_gd | prox, with
    ``k``, ``layout``, ``rounds``, ``debug_iter``, ``h`` and the solver's
    options.  Returns (w, alpha or None, trajectory)."""
    part = (mesh.rank, mesh.size)
    k = case["k"]
    dt = torch.float64
    debug = DebugParams(debug_iter=case.get("debug_iter", 4), seed=3)
    loop = dict(device_loop=case.get("device_loop", False),
                scan_chunk=case.get("scan_chunk"))
    if case["solver"] == "prox":
        ds, b = shard_columns(data, k, dtype=dt, device="cpu",
                              layout=case["layout"], part=part)
        ds.mesh = mesh
        params = Params(n=data.n, num_rounds=case["rounds"],
                        local_iters=case["h"], lam=case["lam"],
                        smoothing=case.get("l2", 0.0))
        x, r, traj = run_prox_cocoa(
            ds, b, params, debug, rng=case.get("rng", "reference"),
            math=case.get("math", "fast"), block_size=case.get("block", 0),
            quiet=True, **loop)
        return r, x, traj
    ds = shard_dataset(data, k, layout=case["layout"], dtype=dt,
                       device="cpu", hot_cols=case.get("hot", 0), part=part)
    ds.mesh = mesh
    test = shard_dataset(data, k, layout=case["layout"], dtype=dt,
                         device="cpu", part=part)
    test.mesh = mesh
    params = Params(n=data.n, num_rounds=case["rounds"],
                    local_iters=case["h"], lam=case.get("lam", 0.01),
                    sigma=case.get("sigma"))
    kw = dict(test_ds=test, rng=case.get("rng", "reference"), quiet=True,
              **loop)
    solver = case["solver"]
    if solver == "cocoa":
        return run_cocoa(ds, params, debug, plus=case.get("plus", True),
                         math=case.get("math", "exact"),
                         block_size=case.get("block", 0),
                         gap_target=case.get("gap_target"),
                         accel=case.get("accel"),
                         sigma_schedule=case.get("schedule"), **kw)
    if solver == "cd":
        return run_minibatch_cd(ds, params, debug,
                                math=case.get("math", "exact"),
                                block_size=case.get("block", 0), **kw)
    if solver == "sgd":
        w, traj = run_sgd(ds, params, debug, local=case["local"], **kw)
        return w, None, traj
    kw.pop("rng")
    w, traj = run_dist_gd(ds, params, debug, **kw)
    return w, None, traj


def main() -> int:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    with np.load(sys.argv[4]) as f:
        data = LibsvmData(labels=f["labels"], indptr=f["indptr"],
                          indices=f["indices"], values=f["values"],
                          num_features=int(f["num_features"]))
    with open(sys.argv[5]) as f:
        cases = json.load(f)
    distributed.maybe_initialize(f"127.0.0.1:{port}", rank, world,
                                 timeout_s=120.0)
    mesh = make_mesh(None, "cpu")
    for case in cases:
        before = all_reduce_sum.calls
        try:
            w, alpha, traj = run_case(data, mesh, case)
        except Exception as e:  # reported beside the case, not raised
            print("RESULT " + json.dumps({"name": case["name"],
                                          "rank": rank,
                                          "error": repr(e)}), flush=True)
            continue
        calls = all_reduce_sum.calls - before
        out = {"name": case["name"], "rank": rank, "calls": calls,
               "w": w.tolist(),
               "alpha": (None if alpha is None else
                         distributed.host_gather_shards(alpha).tolist()),
               "records": [[r.round, r.primal, r.gap, r.test_error]
                           for r in traj.records],
               "stopped": traj.stopped}
        print("RESULT " + json.dumps(out), flush=True)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
