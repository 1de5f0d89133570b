"""One rank of a feature-parallel CPU gang for tests/test_torch_fp.py.

    python tests/torch_fp_worker.py RANK WORLD FP PORT DATA.npz CASES.json OUT

Joins a gloo gang of WORLD ranks at 127.0.0.1:PORT, makes its (WORLD/FP,
FP) mesh, and runs every case of CASES.json (a list of dicts, see
``run_case``) in float64 on its column block of the dataset named by the
case (``data`` keys the arrays of DATA.npz).  Writes OUT/rank<RANK>.npz
with, for each case ``c``: ``c/w`` the whole w gathered over the fp
peers, ``c/alpha`` the whole alpha gathered over the dp positions (when
the solver has one), ``c/alpha_local`` this rank's own alpha, ``c/gap``
the duality gap of the end state, ``c/records`` the eval records
(round, primal, gap, test error; NaN where there is none) and ``c/calls``
(the dp all-reduces, the fp sums).  A case that raises stores its error
as ``c/error``, and the gang goes on.
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
from cocoa_torch.data.libsvm import LibsvmData  # noqa: E402
from cocoa_torch.evals import objectives  # noqa: E402
from cocoa_torch.parallel import distributed  # noqa: E402
from cocoa_torch.parallel.fanout import all_reduce_sum, fp_gather, \
    fp_sum  # noqa: E402
from cocoa_torch.parallel.mesh import feature_part, local_part, \
    make_mesh  # noqa: E402
from cocoa_torch.solvers import run_cocoa  # noqa: E402
from cocoa_torch.solvers.dist_gd import run_dist_gd  # noqa: E402
from cocoa_torch.solvers.minibatch_cd import run_minibatch_cd  # noqa: E402
from cocoa_torch.solvers.sgd import run_sgd  # noqa: E402


def run_case(datasets, mesh, case: dict):
    """One case: ``solver`` cocoa | cd | sgd | dist_gd on ``data`` with
    ``k`` shards, ``rounds``, ``h``, ``debug_iter`` and the solver's
    options.  Returns (ds, w, alpha or None, trajectory)."""
    data = datasets[case.get("data", "tiny")]
    ds = shard_dataset(data, case["k"], layout="dense", dtype=torch.float64,
                       device="cpu", part=local_part(mesh),
                       cols=feature_part(mesh))
    ds.mesh = mesh
    params = Params(n=data.n, num_rounds=case["rounds"],
                    local_iters=case["h"], lam=case.get("lam", 0.01))
    debug = DebugParams(debug_iter=case["debug_iter"], seed=11)
    kw = dict(quiet=True, scan_chunk=case.get("scan_chunk"),
              device_loop=case.get("device_loop", False))
    solver = case["solver"]
    if solver == "cocoa":
        w, alpha, traj = run_cocoa(
            ds, params, debug, plus=case.get("plus", True),
            math=case.get("math", "exact"), block_size=case.get("block", 0),
            gap_target=case.get("gap_target"), accel=case.get("accel"), **kw)
    elif solver == "cd":
        w, alpha, traj = run_minibatch_cd(ds, params, debug, **kw)
    elif solver == "sgd":
        (w, traj), alpha = run_sgd(ds, params, debug, local=case["local"],
                                   **kw), None
    else:
        (w, traj), alpha = run_dist_gd(ds, params, debug, **kw), None
    return ds, params, w, alpha, traj


def main() -> int:
    rank, world, fp, port = (int(a) for a in sys.argv[1:5])
    with np.load(sys.argv[5]) as f:
        datasets = {
            name: LibsvmData(labels=f[f"{name}/labels"],
                             indptr=f[f"{name}/indptr"],
                             indices=f[f"{name}/indices"],
                             values=f[f"{name}/values"],
                             num_features=int(f[f"{name}/num_features"]))
            for name in {key.split("/")[0] for key in f.files}}
    with open(sys.argv[6]) as f:
        cases = json.load(f)
    distributed.maybe_initialize(f"127.0.0.1:{port}", rank, world,
                                 timeout_s=120.0)
    mesh = make_mesh(None, "cpu", fp=fp)
    out = {}
    for case in cases:
        name = case["name"]
        before = (all_reduce_sum.calls, fp_sum.calls)
        try:
            ds, params, w, alpha, traj = run_case(datasets, mesh, case)
        except Exception as e:  # stored beside the case, not raised
            out[f"{name}/error"] = np.array(repr(e))
            continue
        out[f"{name}/calls"] = np.array([all_reduce_sum.calls - before[0],
                                         fp_sum.calls - before[1]])
        out[f"{name}/w"] = fp_gather(w, mesh).numpy()
        if alpha is not None:
            out[f"{name}/alpha_local"] = alpha.numpy()
            out[f"{name}/alpha"] = distributed.host_gather_shards(
                alpha, 0, mesh.fp).numpy()
            out[f"{name}/gap"] = np.array(
                objectives.primal_objective(ds, w, params.lam)
                - objectives.dual_objective(ds, w, alpha, params.lam))
        out[f"{name}/records"] = np.array(
            [[r.round, r.primal, np.nan if r.gap is None else r.gap,
              np.nan if r.test_error is None else r.test_error]
             for r in traj.records], dtype=np.float64).reshape(-1, 4)
    np.savez(os.path.join(sys.argv[7], f"rank{rank}.npz"), **out)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
