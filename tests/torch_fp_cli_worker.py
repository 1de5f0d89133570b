"""One rank of the CLI gangs of tests/test_torch_fp_cli.py.

    python tests/torch_fp_cli_worker.py RANK JOBS.json OUT

Runs each job of JOBS.json (a list of ``{"tag", "world", "port",
"argv"}``) whose gang holds this rank (RANK < world): ``cli.run`` on the
job's argv with the gang's flags, its standard output and error captured.
Writes OUT/rank<RANK>.json, ``{tag: {"rc", "out", "err"}}``, so that one
launch of the processes serves every job of the module.
"""

import contextlib
import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cocoa_torch import cli  # noqa: E402


def main() -> int:
    rank = int(sys.argv[1])
    with open(sys.argv[2]) as f:
        jobs = json.load(f)
    results = {}
    for job in jobs:
        if rank >= job["world"]:
            continue
        out, err = io.StringIO(), io.StringIO()
        argv = job["argv"] + [f"--master=127.0.0.1:{job['port']}",
                              f"--processId={rank}",
                              f"--numProcesses={job['world']}",
                              "--device=cpu"]
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.run(argv)[0]
        results[job["tag"]] = {"rc": rc, "out": out.getvalue(),
                               "err": err.getvalue()}
    with open(os.path.join(sys.argv[3], f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
