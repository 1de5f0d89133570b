"""Peak resident memory of one gang rank's ingest, by variant.

    python probe_ingest_memory.py [--device cuda|cpu] [--ranks 2]

Writes the rcv1-like file (``synth_sparse(20242, 47236, nnz_mean=75,
seed=0)`` as LIBSVM text, ~23 MB) under ``chiprun_out/``, then for each
variant starts ``--ranks`` processes that join one gloo gang on
localhost (CUDA initialised first on ``cuda``) and build their own
shards of K=8, float32, the sparse layout:

- ``whole``: ``load_libsvm`` of the whole file, ``shard_dataset(...,
  part=...)``;
- ``stream``: ``ingest.build_index`` (pass 1) and
  ``ingest.stream_shard_dataset`` (pass 2 on its thread pool);
- ``stream-seq``: the same with pass 2 on one thread;
- ``scan``: pass 1 alone.

Each process samples its resident set (``/proc/self/statm``) every
0.5 ms through the build and prints one ``PROBE <json>`` line: the peak
above its level before the build, what it still holds after, and the
resident set at each step's end (MiB), beside the MiB of the shards it
built (held on the host when ``--device=cpu``).  The table at the end
gives each variant's ranks.  Nothing here depends on the card but the device the
shards land on: run it on the CPU and on the card to compare the two
machines' accounting.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
SHAPE = (20242, 47236)
K = 8
VARIANTS = ("whole", "stream", "stream-seq", "scan")


def _rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def child(rank: int, world: int, port: int, variant: str, path: str,
          device: str) -> None:
    import torch

    from cocoa_torch.data import ingest, load_libsvm, shard_dataset

    if device == "cuda":
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world)
    torch.distributed.barrier()
    if variant == "stream-seq":
        ingest._pass2_workers = lambda n_tasks: 1
    d = SHAPE[1]
    marks = {}
    base = _rss()
    peak, done = [base], threading.Event()

    def sample():
        while not done.wait(0.0005):
            peak[0] = max(peak[0], _rss())

    def mark(step):
        marks[step] = (_rss() - base) / 2**20

    sampler = threading.Thread(target=sample)
    sampler.start()
    t0 = time.perf_counter()
    if variant == "whole":
        data = load_libsvm(path, d)
        mark("parsed")
        ds = shard_dataset(data, K, layout="sparse", device=device,
                           part=(rank, world))
        del data
    else:
        index = ingest.build_index(path, d)
        mark("scanned")
        if variant != "scan":
            ds, _ = ingest.stream_shard_dataset(
                path, d, K, layout="sparse", device=device,
                part=(rank, world), index=index)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    shards = 0 if variant == "scan" else sum(
        t.numel() * t.element_size() for t in ds.shard_arrays().values())
    done.set()
    sampler.join()
    after = _rss()
    print("PROBE " + json.dumps({
        "variant": variant, "rank": rank, "world": world,
        "device": device, "seconds": seconds,
        "peak_mib": (max(peak[0], after) - base) / 2**20,
        "held_mib": (after - base) / 2**20, "marks": marks,
        "shards_mib": shards / 2**20}), flush=True)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--child", nargs=5, metavar=("RANK", "WORLD", "PORT",
                                                 "VARIANT", "FILE"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.child:
        rank, world, port, variant, path = args.child
        child(int(rank), int(world), int(port), variant, path, args.device)
        return 0
    from cocoa_torch.data.synth import synth_sparse, write_libsvm

    OUT.mkdir(exist_ok=True)
    path = OUT / "probe_ingest_memory.svm"
    write_libsvm(synth_sparse(*SHAPE, nnz_mean=75, seed=0), str(path))
    size = os.path.getsize(path)
    rows, ok = [], True
    try:
        for variant in VARIANTS:
            port = str(_free_port())
            procs = [subprocess.Popen(
                [sys.executable, __file__, "--device", args.device,
                 "--child", str(r), str(args.ranks), port, variant,
                 str(path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True) for r in range(args.ranks)]
            for p in procs:
                try:
                    out, err = p.communicate(timeout=300)
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                        q.wait()
                    raise
                got = [json.loads(ln[6:]) for ln in out.splitlines()
                       if ln.startswith("PROBE ")]
                if p.returncode or not got:
                    print(f"{variant}: exited {p.returncode}: {err[-2000:]}",
                          file=sys.stderr)
                    ok = False
                rows += got
    finally:
        path.unlink(missing_ok=True)
    print(f"file {size} bytes, {args.ranks} ranks, device {args.device}")
    for r in rows:
        print(json.dumps(r))
        print(f"{r['variant']:>10} rank {r['rank']}: peak "
              f"+{r['peak_mib']:.1f} MiB, held +{r['held_mib']:.1f} MiB, "
              f"shards {r['shards_mib']:.1f} MiB, {r['seconds']:.4f} s, "
              + ", ".join(f"{k} +{v:.1f}" for k, v in r["marks"].items()))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
