#!/usr/bin/env python3
"""Where the time of an rcv1-like round goes on the card: torch.profiler
around CoCoA+ rounds of the port, on the unsplit and the hybrid
(``--hotCols=auto``) layouts, sequential and block (``--blockSize=128``),
each chunk of rounds a replayed CUDA graph.

    python3 profile_round.py [--rounds=100]      # one GPU

For each configuration it prints the wall clock per round between the
first eval and the last (past the first chunk, which a captured run
spends running eagerly and capturing), the device time per round summed
over CUDA kernels, their share of the wall clock, kernel launches per
round, and the kernels that take the most device time; then the same for
the device-resident run (``--deviceLoop``, :func:`profile_device_loop`),
whose evals inside a super-block carry no time, on the device's own
timeline past the first chunk and the capture.  The data are the
rcv1-like shape of chip_smoke.py (20 242 x 47 236, about 75 nonzeros a
row, from seed 0), K=8, H=253, lambda=1e-4, float32, evaluations every
25 rounds.
"""

from __future__ import annotations

import sys

import torch
from torch.profiler import ProfilerActivity, profile

from cocoa_torch.config import DebugParams, Params
from cocoa_torch.data import hybrid, shard_dataset
from cocoa_torch.data.synth import synth_sparse
from cocoa_torch.solvers import cocoa as cocoa_mod

SHAPE, K, LAM = (20242, 47236), 8, 1e-4


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_config(ds, block: int, rounds: int, top: int = 6,
                   capture: bool = True) -> dict:
    """Profile a run of ``rounds`` CoCoA+ rounds after a warm-up run;
    prints and returns the wall clock per round between its first eval
    and its last and the device time per round over the whole run (ms:
    the union of the device's events on its timeline, :func:`union_us`),
    the busy share and the kernel launches per round."""
    h = max(1, int(0.1 * ds.n / K))
    params = Params(n=ds.n, num_rounds=rounds, local_iters=h, lam=LAM)
    debug = DebugParams(debug_iter=25, seed=0)

    def run():
        traj = cocoa_mod.run_cocoa(ds, params, debug, plus=True,
                                   math="fast", block_size=block, quiet=True,
                                   capture=capture)[2]
        torch.cuda.synchronize()
        return traj

    run()  # warm-up: kernel loads, allocator
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traj = run()
    first, last = traj.records[0], traj.records[-1]
    wall = (last.wall_time - first.wall_time) * 1e3 / (last.round
                                                       - first.round)
    kernels = [e for e in prof.key_averages() if device_us(e) > 0
               and str(e.device_type).endswith("CUDA")]
    dev = union_us([(start, end) for _, start, end in device_events(prof)]
                   ) / 1e3 / rounds
    launches = sum(e.count for e in kernels) / rounds
    print(f"  wall {wall:.3f} ms per round (profiler on), device {dev:.3f} "
          f"ms per round ({dev / wall * 100:.1f} % busy), {launches:.1f} "
          f"kernel launches per round")
    for e in sorted(kernels, key=device_us, reverse=True)[:top]:
        print(f"    {device_us(e) / 1e3 / rounds:8.4f} ms/round "
              f"{e.count / rounds:6.1f}x  {e.key[:90]}")
    return {"wall_ms": wall, "device_ms": dev, "busy": dev / wall,
            "launches": launches}


def device_events(prof):
    """The device's events of a profile (kernels, copies, fills) as
    (name, start us, end us) on the device's timeline."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def union_us(spans) -> float:
    """The time (us) in which at least one of the (start, end) ``spans``
    runs: two kernels that overlap, on two streams, count once, so the
    busy share of a round whose work forks stays at or under 100 %."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def replay_window(events, main: str, rounds: int):
    """A captured run's replayed chunks in a profile, the device loop's or
    the chunked loop's: ``events`` are the run's device events as (name,
    start us, end us); a chunk's first step runs eagerly and the host then
    captures it, the device idle, so the longest pause between two
    launches of the ``main`` kernel ends the eager chunk.  Returns (wall ms, device ms, launches) per round over the
    rest of the run: the span from that launch to the last event's end,
    the union of the events' time in it (:func:`union_us`), and their
    count, over its rounds."""
    marks = sorted(start for name, start, _ in events if main in name)
    if len(marks) < 2:
        raise ValueError(f"no {main} launches in the profile")
    _, first = max((b - a, i + 1) for i, (a, b) in
                   enumerate(zip(marks, marks[1:])))
    t0 = marks[first]
    window = [(start, end) for _, start, end in events if start >= t0]
    r = (len(marks) - first) * rounds / len(marks)
    span = max(end for _, end in window) - t0
    return span / 1e3 / r, union_us(window) / 1e3 / r, len(window) / r


def profile_device_loop(ds, block: int, rounds: int, top: int = 6) -> dict:
    """:func:`profile_config` for the device loop (``--deviceLoop``),
    whose evals inside a super-block carry no time: one run of ``rounds``
    fixed rounds under the profiler after a warm-up run, measured on the
    device's own timeline over its replayed chunks
    (:func:`replay_window`), which leaves out the first chunk and the
    capture as :func:`profile_config` leaves out the first chunk.  Prints
    and returns them as :func:`profile_config` does."""
    h = max(1, int(0.1 * ds.n / K))
    params = Params(n=ds.n, num_rounds=rounds, local_iters=h, lam=LAM)
    debug = DebugParams(debug_iter=25, seed=0)

    def run():
        cocoa_mod.run_cocoa(ds, params, debug, plus=True, math="fast",
                            block_size=block, quiet=True, device_loop=True)
        torch.cuda.synchronize()

    run()  # warm-up: kernel loads, allocator
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    events = device_events(prof)
    main = "gram_kernel" if block else "sparse_sdca"
    wall, dev, launches = replay_window(events, main, rounds)
    print(f"  wall {wall:.3f} ms per round (profiler on, the device's "
          f"timeline past the first chunk), device {dev:.3f} ms per round "
          f"({dev / wall * 100:.1f} % busy), {launches:.1f} device events "
          f"per round")
    kernels = [e for e in prof.key_averages() if device_us(e) > 0
               and str(e.device_type).endswith("CUDA")]
    for e in sorted(kernels, key=device_us, reverse=True)[:top]:
        print(f"    {device_us(e) / 1e3 / rounds:8.4f} ms/round "
              f"{e.count / rounds:6.1f}x  {e.key[:90]}")
    return {"wall_ms": wall, "device_ms": dev, "busy": dev / wall,
            "launches": launches}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("error: profile_round.py needs a CUDA device", file=sys.stderr)
        return 1
    rounds = 100
    for arg in argv:
        if arg.startswith("--rounds="):
            rounds = int(arg.split("=", 1)[1])
    print(torch.cuda.get_device_name(0))
    data = synth_sparse(*SHAPE, nnz_mean=75, seed=0)
    width, _ = hybrid.resolve_hot_cols("auto", data, K, torch.float32)
    for hot in (0, width):
        ds = shard_dataset(data, K, layout="sparse", dtype=torch.float32,
                           device="cuda", hot_cols=hot)
        for block in (0, 128):
            print(f"{'hybrid, panel ' + str(hot) if hot else 'unsplit'}, "
                  f"{'block ' + str(block) if block else 'sequential'}, "
                  f"{rounds} CoCoA+ rounds:")
            profile_config(ds, block, rounds)
            print("  ... the same with --deviceLoop:")
            profile_device_loop(ds, block, rounds)
        del ds
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
