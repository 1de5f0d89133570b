#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``cocoa_torch``).

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, each printed as it runs (one line per kernel-vs-plain case on
stderr); any failed check exits non-zero:

1. the card's name and power limit (nvidia-smi); build the five kernel
   libraries (one nvcc each, all started together) and time the build;
2. each kernel against its plain PyTorch version on the same CUDA tensors:
   the sparse SDCA round (B1) on the demo shards, on rcv1-like shards and
   on rows wider than its ring's slots, for modes cocoa/plus/frozen x
   losses hinge/smooth_hinge/logistic x float32/float64, at every plan
   (the auto ring depth and each depth 1..7, dw asked into shared and into
   global memory), with draws repeated at every distance from 1 to 9
   steps (inside and past the ring) and a real column 0 followed by
   padding; then the kernel's (both dw placements) and the plain
   version's time at the main path's shape, on its own draws, and B1 at
   each ring depth and in frozen mode, in us per step;
3. the bundled demo through the CLI entry point (CoCoA+ and CoCoA,
   --math=fast, float32): the gap falls and stays >= 0, CoCoA+ ends below
   1e-2, alpha stays in [0, 1], one launch per round, and every debugIter
   gap is within relative 1e-3 of the same run through the plain version;
   then the demo at bfloat16 with --math=fast for 20 rounds, sequential
   and in blocks of 8, through the plain versions (no kernel launched,
   finite gaps), and B1 called directly at bfloat16 refusing;
4. the main path: rcv1-like data (20 242 x 47 236, about 75 nonzeros a
   row, from a seed) through the CLI at K=8, H=253, lambda=1e-4, with
   CUDA events around each of its kernel launches;
5. the block kernels against their plain versions on the same CUDA
   tensors, at the shapes of the three block configurations: the chain
   (B3), the sparse Gram (B5) and the sparse apply (B6) on a demo and an
   rcv1-like block (K x 128 draws with repeats, crafted rows, a masked
   tail), B5 also on the block's rows with columns repeated within a row
   and with every live row at the full width, B6 on those rows and on a
   hot column in every row, at every plan (the auto plan and each asked
   slice count that fits), bit for bit with its plain version run on CPU
   copies of the same inputs; the fused block (B4) and
   the chain at B=256, 512 and 1024 on an epsilon-like block (8 x 128 x
   2000, and the split branch's full Gram), every mode x loss x dtype; B3
   at every plan (the auto plan, each ring depth up to it, each unit
   width's whole triangle where it fits), B5 at every plan (the auto plan
   and each rows_per_cta that fits, each with the default table and the
   least one that holds a row); two launches of B3, B5 and B6 bit for
   bit; B4 also at d=1000 and at B=100, each at every cluster size (1, 2,
   4, 8, and 16 where the card holds K such clusters) and the auto plan,
   two launches of the auto plan bit for bit; then each kernel's, its
   plain version's and a library call's time (B3 also at each plan, in
   frozen mode and at 8 x 512; B5 at each rows_per_cta, in float64 and on
   the hybrid residual; B6 at each plan, in float64, on the hybrid
   residual and on a hot column; B4 at each cluster size and in frozen
   mode, beside the Gram alone as one torch.bmm);
6. the block path (--blockSize): the demo and rcv1-like data through the
   CLI with --blockSize=auto (the sparse-Gram branch: B5, B3, B6), the
   rcv1-like gaps within relative 1e-3 of phase 4's sequential run; then
   epsilon-like data (400 000 x 2000, made on the card) through
   run_cocoa at B=128 (the fused branch, B4), B=256 and B=512 (the split
   branch, B3), three runs each in turns, with the launches of every
   kernel counted per round, every run's gaps within relative 1e-3 of the
   fused run's, and the block sizes ranked by ms per round;
7. the dense SDCA round (B2) against its plain version on the same CUDA
   tensors, with repeated draws (adjacent, and 2..7 steps apart: inside
   and past the ring of staged rows): modes cocoa/plus/frozen x the
   three losses x float32/float64 on the demo's dense shards and on the
   epsilon-like shards (K=8, H=5000, and H=2 and 13: fewer steps than
   ring slots, and a count that is not a multiple of them), and mode prox
   with the lasso rule at l2 0 and 0.1 on the lasso design (8192 x 32768
   made on the card, K=8, H=409), on a tall lasso design (100000 x 1024,
   K=8: rows of 100000 values, wider than a slot, streamed in chunks) and
   on the demo's dense column shards, each with w and dw asked into
   shared and into global memory, at the auto ring depth and at one slot;
   the sparse round (B1) in mode prox on the demo's padded-CSC column
   shards at every plan; then B2's time (the auto plan, each ring depth, the state in
   global memory) and its plain version's at the epsilon-like, lasso,
   demo (float32 and float64) and tall shapes on the main path's own
   draws, with the plan, us per step and the bound, two launches and
   every plan held bit for bit against each other;
8. the dense sequential path: epsilon-like data through run_cocoa on
   --math=fast with no block size, CoCoA+ and CoCoA for 30 rounds, one
   B2 launch per round, CoCoA+'s gaps within relative 1e-3 of phase 6's
   fused block run;
9. the new entry points: the demo through the CLI with --justCoCoA=false
   on the sparse layout (B1, mode frozen for mini-batch CD) and the dense
   one (B2), six algorithms, and with --objective=lasso on the sparse and
   dense column shards (B1 and B2 in mode prox), each against the same
   run through the plain versions (gaps within relative 1e-3) with its
   launches counted; then the lasso design at full width through
   run_prox_cocoa, lasso and elastic net (l2 = 0.1) at lambda =
   0.3*lambda_max: one B2 launch per round, a certified gap >= 0 that
   falls, ms per round and the round at which the gap first reaches
   1e-3 * |b|^2 / 2;
10. the hybrid hot/cold layout (--hotCols): B1's hot-panel branch (B1h)
   against its plain version at the rcv1-like and demo shapes with the
   panel width --hotCols=auto resolves (5248 and 896 columns), modes
   cocoa/plus/frozen x the three losses x float32/float64, mode prox on
   the demo, and the demo with every column hot (padding lanes at column
   0 beside a real column 0; too many panel lanes for registers), each
   at every plan as in phase 2, with repeats inside and past the ring;
   B5, B3 and B6 on the rcv1-like residual with the panel's terms; B1h's
   time beside the unsplit B1's on the main path's draws, and at each
   ring depth and in frozen mode;
   the rcv1-like data through the CLI with --hotCols=auto for 200 rounds,
   sequentially (one B1h launch a round) and with --blockSize=auto, the
   gaps within relative 1e-3 of phase 4's unsplit run; and the demo with
   --hotCols=auto --justCoCoA=false;
11. ProxCoCoA+ through the block round (--objective=lasso --blockSize):
   B4 (cluster sizes 1, 2, 4, 8 and the auto plan) on blocks of the lasso
   design, the tall design and the demo's dense columns (d = n: 8192,
   100000 and 2000), B3 at every plan at B=128 and 512 on the lasso
   design's split inputs, and B5 (every plan, in passes too), B3 and B6
   (into Delta-r) on the demo's padded-CSC columns (1738 wide), all in
   mode prox with the lasso rule at l2 0 and 0.1, float32 and float64,
   against their plain versions, two launches of each bit for bit; B5 on
   rows 1560, 1738 and 20000 wide in float32 and 1028 and 1738 in
   float64 (the widest in passes), against its plain version and timed,
   the widest of each dtype bit for bit; B4, B3, B5 and B6 timed at those
   prox shapes (float32); then the demo's columns through
   the CLI with --blockSize=128 on both layouts (B4; B5, B3, B6), the
   lasso design through run_prox_cocoa at B=128 (fused: B4) and B=512
   (split: B3), lasso and elastic net, for 1000 rounds, in float32 and
   in float64 (beside float64 sequential runs), and the tall design
   through the fused branch beside its sequential run: launches counted,
   every eval's gap within relative 1e-3 of the sequential run (phase
   9's in float32, where the lasso design's last gaps are a few float32
   ulps of the primal and 4 of those are allowed beside), ms per round
   and the round that reaches 1e-3 * |b|^2 / 2.
12. the gap-targeted driver ladder, float32, --math=fast, every
   kernel's count set to 0 before each run and read after it: (a) the
   demo through the CLI to a 1e-4 gap (--numRounds=500, accel auto: the
   secant jump on CoCoA+), against the same command through the plain
   versions: the same stop reason, stop rounds within one debugIter,
   every common eval's gap within relative 1e-3; (b) the demo with
   --sigma=auto (the anneal), --sigma=auto --sigmaSchedule=trial and
   --warmStart=0.5,30, their stop reasons and sigma' on each record; (c)
   rcv1-like data (K=8, H=253, lambda=1e-4, --rng=permuted) with sigma'
   auto to a 1e-4 gap, no backoff, its stop round beside JAX's pin (575),
   then the safe sigma' with accel auto and off, rounds and seconds to
   the gap; (d) the same sigma' auto run through the block path at B=128
   (B5, B3, B6), its gaps within relative 1e-3 of (c)'s; (e) the coherent
   shards of tests/test_divergence.py (sigma' = 1, K = 4, dense: B2) bail
   out DIVERGED at the same round as through the plain version; (f) the
   lasso design, lasso and elastic net, to 1e-3 * |b|^2 / 2 sequentially
   (B2) and at B=512 (split: B3), the stop rounds beside the 550 / 350 of
   phase 9.  Each case prints its seconds to the stop and its launches.
13. the chunked round loop (every run above already replays each chunk
   of rounds as one CUDA graph, its draw tables made on the card): (a)
   the draw kernel against the host tables bit for bit in the three
   --rng modes at the demo's, rcv1-like and epsilon-like chunks and on
   shards near 2^30 rows, first rounds 1 and ~1e6, seeds 0 and 2^31 - 1
   - the last round; its time per launch, its plain version's and its
   bound, and one lane alone; (b) rcv1-like sequential (B1), block (B5,
   B3, B6) and hybrid (B1h), epsilon-like sequential (B2) and fused
   B=128 (B4), the lasso design (B2 prox) and the demo's menu (SGD,
   DistGD, mini-batch CD) run eager, captured, captured, eager, each
   run's launches counted: the two eager runs, the two captured runs,
   and the captured and the eager run, each pair bit for bit (the block
   round adds its alpha deltas in slot order); (c) their ms per round
   past the first chunk in those turns, and each graph's capture time; (d) the
   rcv1-like permuted sigma' auto run to 1e-4 eager with host tables,
   captured with host tables and captured with device tables, and the
   demo to 1e-4, in turns; (e) busy shares by profile_round.py's method,
   rcv1-like sequential, block and hybrid, captured and eager.
14. the device-resident run (--deviceLoop): the card's torch, CUDA and
   driver versions and whether torch has CUDA graph conditional nodes
   (probe_conditional.py; without them the loop takes design B), then
   each configuration chunked (captured), with --deviceLoop twice, and
   chunked again, every kernel's count set to 0 before each run and read
   after: (a) rcv1-like sigma' auto to 1e-4 (B1, 575 rounds); (b) the
   safe sigma' with accel auto and off; (c) its block path (B5, B3, B6);
   (d) the lasso design, lasso and elastic net, to 1e-3 |b|^2/2 (B2);
   (e) epsilon-like fused B=128 (B4) and sequential (B2), 30 rounds; (f)
   the demo's menu through the CLI; (g) the coherent shards' bail-out
   (B2, DIVERGED at 425); (h) rcv1-like hybrid, 100 rounds (B1h).  The
   device loop launches what the chunked run launches, stops where it
   stops, equals it bit for bit where the two chunked runs agree bit for
   bit (else within relative 1e-3 with equal rounds), reads the card once
   a run (and once a change of sigma'), and stamps only its last record;
   each run's stop round, seconds, ms per round, fetches, capture seconds
   and dead chunks are printed in turns; then busy shares of rcv1-like
   sequential and block rounds, chunked and device loop.
15. checkpoints and --resume (cocoa_torch/checkpoint.py, the JAX
   package's file format), every kernel's count set to 0 before each
   in-process run and read after: (a) each configuration run
   uninterrupted, run to a mid-run checkpoint, and resumed from it
   (``latest`` and ``load_full``, as --resume), chunked and with
   --deviceLoop: rcv1-like sigma' auto to 1e-4 (B1; a mid-schedule sched
   vector), the safe sigma' with accel auto (a mid-momentum bank), its
   block path (B5, B3, B6) and the hybrid (B1h), the lasso design
   sequentially (B2) and fused B=128 (B4), and the demo's menu through
   the CLI; each resume equals its uninterrupted run past the resume
   point, records and final (w, alpha), bit for bit (DistGD's too: its
   sparse pass adds in slot order); then a device-loop
   resume that saves at its stop mid-super-block while a dead chunk
   replays, its checkpoint the state it returns; (b) the demo through
   ``python -m cocoa_torch.cli``, chunked and --deviceLoop side by side,
   SIGKILLed once its first checkpoint exists and relaunched with
   --resume: the summary lines of an uninterrupted run; (c) a torn
   newest generation: the resume falls back to the previous one and ends
   bit for bit; (d) seconds a save at rcv1-like and lasso-design shapes,
   and seconds to the 1e-4 gap for rcv1-like sigma' auto with
   --chkptIter=100 and without, chunked and device loop, in turns, each
   beside the card's name and power limit.
16. the rest of the single-GPU training surface, float32, every
   kernel's count set to 0 before each in-process run and read after:
   (a) --blockPipeline: epsilon-like fused B=128 (B4) and split B=512
   (B3) and the lasso design fused B=128 (B4, ProxCoCoA+), each off, on,
   on, off on the captured chunked loop and on --deviceLoop: the runs
   of a loop bit for bit, the same launches, ms per round past the
   first chunk and the capture (the device loop's on the device's
   timeline, with the busy share there: profile_round.py's union of
   kernel spans), ms per round of the whole run and ms capturing; the
   captured round forking into concurrent branches with the pipeline on
   and not off (its DOT dump), on == off bit for bit; (b) --evalDense: rcv1-like
   sequential (B1) and block (B5, B3, B6) runs without, with, with and
   without the dense eval twin: training bit for bit, evals within
   relative 1e-5, ms per round with evals, ms per eval with the twin
   and with the sparse gather, and the evalDense=auto lines (rcv1-like
   over the 2 GiB budget, the demo under it); (c) the native LIBSVM
   parser built and taken by load_libsvm, bit for bit with the Python
   parser, both timed on the demo and on an rcv1-like file; (d) the demo
   menu twice, every algorithm bit for bit (DistGD included), and
   DistGD's ms per round with the atomic scatter and the order-stable
   one in turns; (e) ``python -m cocoa_torch`` on the demo in a
   subprocess; (f) the rcv1-like block round (B5, B3, B6) on reference
   draws, which repeat a row in most blocks, twice, bit for bit.
17. telemetry (cocoa_torch/telemetry/), through the CLI on the rcv1-like
   file, sigma' auto to the 1e-4 gap on permuted draws, --chkptIter=100,
   every kernel's count set to 0 before each run and read after: the
   sequential run (B1) chunked and with --deviceLoop, each off, on, on,
   off ("on": --events --metrics --trace --flightRecorder=on), one
   chunked "on" run with --metricsInterval=10, and the block path
   (B=128: B5, B3, B6) on --deviceLoop off, on, off; on
   against off w and alpha bit for bit, the same fetches, saves and
   launches; every stream valid under the port's schema, its round_eval
   rounds and gaps the trajectory's, one checkpoint_write event and one
   checkpoint_save span a save, the metrics textfile counting every
   eval; the seconds to the gap in turns; then --profile=DIR,100,200 on
   the chunked run and on the block path's --deviceLoop run, and
   --profile=DIR (the whole run, the profiler started before the graphs
   are captured) on the chunked run: each trace holds each kernel of its
   path (B1; B5, B3, B6) by name, at most once a launch and at least 90 %
   of the launches queued while the profiler ran, and the whole-run
   profile's w and alpha are the unprofiled run's bit for bit; and
   ``python -m cocoa_torch`` SIGTERMed at its first eval leaving a valid
   ``.flightrec``.
18. serving (cocoa_torch/serving/, ``--serve``), in processes of the CLI
   on the card beside this one: (a) a trainer (rcv1-like, CoCoA+, a
   checkpoint each 50 rounds) and ``--serve=0 --serveMaxNnz=548`` beside
   it, lines of 1, 64, 256 and 1024 rows while it trains, every margin
   against a host float64 w.x of the generation its response names
   (each generation hard-linked aside by a separate process as it
   lands), within 1e-5 of sum |w x|, no failed line, rounds
   non-decreasing, at least three generations answered; after the
   trainer stops, the server's margins bit for bit a cold start on the
   last generation; (e) f32 serve_margins bit for bit shard_margins, and
   its ms a batch by CUDA events per bucket x form (f32, bf16, int8) x
   plain or hot panel beside its byte bound, and queries/s and p50/p99
   latency through the TCP server; (b)
   ``--serveDtype=bf16`` and ``int8`` servers: each response's dtype the
   one its generation's model_quantize event served, quantized margins
   within the event's bound of the f32 ones, and in process a forced
   fallback bit for bit the f32 control and a forced quantized stack
   within its certificate; (c) ``--hotCols=auto --trainFile`` against
   the plain server within 1e-5 of sum |w x|; (d) ``--serveReplicas=2
   --serveRoute=tenant`` over a (4, d) catalogue the port saved: bit for
   bit four solo servers, a replica SIGKILLed under traffic with no
   failed line, a requeue and a respawn, ``--statusPort``'s /metrics,
   /healthz and /slo, one query_trace a traced line.
19. fleet training (``--fleet``; cocoa_torch/data/fleet.py,
   solvers/fleet.py; plain torch, no kernel of the table): (a) 256
   synthetic tenants (n=128, d=64, gap target 1e-2) through ``python -m
   cocoa_torch.cli --fleet`` on vmap lanes with ``--events`` and
   ``--metrics``: every tenant certified, the stream valid, the final
   fleet_progress carrying models/s, one loop fetch; then 16 of the
   tenants as solo runs in-process, models/s of each; (b) one-tenant
   fleets against the solo run bit for bit at --math=exact (plain,
   sigma' auto, accel on) and at --math=fast (the solo plain round; the
   solo B2 run within relative 1e-3), four tenants of unequal lambda on
   map lanes each its solo run's bits, and an early-certified lane
   frozen from its eval on; (c) a lambda path of 64 tenants over one
   8192 x 2048 set (K=4, H=204): ms per round of a replayed step, the
   capture's seconds, the tenants certified and their rounds, models/s,
   dead replays, the busy share of a shorter profiled run, and 2 of
   the tenants' solo certified rounds against theirs; (d) the
   block round's alpha update, the atomic scatter it replaced and the
   order-stable one in turns (time_block_round.py's ``measure``), both
   rounds' bits;
20. the gang (``--master``, ``--processId``, ``--numProcesses``;
   cocoa_torch/parallel/): the draw kernel given a first global lane
   against the whole run's rows; (a) two ranks of ``cli.run`` as
   processes sharing the card over the gloo device group, the rcv1-like
   file at K=8 (m=4 a rank), sequential B1 for 100 rounds with
   --chkptDir beside the solo run of the same flags: the ranks bit for
   bit, their checkpoints bit for bit, the gang's gaps, w and alpha
   within 1e-3 of the solo run's (relative, and of the largest entry),
   and the solo process resuming the gang's file as the uninterrupted
   solo run goes on; (b) the same gang with --blockSize=128 (B5, B3, B6)
   and the demo's --justCoCoA=false menu, each rank's launches against
   the m-shard prediction (one batched launch a round or block, as the
   solo run's); (c) NCCL at one rank, the captured chunk loop and
   --deviceLoop bit for bit with the runs without --master, the
   all-reduce counted once a round and an eval inside the replayed
   graphs; (d) ms per round of the three and the all-reduce of 47 236
   float32 alone over gloo (two ranks) and NCCL (one rank);
21. streamed ingest and the slab cache (``--ingest``, ``--ingestCache``;
   cocoa_torch/data/ingest.py, slab_cache.py): (a) the rcv1-like file
   written as LIBSVM text and run through ``cli.run`` whole, streamed,
   cache cold, cache warm and whole-mode warm, device shards, w and alpha
   bit for bit, the warm runs reading no byte; (b) ``--hotCols=auto``
   streamed against whole (B1h), the demo's dense layout streamed (B2) and
   its hybrid through the cache, bit for bit; (c) two ranks streaming
   beside two reading the whole file, and four streaming, as processes of
   ``cli.run``: every shard bit for bit across the modes and gang sizes,
   w and alpha across the modes, rows tiling n, a streamed rank of four
   reading under 0.6 of the file in its two passes, and each rank's peak
   resident set above its level before the ingest, sampled through it.

The line before the last lists every kernel with its launches on the main
paths (a replayed graph's launches counted at each replay; phase 14's
device-loop runs and phase 15's, 16's and 17's in-process runs
included; phase 18's serving runs no kernel of the table; phase 20's
processes count their own, printed with it), its error
against the plain version and its times; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script fails before printing a result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from cocoa_torch import checkpoint, cli, kernels
from cocoa_torch.config import DebugParams, Params, RunConfig
from cocoa_torch.data import hybrid, load_libsvm, shard_dataset
from cocoa_torch.data import ingest as ingest_lib
from cocoa_torch.data.libsvm import LibsvmData
from cocoa_torch.data.columns import shard_columns
from cocoa_torch.data.synth import synth_dense_sharded, \
    synth_lasso_columns, synth_sparse, write_libsvm
from cocoa_torch.ops import block_chain as bc
from cocoa_torch.ops import dense_sdca as dn
from cocoa_torch.ops import sparse_block as sb
from cocoa_torch.ops import sparse_sdca as sp
from cocoa_torch.ops.local_sdca import dense_rows, mode_factors
from cocoa_torch.ops.rows import gather_rows, row_lengths
from cocoa_torch.solvers import base
from cocoa_torch.solvers import cocoa as cocoa_mod
from cocoa_torch.solvers.prox_cocoa import run_prox_cocoa
from cocoa_torch.utils import prng
from cocoa_torch.utils.logging import Trajectory

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
DEMO_TRAIN = ROOT / "data" / "small_train.dat"
DEMO_TEST = ROOT / "data" / "small_test.dat"

# full-width shapes: rcv1-like (n, d); epsilon-like (n, d, K) as at
# benchmarks/run.py:407; the lasso design (n, d, K) of benchmarks/run.py
# bench_lasso, run to a relative gap of 1e-3 within LASSO_ROUNDS rounds;
# a tall lasso design whose columns (B2's rows) are wider than a slot
RCV1_SHAPE = (20242, 47236)
# sparse rows wider than B1's ring slots (n, d, mean nonzeros a row): the
# first entries staged, the rest read in the step, dw in shared memory
WIDE_SHAPE = (2000, 20000, 2000)
EPS_SHAPE = (400_000, 2000, 8)
LASSO_SHAPE = (8192, 32768, 8)
TALL_LASSO_SHAPE = (100_000, 1024, 8)
LASSO_ROUNDS = 1000
PROX_L2 = (0.0, 0.1)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 3.35 TB/s; FP32 and
# FP64 outside the tensor cores 67 and 34 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

# kernel vs plain: the kernel sums a row's products in warp-strided order
# with fused multiply-adds and reads each margin in-kernel, the plain
# version takes the round's margins X.w up front; the rounding difference
# passes through H dependent steps.  Relative to max(1, max |plain|).
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# a round kernel's (dw, alpha): each against max(1, its own max |plain|)
ROUND_FLOORS = (1.0, 1.0)
MODES = (("cocoa", 1.0), ("plus", None), ("frozen", 1.0))
LOSSES = ("hinge", "smooth_hinge", "logistic")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call, CUDA events around ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean ms per call of ``reps`` calls captured in one CUDA graph and
    replayed three times between CUDA events: the kernels alone, back to
    back, without the wrapper's host time (which bounds :func:`cuda_ms`
    for a kernel shorter than its wrapper)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (3 * reps)


def round_inputs(ds, h: int, seed: int, prox: bool = False,
                 repeats: bool = True):
    """Random w and alpha (unbounded coordinates for ``prox``), and
    reference-mode draws: the main path's own, or with ``repeats`` forced
    repeats on top (every fourth step redraws the row of the step before
    it), for the correctness cases."""
    rng = np.random.default_rng(seed)
    dev, dt = ds.device, ds.dtype
    w = torch.as_tensor(rng.normal(size=ds.num_features) * 0.1).to(dev, dt)
    alpha = rng.normal(size=(ds.k, ds.n_shard)) * 0.3
    if not prox:
        alpha = np.clip(alpha + 0.3, 0, 1)
    alpha = torch.as_tensor(alpha * ds.mask.cpu().numpy()).to(dev, dt)
    idxs = base.IndexSampler("reference", seed, h, ds.counts) \
        .round_indices(1).clone()
    if repeats:
        idxs[:, 1::4] = idxs[:, 0::4][:, :idxs[:, 1::4].shape[1]]
    return w, alpha, idxs.to(dev).contiguous()


def distinct_rows(idxs):
    """Per shard, the rows that a round's draws read at least once: a row
    drawn again is read once from memory, so a bound counts it once."""
    return [torch.unique(r.long()) for r in idxs]


def column0_rows(ds, idxs):
    """Rows 0-2 of shard 0 become crafted rows, drawn again and again at
    the round's first steps: a real column 0 followed by padding, column 0
    inside the row, and a column repeated within the row."""
    spi, spv, sq = ds.sp_indices.clone(), ds.sp_values.clone(), \
        ds.sq_norms.clone()
    rows = [0, 1, 2]
    crafted = ([(0, 0.9)], [(3, 0.2), (0, 0.5), (11, 0.1)],
               [(7, 0.3), (7, 0.2), (2, 0.6)])
    for r, slots in zip(rows, crafted):
        spi[0, r] = 0
        spv[0, r] = 0
        for j, (f, v) in enumerate(slots):
            spi[0, r, j] = f
            spv[0, r, j] = v
        sq[0, r] = sum(v * v for _, v in slots)
    idxs = idxs.clone()
    order = [0, 1, 0, 2, 1, 0, 2, 2][:idxs.shape[1]]
    idxs[0, :len(order)] = torch.as_tensor([rows[o] for o in order])
    return spi, spv, sq, idxs


# B1's and B1h's plans held against the plain version: the auto ring
# depth and every depth, each with dw asked into shared and into global
# memory
SPARSE_PLANS = [(smem, stages) for smem in (True, False)
                for stages in (None, *range(1, sp.MAX_STAGES + 1))]


def sparse_repeats(idxs):
    """Draws with repeats at every distance from 1 (round_inputs) to two
    past the deepest ring of B1's producers (window_repeats)."""
    return window_repeats(idxs, span=sp.MAX_STAGES + 3)


def sparse_plan_of(ds, smem, stages):
    n_hot = 0 if ds.X_hot is None else ds.n_hot
    return sp.sparse_plan(ds.sp_indices.shape[-1], ds.num_features,
                          ds.sp_values.element_size(),
                          kernels.smem_optin(ds.sp_values.device), smem,
                          stages, n_hot)


def held_at_every_plan(tag, ds, args, kw, want, dt, worst, name, plans):
    """The kernel at every plan of SPARSE_PLANS against ``want``; the plans
    met are added to ``plans``, each with the row width."""
    for smem, stages in SPARSE_PLANS:
        plan = sparse_plan_of(ds, smem, stages)
        plans.add((plan, ds.sp_indices.shape[-1]))
        agree(f"{tag} dw_in_smem={smem} stages={stages} plan={plan}",
              sp.sparse_sdca_round(*args, dw_in_smem=smem, stages=stages,
                                   **kw),
              want, dt, worst, name, ROUND_FLOORS)


def phase_kernel_vs_plain(shapes):
    """Every mode x loss x dtype case at each shape, plus the crafted
    column-0 rows, at every plan (SPARSE_PLANS) on draws with repeats at
    every distance inside and past the ring.  ``dw_in_smem=True`` is
    shared memory only where dw fits (not rcv1-like float64).  Returns the
    largest error and the plans met."""
    worst, plans = {}, set()
    for name, (data, k, h, lam) in shapes.items():
        for dt in (torch.float32, torch.float64):
            ds = shard_dataset(data, k, layout="sparse", dtype=dt,
                               device="cuda")
            w, alpha, idxs = round_inputs(ds, h, seed=3)
            idxs = sparse_repeats(idxs)
            cases = [(ds.sp_indices, ds.sp_values, ds.sq_norms, idxs, mode,
                      sigma, loss, f"{mode}/{loss}")
                     for mode, sigma in MODES for loss in LOSSES]
            spi, spv, sq, idxs0 = column0_rows(ds, idxs)
            cases += [(spi, spv, sq, idxs0, mode, float(k), loss,
                       f"column-0 rows {mode}/{loss}")
                      for mode, loss in (("plus", "hinge"),
                                         ("cocoa", "logistic"))]
            for spi, spv, sq, ix, mode, sigma, loss, case in cases:
                args = (w, alpha, spi, spv, ds.labels, sq, ix, lam, ds.n)
                kw = dict(mode=mode, sigma=sigma or float(k), loss=loss,
                          smoothing=1.0)
                held_at_every_plan(f"{name} {str(dt)[6:]} {case}", ds, args,
                                   kw, sp.sparse_sdca_round_plain(*args, **kw),
                                   dt, worst, "B1", plans)
    return worst["B1"], plans


def phase_timing(data, k, h, lam):
    """Kernel (dw in shared memory, then in global memory) and plain ms
    per round at the main path's shape (float32, CoCoA+, hinge) on its
    own draws, and the bound for the same work."""
    ds = shard_dataset(data, k, layout="sparse", dtype=torch.float32,
                       device="cuda")
    w, alpha, idxs = round_inputs(ds, h, seed=5, repeats=False)
    row_len = sp.row_lengths(ds.sp_values)
    args = (w, alpha, ds.sp_indices, ds.sp_values, ds.labels, ds.sq_norms,
            idxs, lam, ds.n)
    kw = dict(mode="plus", sigma=float(k), loss="hinge")
    ms = cuda_ms(lambda: sp.sparse_sdca_round(*args, row_len=row_len, **kw),
                 50)
    global_ms = cuda_ms(lambda: sp.sparse_sdca_round(
        *args, row_len=row_len, dw_in_smem=False, **kw), 50)
    plain_ms = cuda_ms(lambda: sp.sparse_sdca_round_plain(*args, **kw), 3)
    # each input read once, each output written once: the distinct sampled
    # rows' slots (int32 column + value) with their y, |x|^2 and row
    # length, w, the (K, d) dw written, alpha read and written, and each
    # step's draw
    isz = 4
    rows = distinct_rows(idxs)
    nnz = sum(int(row_len[s, r].sum()) for s, r in enumerate(rows))
    n_bytes = (nnz * (4 + isz) + sum(r.numel() for r in rows) * (2 * isz + 4)
               + ds.num_features * isz + k * ds.num_features * isz
               + 2 * k * ds.n_shard * isz + k * h * 4)
    # per step's nonzero, margin: w + s*dw and the product-sum; scatter: 2
    flops = 6 * int(row_len.gather(1, idxs.long()).sum())
    bound_ms = max(n_bytes / HBM_BYTES_PER_S,
                   flops / PEAK_FLOPS[torch.float32]) * 1e3
    bound_by = ("bytes" if n_bytes / HBM_BYTES_PER_S
                >= flops / PEAK_FLOPS[torch.float32] else "operations")
    return ms, global_ms, plain_ms, bound_ms, bound_by, n_bytes, nnz


def stage_timing(ds, k, h, lam, reps=50):
    """B1 (or B1h on a hybrid ``ds``) at each plan of SPARSE_PLANS'
    depths with dw where auto puts it, dw asked into global memory, and
    frozen mode at the auto plan (float32, CoCoA+, hinge; the main path's
    draws): {plan name: (plan, ms)}.  Every plan's result equals the auto
    plan's bit for bit wherever no row repeats a column: the plan changes
    no lane's order of operations."""
    w, alpha, idxs = round_inputs(ds, h, seed=5, repeats=False)
    hot = {} if ds.X_hot is None else dict(hot_cols=ds.hot_cols,
                                           hot_panel=ds.X_hot)
    args = (w, alpha, ds.sp_indices, ds.sp_values, ds.labels, ds.sq_norms,
            idxs, lam, ds.n)
    rl = row_lengths(ds.sp_values)
    kw = dict(mode="plus", sigma=float(k), loss="hinge", row_len=rl, **hot)
    plans = {"auto": {}, **{f"stages={s}": dict(stages=s)
                            for s in range(1, sp.MAX_STAGES + 1)},
             "global": dict(dw_in_smem=False)}
    first = sp.sparse_sdca_round(*args, **kw)
    out = {}
    for name, plan in plans.items():
        got = sp.sparse_sdca_round(*args, **plan, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(first, got)),
              f"sparse_sdca_round: plan {name} differs from auto")
        out[name] = (sparse_plan_of(ds, plan.get("dw_in_smem", True),
                                    plan.get("stages")),
                     cuda_ms(lambda: sp.sparse_sdca_round(*args, **plan,
                                                          **kw), reps))
    frozen = dict(kw, mode="frozen", sigma=1.0)
    out["frozen"] = (out["auto"][0], cuda_ms(
        lambda: sp.sparse_sdca_round(*args, **frozen), reps))
    return out


def print_stage_timing(label, t, h):
    print(f"  {label}: " + "; ".join(
        f"{name} {plan} {ms:.4f} ms ({ms * 1e3 / h:.3f} us per step)"
        for name, (plan, ms) in t.items()))


def run_cli(argv, capture=None):
    """cocoa_torch.cli through its entry point (each chunk of rounds a
    replayed CUDA graph unless ``capture`` is False); stdout is captured
    and returned with the results."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, results = cli.run(argv, capture=capture)
    check(rc == 0, f"cli exited {rc} for {' '.join(argv)}")
    return buf.getvalue(), results


def check_run(results, label: str):
    for r in results:
        gaps = [rec.gap for rec in r.trajectory.records]
        check(all(np.isfinite(g) and g >= 0 for g in gaps),
              f"{label} {r.algorithm}: gaps not finite and >= 0: {gaps}")
        check(gaps[-1] < gaps[0], f"{label} {r.algorithm}: gap did not fall")
        a_min, a_max = float(r.alpha.min()), float(r.alpha.max())
        check(0.0 <= a_min and a_max <= 1.0,
              f"{label} {r.algorithm}: alpha outside [0, 1]: "
              f"[{a_min}, {a_max}]")
        check(bool(torch.isfinite(r.w).all()), f"{label}: w not finite")
        print(f"  {label} {r.algorithm}: round:gap@wall-ms "
              + " ".join(f"{rec.round}:{rec.gap:.6g}@{rec.wall_time * 1e3:.1f}"
                         for rec in r.trajectory.records))


def phase_bf16(demo):
    """bfloat16 on the card: the demo through the CLI with --math=fast for
    20 rounds, sequential and in blocks of 8, every kernel's count set to
    0 before each run and read after it: the routes send a 2-byte dtype to
    the plain versions on every device, so each run exits 0 with finite
    gaps >= 0 and launches no kernel; and the sparse SDCA kernel (B1)
    called directly at bfloat16 still refuses.  Returns the runs' round
    lines."""
    argv = [f"--trainFile={DEMO_TRAIN}", "--numFeatures=9947",
            "--numSplits=4", "--numRounds=20", "--localIterFrac=0.1",
            "--lambda=.001", "--math=fast", "--dtype=bfloat16"]
    lines = {}
    for label, extra in (("sequential", []), ("block 8", ["--blockSize=8"])):
        reset_counts()
        out, res = run_cli(argv + extra)
        launched = counts()
        check(not any(launched.values()),
              f"bf16 demo {label}: kernels launched {launched}")
        check(len(res) == 2 and all(
            np.isfinite(rec.gap) and rec.gap >= 0
            for r in res for rec in r.trajectory.records),
            f"bf16 demo {label}: gaps not finite and >= 0")
        lines[label] = [f"{r.algorithm} {rec.round}:{rec.primal}/{rec.gap}"
                        for r in res for rec in r.trajectory.records]
    ds = shard_dataset(demo, 4, layout="sparse", dtype=torch.float32,
                       device="cuda")
    w, alpha, idxs = (t.to(torch.bfloat16) if t.is_floating_point() else t
                      for t in round_inputs(ds, 50, 3))
    try:
        sp.sparse_sdca_round(w, alpha, ds.sp_indices, ds.sp_values,
                             ds.labels, ds.sq_norms, idxs.int(), 1e-3, ds.n)
    except ValueError as e:
        check("float32 or float64" in str(e), f"B1 at bf16: {e}")
    else:
        check(False, "B1 ran at bfloat16")
    return lines


BLOCK = 128
# the epsilon-like block path's sizes (B, route, its kernel), each run
# EPS_BLOCK_RUNS times in turns: the host-bound glue moves between runs
EPS_BLOCKS = ((BLOCK, "fused", "B4"), (2 * BLOCK, "split", "B3"),
              (4 * BLOCK, "split", "B3"))
EPS_BLOCK_RUNS = 3
# each kernel's wrapper and the attribute that counts its launches; B1h is
# B1's hot-panel branch (the hybrid layout), counted apart from B1's
KERNELS = {"B1": (sp.sparse_sdca_round, "launches"),
           "B1h": (sp.sparse_sdca_round, "hybrid_launches"),
           "B2": (dn.dense_sdca_round, "launches"),
           "B3": (bc.chain_block_batched, "launches"),
           "B4": (bc.fused_block, "launches"),
           "B5": (sb.sparse_block_gram, "launches"),
           "B6": (sb.sparse_block_apply, "launches")}


def counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in KERNELS.items()}


def reset_counts() -> None:
    for fn, attr in KERNELS.values():
        setattr(fn, attr, 0)


def agree(tag, got, want, dtype, worst, name, floors=None):
    """Kernel outputs ``got`` against the plain version's ``want`` (pairs
    of tensors; a None pair is skipped), each within TOL relative to its
    own scale max(floor, max |plain|): ``floors`` gives one floor per
    output (default 0, relative to the output's own largest entry), e.g.
    1 for alpha deltas, which live in [-1, 1].  The largest error is kept
    in ``worst[name]``."""
    torch.cuda.synchronize()
    floors = floors or (0.0,) * len(want)
    err = 0.0
    for g, w, floor in zip(got, want, floors):
        check((g is None) == (w is None), f"{tag}: outputs differ in kind")
        if w is None:
            continue
        e = float((g - w).abs().max())
        scale = max(floor, float(w.abs().max()))
        check(bool(torch.isfinite(g).all()) and e <= TOL[dtype] * scale,
              f"{tag} kernel != plain (err {e:.3e}, scale {scale:.3e})")
        err = max(err, e)
    # one line per case, on stderr: stdout keeps the phase summaries
    print(f"  {tag}: max_abs_err {err:.3e}", file=sys.stderr)
    worst[name] = max(worst.get(name, 0.0), err)


def sparse_block_inputs(data, k, h, dt, seed=3, hot_cols=0):
    """The first block of a sparse round on the card: B draws with forced
    repeats and shard 0's crafted column-0 rows, steps past H masked.
    ``hot_cols`` > 0 shards the hybrid layout: the rows are then the cold
    residual, and the block's panel rows, w at the hot columns and a
    Delta-w_hot come with them."""
    ds = shard_dataset(data, k, layout="sparse", dtype=dt, device="cuda",
                       hot_cols=hot_cols)
    w, alpha, idxs = round_inputs(ds, h, seed)
    spi, spv, sq, idxs = column0_rows(ds, idxs)
    n = min(h, BLOCK)
    bidx = torch.zeros(k, BLOCK, dtype=torch.long, device="cuda")
    bidx[:, :n] = idxs[:, :n]
    live_b = torch.arange(BLOCK, device="cuda") < h
    ks = torch.arange(k, device="cuda")[:, None]
    rng = np.random.default_rng(seed)
    panel = {}
    if ds.X_hot is not None:
        panel = dict(xh=gather_rows(ds.X_hot, bidx),
                     w_hot=w[ds.hot_cols.long()],
                     dw_hot=torch.as_tensor(rng.normal(
                         size=(k, ds.n_hot)) * 0.01).to("cuda", dt))
    return dict(
        **panel, ds=ds, w=w, alpha=alpha, sq=sq, bidx=bidx,
        bidx32=bidx.to(torch.int32),
        live=live_b.to(dt).expand(k, BLOCK).contiguous(),
        gidx=spi[ks, bidx].contiguous(), gvals=spv[ks, bidx].contiguous(),
        cnts=torch.where(live_b, row_lengths(spv).gather(1, bidx),
                         -1).to(torch.int32),
        dw=torch.as_tensor(rng.normal(size=(k, ds.num_features)) * 0.01)
        .to("cuda", dt))


def with_panel(bi, gram, mb, sig_eff, frozen):
    """The hybrid block path's panel terms (ops/local_sdca.py, route
    sparse_gram) added to B5's Gram and margin base: the panel rows
    against w_hot + sig_eff * Delta-w_hot, and the full panel Gram."""
    v = bi["w_hot"] if frozen else bi["w_hot"] + sig_eff * bi["dw_hot"]
    with bc.fp32_matmul():
        mb = mb + torch.matmul(bi["xh"], v[:, :, None])[..., 0]
        if not frozen:
            gram = gram + torch.matmul(bi["xh"], bi["xh"].transpose(1, 2))
    return gram, mb


def chain_scal(bi, mb, qf, dt):
    ds, bidx = bi["ds"], bi["bidx"]
    return torch.stack([mb, ds.labels.gather(1, bidx),
                        bi["sq"].gather(1, bidx) * qf,
                        bi["alpha"].gather(1, bidx), torch.zeros_like(mb),
                        bi["live"]], dim=1).to(dt)


def chain_plans_held(b, dt):
    """B3's plans held against its plain version at B = ``b``: the auto
    plan (None), every ring depth up to the auto plan's, and each unit
    width's whole triangle (every unit in its own slot) where it fits, as
    the ``stages`` asked for, each with its plan (stages, cols, bytes)."""
    optin = kernels.smem_optin("cuda")
    auto = bc.chain_plan(b, dt.itemsize, optin)
    asked = set(range(1, auto[0] + 1)) | {-(-b // c) for c in bc.CHAIN_COLS}
    out = [(None, auto)]
    for stages in sorted(asked):
        with contextlib.suppress(ValueError):
            out.append((stages, bc.chain_plan(b, dt.itemsize, optin, stages)))
    return out


def gram_plans_held(width, dt):
    """B5's plans held against its plain version for rows of ``width``
    slots: the auto plan, every rows_per_cta, the least table that holds
    a row (slots the least power of two above W, probes colliding more),
    and a table of a quarter of that, which takes the row in passes, each
    with its plan (T, slots, chunk, cap, bytes)."""
    optin = kernels.smem_optin("cuda")
    tight = 1 << max(0, width).bit_length()
    out = []
    for rows in (None, *sb.ROWS_PER_CTA):
        for slots in (None, tight, max(sb.MIN_PASS_SLOTS, tight // 4)):
            with contextlib.suppress(ValueError):
                out.append((dict(rows_per_cta=rows, slots=slots),
                            sb.gram_plan(BLOCK, width, dt.itemsize, optin,
                                         rows, slots)))
    return out


def gram_variants(bi):
    """The block's rows as drawn, then with columns repeated within each
    row (every third slot a copy of the slot before it, so a chunk of 32
    holds a column twice and the group sums), then every live row at the
    full width W with distinct random columns."""
    gidx, gvals, cnts = bi["gidx"], bi["gvals"], bi["cnts"]
    rep = gidx.clone()
    rep[..., 1::3] = rep[..., 0::3][..., :rep[..., 1::3].shape[-1]]
    k, b, width = gidx.shape
    gen = torch.Generator(device="cuda").manual_seed(11)
    d = bi["ds"].num_features
    full = torch.argsort(torch.rand(k, b, d, device="cuda", generator=gen),
                         dim=-1)[..., :width].to(torch.int32).contiguous()
    vals = torch.randn(k, b, width, device="cuda", generator=gen,
                       dtype=gvals.dtype)
    return {"as drawn": (gidx, gvals, cnts),
            "repeated columns": (rep, gvals, cnts),
            "full width": (full, vals, torch.where(cnts >= 0, width, cnts)
                           .to(torch.int32))}


def apply_plans_held(k, width, d, dt):
    """B6's plans held against its plain version: the auto plan (None) and
    each asked slice count that fits (one slice a shard, the whole Delta-w
    in shared memory, only where it fits), each plan once, with the
    slices asked for it."""
    optin, sms = kernels.smem_optin("cuda"), kernels.sm_count("cuda")
    out = {}
    for slices in (None, 1, 2, 4, 8, 16, 32, 64, 128):
        with contextlib.suppress(ValueError):
            out.setdefault(sb.apply_plan(k, BLOCK, width, d, dt.itemsize,
                                         optin, sms, slices), slices)
    return out


def apply_variants(rows):
    """B6's rows: :func:`gram_variants` (as drawn, columns repeated within
    each row, every live row at the full width), and a hot column: column
    5 in slot 0 of every row and again in slot 2 of every third row, a
    chain of adds into one column through the whole block."""
    out = dict(rows)
    gidx, gvals, cnts = rows["as drawn"]
    hot = gidx.clone()
    hot[..., 0] = 5
    hot[:, ::3, 2 % hot.shape[-1]] = 5
    out["hot column"] = (hot, gvals, cnts)
    return out


def held_apply(tag, dw, variants, coefs, dt, worst, held):
    """B6 on each of ``variants`` (name: (gidx, gvals, cnts)) at every plan
    of :func:`apply_plans_held`: equal bit for bit (torch.equal) to the
    plain version run on CPU copies of the same inputs, within TOL of the
    plain version on the card, and two launches of the auto plan bit for
    bit."""
    k, d = dw.shape
    for variant, rows in variants.items():
        want = sb.sparse_block_apply_plain(
            dw.cpu().clone(), *(r.cpu() for r in rows), coefs.cpu())
        on_card = sb.sparse_block_apply_plain(dw.clone(), *rows, coefs)
        width = rows[0].shape[-1]
        for plan, slices in apply_plans_held(k, width, d, dt).items():
            held.add(("B6", str(dt)[6:], width, plan[:3]))
            got = sb.sparse_block_apply(dw.clone(), *rows, coefs,
                                        slices=slices)
            agree(f"{tag} {variant} sparse_block_apply slices={slices} "
                  f"plan={plan}", [got], [on_card], dt, worst, "B6")
            check(torch.equal(got.cpu(), want),
                  f"{tag} {variant} sparse_block_apply at plan {plan} != "
                  f"the plain version on the CPU (err "
                  f"{float((got.cpu() - want).abs().max()):.3e})")
        bit_for_bit(f"{tag} {variant} sparse_block_apply",
                    lambda: [sb.sparse_block_apply(dw.clone(), *rows,
                                                   coefs)])


def phase_block_sparse(name, data, k, h, lam, worst, hot_cols=0):
    """B5, B3 and B6 against their plain versions on one block of a
    sparse round, every mode x loss x dtype, each kernel at every plan
    (:func:`gram_plans_held`, :func:`chain_plans_held`,
    :func:`apply_plans_held`); B5 and B6 also on the block's rows with
    repeated columns and at the full width, B6 with a hot column and
    bit for bit with its plain version on the CPU (:func:`held_apply`),
    and two launches of B3, B5 and B6 must agree bit for bit.  With ``hot_cols``
    the rows are the hybrid layout's cold residual, and B3 reads the Gram
    and margins with the panel's terms.  Returns the plans held."""
    held = set()
    for dt in (torch.float32, torch.float64):
        bi = sparse_block_inputs(data, k, h, dt, hot_cols=hot_cols)
        lam_n = lam * bi["ds"].n
        rows = (bi["gidx"], bi["gvals"], bi["cnts"])
        width = rows[0].shape[-1]
        for mode, sigma in MODES:
            sig_eff, qf = mode_factors(mode, sigma or float(k))
            frozen = mode == "frozen"
            tag = f"{name} {str(dt)[6:]} {mode}"
            for variant, vrows in gram_variants(bi).items():
                args = (bi["w"], bi["dw"], *vrows, sig_eff, frozen)
                want = sb.sparse_block_gram_plain(*args)
                for kw, plan in gram_plans_held(width, dt):
                    held.add(("B5", str(dt)[6:], width, plan[:4]))
                    agree(f"{tag} {variant} sparse_block_gram {kw} "
                          f"plan={plan}", sb.sparse_block_gram(*args, **kw),
                          want, dt, worst, "B5")
                bit_for_bit(f"{tag} {variant} sparse_block_gram",
                            lambda: sb.sparse_block_gram(*args))
            gram, mb = sb.sparse_block_gram_plain(bi["w"], bi["dw"], *rows,
                                                  sig_eff, frozen)
            if hot_cols:
                gram, mb = with_panel(bi, gram, mb, sig_eff, frozen)
            scal = chain_scal(bi, mb, qf, dt)
            for loss in LOSSES:
                kw = dict(lam_n=lam_n, coef_div=lam_n, sig_eff=sig_eff,
                          frozen=frozen, loss=loss)
                want = held_chain(f"{tag}/{loss}", scal, gram, bi["bidx32"],
                                  kw, dt, worst, held)
            held_apply(tag, bi["dw"], apply_variants(gram_variants(bi)),
                       want[1], dt, worst, held)
    return held


def bit_for_bit(tag, launch):
    """Two launches of a kernel give the same bits."""
    one, two = launch(), launch()
    torch.cuda.synchronize()
    check(all((x is None and y is None) or torch.equal(x, y)
              for x, y in zip(one, two)),
          f"{tag} differs between two launches")


def held_chain(tag, scal, gram, idx, kw, dt, worst, held):
    """B3 at every plan of :func:`chain_plans_held` against its plain
    version, two launches of the auto plan bit for bit; returns the plain
    version's (delta, coef)."""
    b = scal.shape[-1]
    want = bc.chain_block_batched_plain(scal, gram, idx, **kw)
    for stages, plan in chain_plans_held(b, dt):
        held.add(("B3", str(dt)[6:], b, plan[:2]))
        agree(f"{tag} chain_block_batched B={b} stages={stages} "
              f"plan={plan}",
              bc.chain_block_batched(scal, gram, idx, stages=stages, **kw),
              want, dt, worst, "B3", (1.0, 1.0 / kw["coef_div"]))
    bit_for_bit(f"{tag} chain_block_batched B={b}",
                lambda: bc.chain_block_batched(scal, gram, idx, **kw))
    return want


def dense_block_inputs(eps, b, dt, seed=5):
    """A block of B draws (forced repeats, the last 28 steps masked) of an
    epsilon-like round: the gathered rows and their step scalars."""
    k, d = eps.k, eps.num_features
    idxs = base.IndexSampler("reference", seed, b, eps.counts) \
        .round_indices(1).to("cuda").long()
    idxs[:, 1::4] = idxs[:, 0::4]
    rng = np.random.default_rng(seed)

    def put(a):
        return torch.as_tensor(a).to("cuda", dt)

    alpha = put(np.clip(rng.normal(size=(k, eps.n_shard)) * 0.3 + 0.3, 0, 1))
    live = (torch.arange(b, device="cuda") < b - 28).to(dt)
    return dict(
        xb=dense_rows({"X": eps.X}, idxs, d).to(dt), bidx32=idxs.int(),
        yb=eps.labels.gather(1, idxs).to(dt),
        sq=eps.sq_norms.gather(1, idxs).to(dt),
        a0=alpha.gather(1, idxs), live=live.expand(k, b).contiguous(),
        w=put(rng.normal(size=d) * 0.1), dw=put(rng.normal(size=(k, d)) * 0.01))


# B4's cluster sizes held against its plain version beside the auto plan
# (16 blocks, non-portable, where the card holds K such clusters at once)
FUSED_CLUSTERS = (1, 2, 4, 8, 16)


def fused_clusters_held(b, dt, k):
    """The cluster sizes of FUSED_CLUSTERS that the card runs K at a time
    at B = ``b`` and ``dt``, and None for the auto plan."""
    return [c for c in FUSED_CLUSTERS
            if c <= 8 or bc.fused_clusters(b, dt, c) >= k] + [None]


def fused_shape(bi, d):
    """A block's fused-kernel inputs cut to the first ``d`` columns, with
    |x|^2 of the cut rows."""
    if d == bi["xb"].shape[-1]:
        return bi
    xb = bi["xb"][..., :d].contiguous()
    return dict(bi, xb=xb, sq=(xb * xb).sum(-1), w=bi["w"][:d].contiguous(),
                dw=bi["dw"][:, :d].contiguous())


def phase_block_dense(eps, lam, worst):
    """B4 (the fused branch) at B=128 with d=2000 and d=1000 (a width no
    slice divides) and at B=100 (not a multiple of the 64-row tile), each
    at every cluster size of :func:`fused_clusters_held` and the auto
    plan, two launches of the auto plan bit for bit; and B3 at B=256 on
    the split branch's inputs (the full symmetric Gram); every mode x loss
    x dtype.  Returns the cluster sizes held, by dtype."""
    lam_n = lam * eps.n
    d = eps.num_features
    held, chains = {}, set()
    for dt in (torch.float32, torch.float64):
        held[dt] = fused_clusters_held(BLOCK, dt, eps.k)
        for b, dd in ((BLOCK, d), (BLOCK, d // 2), (100, d), (2 * BLOCK, d),
                      (4 * BLOCK, d), (bc.CHAIN_MAX_B, d)):
            bi = fused_shape(dense_block_inputs(eps, b, dt), dd)
            for mode, sigma in MODES:
                sig_eff, qf = mode_factors(mode, sigma or float(eps.k))
                frozen = mode == "frozen"
                v = bi["w"].expand_as(bi["dw"]).contiguous() if frozen \
                    else bi["w"] + sig_eff * bi["dw"]
                with bc.fp32_matmul():
                    mbase = torch.matmul(bi["xb"], v[:, :, None])[..., 0]
                    gram = torch.matmul(bi["xb"], bi["xb"].transpose(1, 2))
                scal = torch.stack([mbase, bi["yb"], bi["sq"] * qf, bi["a0"],
                                    torch.zeros_like(mbase), bi["live"]], 1)
                for loss in LOSSES:
                    kw = dict(lam_n=lam_n, coef_div=lam_n, sig_eff=sig_eff,
                              frozen=frozen, loss=loss)
                    tag = (f"epsilon-like {str(dt)[6:]} B={b} d={dd} "
                           f"{mode}/{loss}")
                    if b > BLOCK:
                        held_chain(tag, scal, gram, bi["bidx32"], kw, dt,
                                   worst, chains)
                        continue
                    fargs = (bi["xb"], bi["bidx32"], bi["yb"], bi["sq"] * qf,
                             bi["a0"], bi["live"], v)
                    want = bc.fused_block_plain(*fargs, **kw)
                    for c in held[dt]:
                        plan = bc.fused_plan(b, dd, dt.itemsize, c)
                        got = bc.fused_block(*fargs, cluster=c, **kw)
                        agree(f"{tag} fused_block cluster={c} plan={plan}",
                              got, want, dt, worst, "B4", (1.0, 0.0))
                    again = bc.fused_block(*fargs, **kw)
                    torch.cuda.synchronize()
                    check(all(torch.equal(x, y) for x, y in zip(got, again)),
                          f"{tag} fused_block differs between two launches "
                          f"of the auto plan")
    return held, chains


def bound(n_bytes, flops, dtype=torch.float32):
    """(ms, "bytes" | "operations"): the larger of the bytes over HBM3's
    rate and the operations over the peak of ``dtype``."""
    t_b = n_bytes / HBM_BYTES_PER_S
    t_f = flops / PEAK_FLOPS[dtype]
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def phase_block_timing(rcv1, eps, clusters, results):
    """Each block kernel's, its plain version's and a library call's ms
    per launch at the main path's shapes (float32, CoCoA+, hinge): B5, B3
    and B6 on an rcv1-like block, B4 on an epsilon-like block (B=128) and
    B3 on its split shapes (B=256 and 512); with each launch's bound.  B5
    also at each rows_per_cta that fits, in float64 and on the hybrid
    residual; B3 also at each plan of :func:`chain_plans_held` and in
    frozen mode.  B4 also at
    each of ``clusters`` and in frozen mode (no Gram), beside the Gram
    alone as one ``torch.bmm`` in full float32, a yardstick of that
    phase."""
    f32, isz = torch.float32, 4
    bi = sparse_block_inputs(rcv1, 8, 253, f32, seed=7)
    k, d, lam_n = 8, bi["ds"].num_features, 1e-4 * bi["ds"].n
    sig = float(k)
    rows = (bi["gidx"], bi["gvals"], bi["cnts"])
    gargs = (bi["w"], bi["dw"], *rows, sig, False)
    gram, mb = sb.sparse_block_gram_plain(*gargs)
    scal = chain_scal(bi, mb, sig, f32)
    kw = dict(lam_n=lam_n, coef_div=lam_n, sig_eff=sig, frozen=False,
              loss="hinge")
    coefs = bc.chain_block_batched_plain(scal, gram, bi["bidx32"], **kw)[1]
    c = bi["cnts"].clamp(min=0).double()
    nnz = float(c.sum())
    pairs = float((c * torch.arange(BLOCK, device="cuda")).sum())
    vals = sb.live_values(bi["gvals"], bi["cnts"])
    cols = bi["gidx"].long()
    v = bi["w"] + sig * bi["dw"]
    flat = (torch.arange(k, device="cuda")[:, None, None] * d + cols).reshape(-1)
    dw_t = bi["dw"].clone()

    def densify_gram():
        xd = torch.zeros(k, BLOCK, d, device="cuda").scatter_add_(2, cols, vals)
        return torch.bmm(xd, xd.transpose(1, 2)), torch.bmm(xd, v[:, :, None])

    # B3, B5 and B6 are shorter than their wrappers' host time: ms is the
    # kernels alone (graph_ms), wrapper_ms the wrapper calls (cuda_ms)
    results["B5"] = dict(
        ms=graph_ms(lambda: sb.sparse_block_gram(*gargs), 50),
        wrapper_ms=cuda_ms(lambda: sb.sparse_block_gram(*gargs), 50),
        plain_ms=cuda_ms(lambda: sb.sparse_block_gram_plain(*gargs), 3),
        library_ms=graph_ms(densify_gram, 20),
        bound=bound(nnz * (4 + isz) + 2 * nnz * isz + k * BLOCK * 4
                    + k * BLOCK * BLOCK * isz + k * BLOCK * isz,
                    2 * pairs + 4 * nnz))
    results["B3"] = dict(
        ms=graph_ms(lambda: bc.chain_block_batched(scal, gram, bi["bidx32"],
                                                   **kw), 50),
        wrapper_ms=cuda_ms(lambda: bc.chain_block_batched(
            scal, gram, bi["bidx32"], **kw), 50),
        plain_ms=cuda_ms(lambda: bc.chain_block_batched_plain(
            scal, gram, bi["bidx32"], **kw), 3),
        library_ms=None,
        bound=bound(k * 6 * BLOCK * isz + k * BLOCK * 4
                    + k * BLOCK * (BLOCK - 1) // 2 * isz
                    + 2 * k * BLOCK * isz,
                    3 * k * BLOCK * (BLOCK - 1) // 2 + 20 * k * BLOCK))
    results["B6"] = dict(
        ms=graph_ms(lambda: sb.sparse_block_apply(dw_t, *rows, coefs), 50),
        wrapper_ms=cuda_ms(lambda: sb.sparse_block_apply(dw_t, *rows,
                                                         coefs), 50),
        plain_ms=cuda_ms(lambda: sb.sparse_block_apply_plain(
            dw_t, *rows, coefs), 3),
        library_ms=graph_ms(lambda: dw_t.view(-1).index_add_(
            0, flat, (coefs[..., None] * vals).reshape(-1)), 50),
        bound=bound(nnz * (4 + isz) + k * BLOCK * (4 + isz)
                    + 2 * nnz * isz, 2 * nnz))
    results["B5"]["nnz"] = nnz
    optin = kernels.smem_optin("cuda")
    width = bi["gidx"].shape[-1]
    results["B5"]["plan"] = sb.gram_plan(BLOCK, width, isz, optin)
    results["B5"]["rows_ms"] = {
        rows: graph_ms(lambda: sb.sparse_block_gram(
            *gargs, rows_per_cta=rows), 50) for rows in sb.ROWS_PER_CTA
        if sb.gram_smem_bytes(rows, results["B5"]["plan"].slots, width,
                              BLOCK, isz) <= optin}
    b64 = sparse_block_inputs(rcv1, 8, 253, torch.float64, seed=7)
    g64 = (b64["w"], b64["dw"], b64["gidx"], b64["gvals"], b64["cnts"], sig,
           False)
    results["B5"]["f64_ms"] = graph_ms(lambda: sb.sparse_block_gram(*g64), 50)
    gram64, mb64 = sb.sparse_block_gram_plain(*g64)
    coefs64 = bc.chain_block_batched_plain(
        chain_scal(b64, mb64, sig, torch.float64), gram64, b64["bidx32"],
        **kw)[1]
    dw64 = b64["dw"].clone()
    results["B6"]["f64_ms"] = graph_ms(lambda: sb.sparse_block_apply(
        dw64, b64["gidx"], b64["gvals"], b64["cnts"], coefs64), 50)
    del b64, g64, gram64, dw64
    # the hybrid residual at the --hotCols=auto panel
    hot_w, _ = hybrid.resolve_hot_cols("auto", rcv1, 8, f32)
    bh = sparse_block_inputs(rcv1, 8, 253, f32, seed=7, hot_cols=hot_w)
    hrows = (bh["gidx"], bh["gvals"], bh["cnts"])
    results["B5"]["residual_ms"] = graph_ms(lambda: sb.sparse_block_gram(
        bh["w"], bh["dw"], *hrows, sig, False), 50)
    results["B6"]["residual_ms"] = graph_ms(lambda: sb.sparse_block_apply(
        dw_t, *hrows, coefs), 50)
    results["B6"]["residual_nnz"] = float(bh["cnts"].clamp(min=0).sum())
    del bh, hrows
    # B6 at each plan, and on a hot column (a chain of adds into column 5
    # through every row of the block); the longest chain of the block as
    # drawn: the most entries of one column in one shard
    results["B6"]["plan"] = sb.apply_plan(8, BLOCK, width, d, isz, optin,
                                          kernels.sm_count("cuda"))
    results["B6"]["slices_ms"] = {
        slices: (plan, graph_ms(lambda: sb.sparse_block_apply(
            dw_t, *rows, coefs, slices=slices), 50))
        for plan, slices in apply_plans_held(8, width, d, f32).items()}
    hot = apply_variants({"as drawn": rows})["hot column"]
    results["B6"]["hot_ms"] = graph_ms(lambda: sb.sparse_block_apply(
        dw_t, *hot, coefs), 50)
    live = torch.arange(width, device="cuda") < bi["cnts"][..., None]
    results["B6"]["chain"] = max(
        int(torch.bincount(bi["gidx"][s][live[s]].long()).max())
        for s in range(8))
    # B3 at each plan of the rcv1-like block, and in frozen mode
    results["B3"]["stages_ms"] = {
        stages: (plan, graph_ms(lambda: bc.chain_block_batched(
            scal, gram, bi["bidx32"], stages=stages, **kw), 50))
        for stages, plan in chain_plans_held(BLOCK, f32)}
    results["B3"]["frozen_ms"] = graph_ms(lambda: bc.chain_block_batched(
        scal, None, bi["bidx32"], **dict(kw, frozen=True, sig_eff=0.0)), 50)

    kd = eps.k
    lam_e = 1e-3 * eps.n
    for b in (BLOCK, 2 * BLOCK, 4 * BLOCK):
        di = dense_block_inputs(eps, b, f32, seed=9)
        de = eps.num_features
        v = di["w"] + float(kd) * di["dw"]
        kwe = dict(lam_n=lam_e, coef_div=lam_e, sig_eff=float(kd),
                   frozen=False, loss="hinge")
        if b == BLOCK:
            fargs = (di["xb"], di["bidx32"], di["yb"], di["sq"] * kd,
                     di["a0"], di["live"], v)
            # frozen mode (no Gram): what the margins, chain and apply take
            zargs = (*fargs[:3], di["sq"], *fargs[4:6],
                     di["w"].expand(kd, de).contiguous())
            kwz = dict(kwe, sig_eff=0.0, frozen=True)

            def gram_bmm():
                with bc.fp32_matmul():
                    return torch.bmm(di["xb"], di["xb"].transpose(1, 2))

            results["B4"] = dict(
                ms=cuda_ms(lambda: bc.fused_block(*fargs, **kwe), 20),
                plan=bc.fused_plan(b, de, isz),
                cluster_ms={c: cuda_ms(lambda: bc.fused_block(
                    *fargs, cluster=c, **kwe), 20)
                    for c in clusters if c is not None},
                frozen_ms=cuda_ms(lambda: bc.fused_block(*zargs, **kwz), 20),
                bmm_ms=cuda_ms(gram_bmm, 20),
                plain_ms=cuda_ms(lambda: bc.fused_block_plain(*fargs, **kwe),
                                 3),
                library_ms=None,
                bound=bound(kd * b * de * isz + 2 * kd * de * isz
                            + 6 * kd * b * isz,
                            2 * kd * b * de + kd * de * b * (b - 1)
                            + 2 * kd * b * de + 3 * kd * b * (b - 1) // 2))
        else:
            with bc.fp32_matmul():
                mbase = torch.matmul(di["xb"], v[:, :, None])[..., 0]
                gb = torch.matmul(di["xb"], di["xb"].transpose(1, 2))
            sb_ = torch.stack([mbase, di["yb"], di["sq"] * kd, di["a0"],
                               torch.zeros_like(mbase), di["live"]], 1)
            results["B3"][f"split{b}_ms"] = graph_ms(
                lambda: bc.chain_block_batched(sb_, gb, di["bidx32"],
                                               **kwe), 20)
            results["B3"][f"split{b}_plan"] = bc.chain_plan(b, isz, optin)
            results["B3"][f"split{b}_bound"] = bound(
                kd * 6 * b * isz + kd * b * 4 + kd * b * (b - 1) // 2 * isz
                + 2 * kd * b * isz, 3 * kd * b * (b - 1) // 2 + 20 * kd * b)
    return results


def check_same_gaps(label, res, ref, rel=1e-3, ulps=0):
    """Every eval's gap of ``res`` within relative ``rel`` of ``ref``'s,
    plus ``ulps`` units in the last place of ``ref``'s primal in float32
    (the resolution of a float32 certificate, which subtracts two sums of
    the primal's size)."""
    for r, p in zip(res, ref):
        ra, pa = r.trajectory.records, p.trajectory.records
        check([a.round for a in ra] == [b.round for b in pa],
              f"{label}: eval rounds differ")
        for a, b in zip(ra, pa):
            diff = abs(a.gap - b.gap)
            tol = rel * abs(b.gap) + ulps * float(
                np.spacing(np.float32(abs(b.primal))))
            check(diff <= tol, f"{label} {r.algorithm} round {a.round}: gap "
                               f"{a.gap} vs {b.gap} (diff {diff:.2e}, "
                               f"allowed {tol:.2e})")


def phase_block_path(sparse_runs, eps):
    """The block path through its entry points, every kernel's launches
    counted from 0 just before each run and read just after.
    ``sparse_runs``: (label, CLI argv, the sequential run's results, H)
    for the demo and rcv1-like data.  Then the epsilon-like data through
    run_cocoa at each of EPS_BLOCKS, EPS_BLOCK_RUNS times in turns, every
    run's gaps within relative 1e-3 of the first fused run's, the block
    sizes ranked by their median ms per round.  Returns ({run: counts},
    {run: ms per round}, the first fused run's results)."""
    launched, per_round = {}, {}
    for label, argv, seq, h in sparse_runs:
        rounds, blocks = 400 if label == "rcv1-like" else 200, -(-h // BLOCK)
        reset_counts()
        out, res = run_cli(argv + ["--blockSize=auto"])
        launched[label] = counts()
        (OUT / f"chip_smoke_{label}_block.log").write_text(out)
        check("blockSize=auto: using 128 for the sparse layout" in out,
              f"{label}: --blockSize=auto did not pick 128 sparse-Gram")
        want = {name: 0 for name in KERNELS}
        want.update(B3=rounds * blocks, B5=rounds * blocks,
                    B6=rounds * blocks)
        check(launched[label] == want,
              f"{label} block run launches {launched[label]}, want {want}")
        check_run(res, f"{label} block")
        check_same_gaps(f"{label} block vs sequential", res, seq)
        per_round[label] = [r.trajectory.records[-1].wall_time / (rounds // 2)
                            * 1e3 for r in res]
        print(f"phase 6: {label} --blockSize=auto ok: launches per round "
              f"B5/B3/B6 = {blocks}/{blocks}/{blocks}, gaps within rel 1e-3 "
              f"of the sequential run; ms per round (evals included) "
              f"CoCoA+ {per_round[label][0]:.3f}, CoCoA "
              f"{per_round[label][1]:.3f}")
    rounds, h = 30, eps.n // eps.k // 10
    params = Params(n=eps.n, num_rounds=rounds, local_iters=h, lam=1e-3)
    runs, ms = {}, {}
    for rep in range(EPS_BLOCK_RUNS):
        for b, route, kern in EPS_BLOCKS:
            check(cocoa_mod.block_route("dense", b, torch.float32) == route,
                  f"epsilon-like B={b} does not route {route}")
            label = f"epsilon-like B={b} {route}"
            reset_counts()
            w, alpha, traj = cocoa_mod.run_cocoa(
                eps, params, DebugParams(debug_iter=10, seed=0), plus=True,
                math="fast", block_size=b, quiet=True)
            torch.cuda.synchronize()
            launched[f"{label} run {rep + 1}"] = got = counts()
            nb = -(-h // b)
            check(got == only(kern, rounds * nb),
                  f"{label} launches {got}, want {only(kern, rounds * nb)}")
            res = [cli.RunResult(traj.algorithm, w, alpha, traj)]
            check_run(res, label)
            runs.setdefault(b, res)
            # the same draws and the same math in blocks of 128 on the
            # fused kernel and of 256 and 512 through TF32-free matmuls: a
            # Gram or Delta-w rounded to TF32 or bf16 would part the gaps
            check_same_gaps(f"{label} vs fused B={BLOCK}", res, runs[BLOCK])
            ms.setdefault(label, []).append(
                traj.records[-1].wall_time / rounds * 1e3)
            print(f"phase 6: {label} run {rep + 1} ok: {nb} {kern} launches "
                  f"per round, {ms[label][-1]:.3f} ms per round (evals "
                  f"included), gaps within rel 1e-3 of the fused run")
    per_round.update(ms)
    ranked = sorted(ms, key=lambda lb: float(np.median(ms[lb])))
    print("phase 6: epsilon-like block sizes ranked by median ms per round "
          f"over {EPS_BLOCK_RUNS} runs in turns: " + "; ".join(
              f"{lb} {np.median(ms[lb]):.3f} ("
              + ", ".join(f"{t:.3f}" for t in ms[lb]) + ")" for lb in ranked))
    fused = runs[BLOCK]
    print("phase 6: epsilon-like fused B=128 vs split B=256 gaps: " + " ".join(
        f"{a.round}:{a.gap:.6g}/{b.gap:.6g}"
        for a, b in zip(fused[0].trajectory.records,
                        runs[2 * BLOCK][0].trajectory.records)))
    return launched, per_round, fused


MENU = ("CoCoA+", "CoCoA", "Mini-batch CD", "Mini-batch SGD", "Local SGD",
        "Dist SGD")


def as_dtype(ds, dt):
    """A copy of the dataset ``ds`` with its float tensors in ``dt``."""
    return dataclasses.replace(ds, **{
        f: getattr(ds, f).to(dt) for f in ("labels", "mask", "sq_norms", "X")
        if getattr(ds, f) is not None})


def window_repeats(idxs, span=8):
    """Forced repeats at every distance inside and past the deepest ring
    of staged rows: step t = 3 mod 4 redraws the row of step t - g, g
    cycling over 2..span-1 (round_inputs repeats at distance 1)."""
    out = idxs.cpu().clone()
    gaps = range(2, span)
    for j, t in enumerate(range(3, out.shape[1], 4)):
        g = gaps[j % len(gaps)]
        if t >= g:
            out[:, t] = out[:, t - g]
    return out.to(idxs.device)


def dense_args(ds, h, seed, prox=False, repeats=True):
    w, alpha, idxs = round_inputs(ds, h, seed, prox=prox, repeats=repeats)
    if repeats:
        idxs = window_repeats(idxs)
    return (w, alpha, ds.X, ds.labels, ds.sq_norms, idxs)


def dense_plan(ds, state_in_smem=True, stages=None):
    return dn.stage_plan(ds.num_features, ds.X.element_size(),
                         kernels.smem_optin(ds.X.device), state_in_smem,
                         stages)


def phase_dense_kernel(shapes, worst):
    """B2 against its plain version on the same CUDA tensors.  ``shapes``:
    {name: ({dtype: dataset}, H, lam, n, cases)}, a case (mode, sigma or
    None for K, loss, smoothing); draws with repeats.  Each case's plain
    result is held against the kernel with the state asked into shared
    and into global memory, each at the auto ring depth and at one slot.
    Returns {(name, dtype, state asked, stages asked): (plan, H)}."""
    plans = {}
    for name, (sets, h, lam, n, cases) in shapes.items():
        for dt, ds in sets.items():
            args = dense_args(ds, h, 3, prox=cases[0][0] == "prox")
            for mode, sigma, loss, s in cases:
                kw = dict(mode=mode, sigma=sigma or float(ds.k), loss=loss,
                          smoothing=s)
                want = dn.dense_sdca_round_plain(*args, lam, n, **kw)
                for smem, stages in [(smem, stages) for smem in (True, False)
                                     for stages in (None, 1)]:
                    plan = dense_plan(ds, smem, stages)
                    plans[(name, str(dt)[6:], smem, stages)] = (plan, h)
                    agree(f"{name} {str(dt)[6:]} H={h} state_in_smem={smem} "
                          f"stages={stages} plan={plan} {mode}/{loss} s={s}",
                          dn.dense_sdca_round(*args, lam, n,
                                              state_in_smem=smem,
                                              stages=stages, **kw),
                          want, dt, worst, "B2", ROUND_FLOORS)
    return plans


def phase_sparse_prox(sets, h, lam, worst):
    """B1 in mode prox with the lasso rule against its plain version, on
    the demo's padded-CSC column shards (n = 1: lam is the L1 weight), at
    every plan, with repeats inside and past the ring."""
    plans = set()
    for dt, ds in sets.items():
        w, alpha, idxs = round_inputs(ds, h, 4, prox=True)
        args = (w, alpha, ds.sp_indices, ds.sp_values, ds.labels,
                ds.sq_norms, sparse_repeats(idxs), lam, 1)
        for l2 in PROX_L2:
            kw = dict(mode="prox", sigma=float(ds.k), loss="lasso",
                      smoothing=l2)
            held_at_every_plan(f"demo columns {str(dt)[6:]} prox/lasso "
                               f"l2={l2}", ds, args, kw,
                               sp.sparse_sdca_round_plain(*args, **kw), dt,
                               worst, "B1", plans)
    return plans


# B2's timed plans beside the auto one: each ring depth with the state
# placed as auto places it, and the state asked into global memory
DENSE_PLANS = {"stages=1": dict(stages=1), "stages=2": dict(stages=2),
               "stages=3": dict(stages=3), "global": dict(state_in_smem=False)}


def dense_timing(ds, h, lam, n, mode, loss, smoothing, reps):
    """B2's ms per launch at a main path's shape, on the main path's own
    draws: the auto plan and each of DENSE_PLANS; its plain version's ms,
    and the bound of the same work.  Two launches, and every plan, held
    bit for bit against each other (the reduction tree is fixed, and the
    plan changes no thread's order of operations)."""
    args = dense_args(ds, h, 5, prox=mode == "prox", repeats=False)
    kw = dict(mode=mode, sigma=float(ds.k), loss=loss, smoothing=smoothing)
    plans = {"auto": {}, **DENSE_PLANS}
    first = dn.dense_sdca_round(*args, lam, n, **kw)
    for name, plan in plans.items():
        out = dn.dense_sdca_round(*args, lam, n, **plan, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(first, out)),
              f"dense_sdca_round {mode}/{loss}: plan {name} differs from "
              f"the first auto launch")
    times = {name: cuda_ms(lambda: dn.dense_sdca_round(*args, lam, n, **plan,
                                                       **kw), reps)
             for name, plan in plans.items()}
    plain_ms = cuda_ms(lambda: dn.dense_sdca_round_plain(*args, lam, n, **kw),
                       1)
    return dict(ms=times["auto"], times=times, plain_ms=plain_ms, h=h,
                plans={name: dense_plan(ds, **plan)
                       for name, plan in plans.items()},
                **dense_bound(ds, args[5]))


def dense_bound(ds, idxs):
    """B2's bound for one round on ``idxs``: each input read once, each
    output written once (the distinct sampled rows with their y and
    |x|^2, w, the (K, d) dw written, alpha read and written, and each
    step's draw); per step two d-dots and the axpy."""
    isz, k, d = ds.X.element_size(), ds.k, ds.num_features
    h = idxs.shape[1]
    rows = sum(r.numel() for r in distinct_rows(idxs))
    n_bytes = (rows * (d + 2) * isz + d * isz + k * d * isz
               + 2 * k * ds.n_shard * isz + k * h * 4)
    return dict(n_bytes=n_bytes, rows=rows,
                bound=bound(n_bytes, 6 * k * h * d, ds.dtype))


def reset_and_run(fn, *args, **kw):
    """``fn`` with every kernel's count set to 0 just before and read just
    after: (its result, the counts)."""
    reset_counts()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, counts()


def only(name, n):
    want = {k: 0 for k in KERNELS}
    want[name] = n
    return want


def phase_dense_path(eps, fused):
    """Epsilon-like data through run_cocoa on --math=fast with no block
    size: CoCoA+ and CoCoA, one B2 launch per round and nothing else;
    CoCoA+'s gaps within relative 1e-3 of phase 6's fused block run (the
    same params, seed and draws).  Returns ({run: counts}, {run: ms per
    round})."""
    n, d, k = EPS_SHAPE
    rounds, h = 30, n // k // 10
    params = Params(n=n, num_rounds=rounds, local_iters=h, lam=1e-3)
    launched, per_round, seq = {}, {}, {}
    for plus in (True, False):
        (w, alpha, traj), got = reset_and_run(
            cocoa_mod.run_cocoa, eps, params,
            DebugParams(debug_iter=10, seed=0), plus=plus, math="fast",
            quiet=True)
        label = f"epsilon-like sequential {traj.algorithm}"
        check(got == only("B2", rounds),
              f"{label} launches {got}, want {only('B2', rounds)}")
        seq[plus] = [cli.RunResult(traj.algorithm, w, alpha, traj)]
        check_run(seq[plus], "epsilon-like sequential")
        launched[label] = got
        per_round[label] = traj.records[-1].wall_time / rounds * 1e3
        print(f"phase 8: {label} ok: 1 B2 launch per round, "
              f"{per_round[label]:.3f} ms per round (evals included)")
    check_same_gaps("epsilon-like sequential vs fused block", seq[True],
                    fused)
    print("phase 8: epsilon-like sequential vs fused B=128 gaps within rel "
          "1e-3: " + " ".join(
              f"{a.round}:{a.gap:.6g}/{b.gap:.6g}"
              for a, b in zip(seq[True][0].trajectory.records,
                              fused[0].trajectory.records)))
    return launched, per_round


def plain_kernels():
    """The round kernels' wrappers replaced by their plain versions inside
    the solvers, for a run to compare against."""
    def plain_sparse(*args, row_len=None, **kw):
        return sp.sparse_sdca_round_plain(*args, **kw)

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(cocoa_mod, "sparse_sdca_round",
                                          plain_sparse))
    stack.enter_context(mock.patch.object(cocoa_mod, "dense_sdca_round",
                                          dn.dense_sdca_round_plain))
    return stack


def check_primal_only(results, label):
    for r in results:
        primals = [rec.primal for rec in r.trajectory.records]
        check(all(np.isfinite(p) for p in primals) and primals[-1] < primals[0],
              f"{label} {r.algorithm}: primal objective did not fall: "
              f"{primals}")
        check(all(rec.gap is None for rec in r.trajectory.records),
              f"{label} {r.algorithm}: a primal-only run reported a gap")
        print(f"  {label} {r.algorithm}: round:primal "
              + " ".join(f"{rec.round}:{rec.primal:.6g}"
                         for rec in r.trajectory.records))


def phase_entry_points(demo_train, demo_test):
    """The demo through the CLI: --justCoCoA=false on the sparse layout
    (B1 in mode frozen for mini-batch CD) and the dense one (B2), then
    --objective=lasso on the sparse (B1 prox) and dense (B2 prox) column
    shards; every run against the same run through the plain versions.
    Returns ({run: counts}, {run: ms per round}, {run: results})."""
    rounds = 50
    base_argv = [f"--trainFile={demo_train}", "--numFeatures=9947",
                 "--numSplits=4", f"--numRounds={rounds}",
                 "--localIterFrac=0.1", "--math=fast", "--dtype=float32"]
    menu = base_argv + [f"--testFile={demo_test}", "--lambda=.001",
                        "--justCoCoA=false"]
    lasso = base_argv + ["--lambda=.1", "--objective=lasso"]
    launched, per_round, results = {}, {}, {}
    for label, argv, kern, n_sdca in (
            ("demo menu sparse", menu + ["--layout=sparse"], "B1", 3),
            ("demo menu dense", menu + ["--layout=dense"], "B2", 3),
            ("demo lasso sparse", lasso + ["--layout=sparse"], "B1", 1),
            ("demo lasso dense", lasso + ["--layout=dense"], "B2", 1)):
        (out, res), got = reset_and_run(run_cli, argv)
        (OUT / f"chip_smoke_{label.replace(' ', '_')}.log").write_text(out)
        want = only(kern, n_sdca * rounds)
        check(got == want, f"{label}: launches {got}, want {want}")
        names = tuple(r.algorithm for r in res)
        check(names == (MENU if n_sdca == 3 else ("ProxCoCoA+",)),
              f"{label}: ran {names}")
        if n_sdca == 3:
            check_run(res[:3], label)
            check_primal_only(res[3:], label)
        else:
            gaps = [rec.gap for rec in res[0].trajectory.records]
            check(all(np.isfinite(g) and g >= 0 for g in gaps)
                  and gaps[-1] < gaps[0], f"{label}: gaps {gaps}")
            print(f"  {label} ProxCoCoA+: round:gap "
                  + " ".join(f"{rec.round}:{rec.gap:.6g}"
                             for rec in res[0].trajectory.records))
        with plain_kernels():
            _, plain = run_cli(argv)
        check_same_gaps(f"{label} kernel vs plain", res[:n_sdca],
                        plain[:n_sdca])
        launched[label] = got
        results[label] = res
        per_round[label] = [r.trajectory.records[-1].wall_time / rounds * 1e3
                            for r in res]
        print(f"phase 9: {label} ok: {n_sdca} x {rounds} {kern} launches, "
              f"gaps within rel 1e-3 of the plain run; ms per round "
              f"(evals included) " + ", ".join(
                  f"{r.algorithm} {t:.3f}" for r, t in zip(res,
                                                           per_round[label])))
    return launched, per_round, results


def phase_lasso_design(ds, b, lam_max):
    """The lasso design at full width (made on the card) through
    run_prox_cocoa: lasso and elastic net (l2 = 0.1) at lam = 0.3*lam_max,
    one B2 launch per round, a certified gap >= 0 that falls, and the
    first eval at which the gap reaches 1e-3 * |b|^2 / 2.  Returns
    ({run: counts}, {run: (ms per round, round reached or None, last
    gap, target)}, {run: its result})."""
    d, k = ds.n, ds.k
    h = d // k // 10
    target = 1e-3 * 0.5 * float(b @ b)
    launched, result, runs = {}, {}, {}
    for tag, l2 in (("lasso", 0.0), ("elastic net", 0.1)):
        params = Params(n=d, num_rounds=LASSO_ROUNDS, local_iters=h,
                        lam=0.3 * lam_max, loss="lasso", smoothing=l2)
        (x, r, traj), got = reset_and_run(
            run_prox_cocoa, ds, b, params, DebugParams(debug_iter=50, seed=0),
            quiet=True, math="fast")
        label = f"lasso design {tag}"
        check(got == only("B2", LASSO_ROUNDS),
              f"{label}: launches {got}, want {only('B2', LASSO_ROUNDS)}")
        gaps = [rec.gap for rec in traj.records]
        check(all(np.isfinite(g) and g >= 0 for g in gaps)
              and gaps[-1] < gaps[0], f"{label}: gaps {gaps}")
        check(bool(torch.isfinite(x).all() and torch.isfinite(r).all()),
              f"{label}: x or r not finite")
        reached = lasso_reached(traj, target)
        ms = traj.records[-1].wall_time / LASSO_ROUNDS * 1e3
        launched[label] = got
        result[label] = (ms, reached, gaps[-1], target)
        runs[label] = [cli.RunResult(traj.algorithm, r, x, traj)]
        print(f"phase 9: {label} ok: 1 B2 launch per round, {ms:.3f} ms per "
              f"round (evals included); gap {gaps[0]:.6g} at round "
              f"{traj.records[0].round} to {gaps[-1]:.6g} at "
              f"{traj.records[-1].round}; 1e-3 relative target {target:.6g} "
              + (f"reached at round {reached}" if reached else
                 "not reached"))
    return launched, result, runs


def hybrid_args(ds, w, alpha, idxs, lam, n):
    """The positional arguments of B1 on a hybrid dataset, and the panel's
    keyword arguments."""
    return ((w, alpha, ds.sp_indices, ds.sp_values, ds.labels, ds.sq_norms,
             idxs, lam, n), dict(hot_cols=ds.hot_cols, hot_panel=ds.X_hot))


def column0_panel(ds):
    """A copy of the all-columns-hot demo shards (d < n_hot, so the last
    lanes are padding at column 0, value 0) in which the real lane 0,
    column 0, holds 0.5 in every row: the fold of Delta-w_hot adds the
    real column 0 and the padding lanes at the same address."""
    hc = ds.hot_cols
    check(bool((hc[:, 0] == 0).all() and (hc[:, -1] == 0).all()),
          "the full-width demo panel has no padding lanes at column 0")
    X_hot = ds.X_hot.clone()
    X_hot[:, :, 0] = 0.5 * ds.mask
    return dataclasses.replace(ds, X_hot=X_hot,
                               sq_norms=ds.sq_norms + 0.25 * ds.mask)


def phase_hybrid_kernel(shapes, worst):
    """B1's hot-panel branch against its plain version on the same CUDA
    tensors, with forced repeats at every distance inside and past the
    ring: ``shapes`` {name: ({dtype: dataset}, H, lam, n, cases)}, a case
    (mode, sigma or None for K, loss, smoothing); each case at every plan
    (SPARSE_PLANS: dw and Delta-w_hot asked into shared memory, where
    they fit, and into global memory).  Returns the plans met."""
    plans = set()
    for name, (sets, h, lam, n, cases) in shapes.items():
        for dt, ds in sets.items():
            for mode, sigma, loss, s in cases:
                w, alpha, idxs = round_inputs(ds, h, 3, prox=mode == "prox")
                args, hot = hybrid_args(ds, w, alpha, sparse_repeats(idxs),
                                        lam, n)
                kw = dict(mode=mode, sigma=sigma or float(ds.k), loss=loss,
                          smoothing=s, **hot)
                held_at_every_plan(
                    f"{name} {str(dt)[6:]} n_hot={ds.n_hot} {mode}/{loss} "
                    f"s={s}", ds, args, kw,
                    sp.sparse_sdca_round_plain(*args, **kw), dt, worst,
                    "B1h", plans)
    return plans


def hybrid_timing(rcv1, ds_h, k, h, lam):
    """B1's hot-panel branch and the unsplit B1 (float32, CoCoA+, hinge)
    on the same draws of the main path, timed in turns (unsplit, hybrid,
    hybrid, unsplit), the hybrid kernel with its state forced into global
    memory and the plain version; and the hybrid round's bound."""
    ds = shard_dataset(rcv1, k, layout="sparse", dtype=torch.float32,
                       device="cuda")
    w, alpha, idxs = round_inputs(ds_h, h, seed=5, repeats=False)
    kw = dict(mode="plus", sigma=float(k), loss="hinge")
    args, hot = hybrid_args(ds_h, w, alpha, idxs, lam, ds_h.n)
    rl, rl_h = row_lengths(ds.sp_values), row_lengths(ds_h.sp_values)
    unsplit_args = (w, alpha, ds.sp_indices, ds.sp_values, ds.labels,
                    ds.sq_norms, idxs, lam, ds.n)

    def unsplit():
        return cuda_ms(lambda: sp.sparse_sdca_round(
            *unsplit_args, row_len=rl, **kw), 25)

    def hybrid_ms(smem=True, reps=25):
        return cuda_ms(lambda: sp.sparse_sdca_round(
            *args, row_len=rl_h, dw_in_smem=smem, **kw, **hot), reps)

    t = [unsplit(), hybrid_ms(), hybrid_ms(), unsplit()]
    out = dict(ms=(t[1] + t[2]) / 2, unsplit_ms=(t[0] + t[3]) / 2,
               global_ms=hybrid_ms(False),
               plain_ms=cuda_ms(lambda: sp.sparse_sdca_round_plain(
                   *args, **kw, **hot), 3))
    # each input read once, each output written once: the distinct
    # sampled rows' panel rows and residual slots with their y, |x|^2 and
    # row length, w, hot_cols, the (K, d) dw written, alpha read and
    # written, and each step's draw; per step 6 operations a panel lane
    # and a residual nonzero (margin and axpy)
    isz, d, n_hot = 4, ds_h.num_features, ds_h.n_hot
    rows = distinct_rows(idxs)
    nnz = sum(int(rl_h[s, r].sum()) for s, r in enumerate(rows))
    n_rows = sum(r.numel() for r in rows)
    n_bytes = (n_rows * (n_hot * isz + 2 * isz + 4) + nnz * (4 + isz)
               + d * isz + k * n_hot * 4 + k * d * isz
               + 2 * k * ds_h.n_shard * isz + k * h * 4)
    flops = 6 * (k * h * n_hot + int(rl_h.gather(1, idxs.long()).sum()))
    out.update(bound=bound(n_bytes, flops), n_bytes=n_bytes, rows=n_rows)
    return out


def phase_hybrid_path(rcv1_argv, rcv1_seq, width, demo_train, demo_test):
    """The hybrid layout through the CLI, every kernel's launches counted
    from 0 just before each run and read just after: rcv1-like data with
    --hotCols=auto sequentially (one B1h launch per round, nothing else)
    and with --blockSize=auto (B5, B3 and B6 on the residual, one each a
    block), the gaps within relative 1e-3 of phase 4's unsplit sequential
    run (the same draws and math); then the demo with --justCoCoA=false: six algorithms on the
    hybrid shards.  Returns ({run: counts}, {run: ms per round})."""
    launched, per_round = {}, {}
    blocks = -(-max(1, int(0.1 * RCV1_SHAPE[0] / 8)) // BLOCK)
    block_want = {name: 0 for name in KERNELS}
    block_want.update(B3=400 * blocks, B5=400 * blocks, B6=400 * blocks)
    for label, extra, want in (
            ("rcv1-like hybrid sequential", [], only("B1h", 400)),
            ("rcv1-like hybrid block", ["--blockSize=auto"], block_want)):
        (out, res), got = reset_and_run(
            run_cli, rcv1_argv + ["--hotCols=auto"] + extra)
        (OUT / f"chip_smoke_{label.replace(' ', '_')}.log").write_text(out)
        check(f"hotCols=auto: panel {width} columns" in out,
              f"{label}: the CLI did not resolve a {width}-column panel")
        check(got == want, f"{label}: launches {got}, want {want}")
        check_run(res, label)
        check_same_gaps(f"{label} vs unsplit", res, rcv1_seq)
        launched[label] = got
        per_round[label] = [r.trajectory.records[-1].wall_time / 200 * 1e3
                            for r in res]
        print(f"phase 10: {label} ok: launches {got}, gaps within rel 1e-3 "
              f"of the unsplit run; ms per round (evals included) CoCoA+ "
              f"{per_round[label][0]:.3f}, CoCoA {per_round[label][1]:.3f}")
    rounds = 50
    argv = [f"--trainFile={demo_train}", f"--testFile={demo_test}",
            "--numFeatures=9947", "--numSplits=4", f"--numRounds={rounds}",
            "--localIterFrac=0.1", "--math=fast", "--dtype=float32",
            "--lambda=.001", "--justCoCoA=false", "--hotCols=auto"]
    label = "demo menu hybrid"
    (out, res), got = reset_and_run(run_cli, argv)
    (OUT / "chip_smoke_demo_menu_hybrid.log").write_text(out)
    resolved = [ln for ln in out.splitlines() if ln.startswith("hotCols=")]
    check(len(resolved) == 1, f"{label}: no resolution line")
    check(got == only("B1h", 3 * rounds),
          f"{label}: launches {got}, want {only('B1h', 3 * rounds)}")
    names = tuple(r.algorithm for r in res)
    check(names == MENU, f"{label}: ran {names}")
    check_run(res[:3], label)
    check_primal_only(res[3:], label)
    launched[label] = got
    print(f"phase 10: {label} ok: {resolved[0]}; six algorithms, "
          f"{3 * rounds} B1h launches")
    return launched, per_round


# phase 11: ProxCoCoA+ through the block round.  The lasso design's
# block sizes (B, route, kernel); B5 at padded widths past the whole-row
# plans (float32 1560 and up, float64 1028 and up), on K=2 shards of rows
# of distinct random columns among WIDE_GRAM_D
PROX_BLOCKS = ((BLOCK, "fused", "B4"), (4 * BLOCK, "split", "B3"))
WIDE_GRAM = {torch.float32: (1560, 1738, 20000),
             torch.float64: (1028, 1738)}
WIDE_GRAM_D = 40_000
TALL_ROUNDS = 30
# float32 block and sequential runs of the lasso design: every eval's gap
# within relative 1e-3 plus this many ulps of the primal in float32 (the
# certificate's resolution: its last gaps are a few ulps, 2^-15 each at a
# primal near 256; on an H100 the block and sequential float32 gaps
# differed by one ulp from round 900, while float64 runs agreed in every
# printed digit)
F32_GAP_ULPS = 4


def prox_block_inputs(ds, b, dt, seed=5):
    """The first block of a prox round on column shards (dense or padded
    CSC) in ``dt``: B draws with forced repeats (every fourth step redraws
    the one before), the last 28 steps masked, unbounded coordinates x, a
    residual r and a Delta-r; the gathered columns (``xb``, dense) or
    their slots (``gidx``, ``gvals``, ``cnts``, padded CSC)."""
    k, n, dev = ds.k, ds.num_features, ds.device
    idxs = base.IndexSampler("reference", seed, b, ds.counts) \
        .round_indices(1).to(dev).long()
    idxs[:, 1::4] = idxs[:, 0::4]
    rng = np.random.default_rng(seed)

    def put(a):
        return torch.as_tensor(a).to(dev, dt)

    x = put(rng.normal(size=(k, ds.n_shard)) * 0.3) * ds.mask.to(dt)
    live_b = torch.arange(b, device=dev) < b - 28
    out = dict(bidx32=idxs.int(), live=live_b.to(dt).expand(k, b)
               .contiguous(), yb=ds.labels.gather(1, idxs).to(dt),
               sq=ds.sq_norms.gather(1, idxs).to(dt), a0=x.gather(1, idxs),
               r=put(rng.normal(size=n) * 0.1),
               dr=put(rng.normal(size=(k, n)) * 0.01))
    if ds.layout == "dense":
        out["xb"] = dense_rows({"X": ds.X}, idxs, n).to(dt)
    else:
        ks = torch.arange(k, device=dev)[:, None]
        out.update(gidx=ds.sp_indices[ks, idxs].contiguous(),
                   gvals=ds.sp_values[ks, idxs].to(dt).contiguous(),
                   cnts=torch.where(live_b, row_lengths(ds.sp_values)
                                    .gather(1, idxs), -1).to(torch.int32))
    return out


def lasso_kw(lam, sig, l2):
    """The chain's arguments in mode prox: lam_n the L1 weight (n = 1),
    the raw coordinate delta as the coefficient, the elastic-net l2."""
    return dict(lam_n=lam, coef_div=1.0, sig_eff=sig, frozen=False,
                loss="lasso", smoothing=l2)


def phase_prox_block_kernels(designs, demo_cols, worst):
    """B3, B4, B5 and B6 in mode prox with the lasso rule at l2 0 and 0.1
    against their plain versions, float32 and float64.  ``designs``:
    {name: (dense column dataset, L1 weight)}; B4 on a block of each
    (d = n: 8192, 100000 and the demo's 2000) at cluster sizes 1, 2, 4, 8
    and the auto plan, two launches of the auto plan bit for bit; B3 at
    every plan of :func:`chain_plans_held` at B = 128 and 512 on the
    first design's split inputs (its Gram by a full-float32 product); B5
    at every plan of :func:`gram_plans_held`, B3 and B6 (into Delta-r, of
    length n; at every plan of :func:`apply_plans_held`, on the variants
    of :func:`apply_variants`, bit for bit with its plain version on the
    CPU) on the demo's padded-CSC columns (``demo_cols`` by dtype; rows
    1738 wide), two launches of each bit for bit.  Returns the plans
    held."""
    held = set()
    first = next(iter(designs))
    for name, (ds, lam) in designs.items():
        sig = float(ds.k)
        for dt in (torch.float32, torch.float64):
            n = ds.num_features
            bi = prox_block_inputs(ds, BLOCK, dt)
            v = bi["r"] + sig * bi["dr"]
            fargs = (bi["xb"], bi["bidx32"], bi["yb"], bi["sq"] * sig,
                     bi["a0"], bi["live"], v)
            for l2 in PROX_L2:
                kw = lasso_kw(lam, sig, l2)
                tag = f"{name} {str(dt)[6:]} prox/lasso l2={l2}"
                want = bc.fused_block_plain(*fargs, **kw)
                for c in (1, 2, 4, 8, None):
                    plan = bc.fused_plan(BLOCK, n, dt.itemsize, c)
                    held.add(("B4", str(dt)[6:], n, plan))
                    agree(f"{tag} fused_block cluster={c} plan={plan}",
                          bc.fused_block(*fargs, cluster=c, **kw), want, dt,
                          worst, "B4", (1.0, 0.0))
                bit_for_bit(f"{tag} fused_block",
                            lambda: bc.fused_block(*fargs, **kw))
            del bi, fargs
            if name != first:
                continue
            for b in (BLOCK, 4 * BLOCK):
                bi = prox_block_inputs(ds, b, dt)
                v = bi["r"] + sig * bi["dr"]
                with bc.fp32_matmul():
                    mbase = torch.matmul(bi["xb"], v[:, :, None])[..., 0]
                    gram = torch.matmul(bi["xb"], bi["xb"].transpose(1, 2))
                scal = torch.stack([mbase, bi["yb"], bi["sq"] * sig,
                                    bi["a0"], torch.zeros_like(mbase),
                                    bi["live"]], 1)
                for l2 in PROX_L2:
                    held_chain(f"{name} {str(dt)[6:]} prox/lasso l2={l2}",
                               scal, gram, bi["bidx32"],
                               lasso_kw(lam, sig, l2), dt, worst, held)
    for dt, ds in demo_cols.items():
        sig = float(ds.k)
        bi = prox_block_inputs(ds, BLOCK, dt)
        rows = (bi["gidx"], bi["gvals"], bi["cnts"])
        width = rows[0].shape[-1]
        gargs = (bi["r"], bi["dr"], *rows, sig, False)
        gram, mb = sb.sparse_block_gram_plain(*gargs)
        tag = f"demo columns {str(dt)[6:]} W={width}"
        for kw, plan in gram_plans_held(width, dt):
            held.add(("B5", str(dt)[6:], width, plan[:4]))
            agree(f"{tag} sparse_block_gram {kw} plan={plan}",
                  sb.sparse_block_gram(*gargs, **kw), (gram, mb), dt, worst,
                  "B5")
        bit_for_bit(f"{tag} sparse_block_gram",
                    lambda: sb.sparse_block_gram(*gargs))
        scal = torch.stack([mb, bi["yb"], bi["sq"] * sig, bi["a0"],
                            torch.zeros_like(mb), bi["live"]], 1)
        for l2 in PROX_L2:
            coefs = held_chain(f"{tag} prox/lasso l2={l2}", scal, gram,
                               bi["bidx32"], lasso_kw(0.1, sig, l2), dt,
                               worst, held)[1]
            held_apply(f"{tag} l2={l2} into Delta-r", bi["dr"],
                       apply_variants(gram_variants(dict(bi, ds=ds))),
                       coefs, dt, worst, held)
    return held


def prox_block_timing(designs, demo_cols):
    """ms per launch in mode prox with the lasso rule, float32, at the
    main path's shapes: B4 on a block of each dense design (CUDA events
    around wrapper calls, as phase 5), B3 at 8 x 512 on the first
    design's split inputs, and B5, B3 and B6 on the demo's padded-CSC
    columns (the kernels alone, CUDA-graph replay)."""
    f32, out = torch.float32, {}
    first = next(iter(designs))
    for name, (ds, lam) in designs.items():
        sig = float(ds.k)
        kw = lasso_kw(lam, sig, 0.0)
        bi = prox_block_inputs(ds, BLOCK, f32, seed=9)
        fargs = (bi["xb"], bi["bidx32"], bi["yb"], bi["sq"] * sig,
                 bi["a0"], bi["live"], bi["r"] + sig * bi["dr"])
        out[f"B4 {name} {ds.k} x {BLOCK} x {ds.num_features}"] = cuda_ms(
            lambda: bc.fused_block(*fargs, **kw), 20)
        del bi, fargs
        if name != first:
            continue
        bi = prox_block_inputs(ds, 4 * BLOCK, f32, seed=9)
        v = bi["r"] + sig * bi["dr"]
        with bc.fp32_matmul():
            mbase = torch.matmul(bi["xb"], v[:, :, None])[..., 0]
            gram = torch.matmul(bi["xb"], bi["xb"].transpose(1, 2))
        scal = torch.stack([mbase, bi["yb"], bi["sq"] * sig, bi["a0"],
                            torch.zeros_like(mbase), bi["live"]], 1)
        out[f"B3 {name} {ds.k} x {4 * BLOCK}"] = graph_ms(
            lambda: bc.chain_block_batched(scal, gram, bi["bidx32"], **kw),
            20)
        del bi
    ds = demo_cols[f32]
    sig = float(ds.k)
    bi = prox_block_inputs(ds, BLOCK, f32, seed=9)
    rows = (bi["gidx"], bi["gvals"], bi["cnts"])
    gargs = (bi["r"], bi["dr"], *rows, sig, False)
    gram, mb = sb.sparse_block_gram_plain(*gargs)
    scal = torch.stack([mb, bi["yb"], bi["sq"] * sig, bi["a0"],
                        torch.zeros_like(mb), bi["live"]], 1)
    kw = lasso_kw(0.1, sig, 0.0)
    coefs = bc.chain_block_batched_plain(scal, gram, bi["bidx32"], **kw)[1]
    dr = bi["dr"].clone()
    tag = f"demo columns {ds.k} x {BLOCK} W={rows[0].shape[-1]}"
    out[f"B5 {tag}"] = graph_ms(lambda: sb.sparse_block_gram(*gargs), 50)
    out[f"B3 {tag}"] = graph_ms(lambda: bc.chain_block_batched(
        scal, gram, bi["bidx32"], **kw), 50)
    out[f"B6 {tag}"] = graph_ms(lambda: sb.sparse_block_apply(
        dr, *rows, coefs), 50)
    return out


def wide_gram_inputs(width, dt, k=2, seed=13):
    """A block of K x B rows ``width`` slots wide, each of distinct random
    columns among WIDE_GRAM_D (every fifth row's last slot repeating its
    first, so a column repeats across the passes of a row in passes),
    every seventh row a third as long, the last three masked; w and a
    Delta-w."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d = WIDE_GRAM_D
    gidx = torch.argsort(torch.rand(k, BLOCK, d, device="cuda",
                                    generator=gen), dim=-1)[..., :width]
    gidx[:, ::5, -1] = gidx[:, ::5, 0]
    cnts = torch.full((k, BLOCK), width, dtype=torch.int32, device="cuda")
    cnts[:, 1::7] = width // 3
    cnts[:, -3:] = -1
    return (torch.randn(d, device="cuda", generator=gen, dtype=dt) * 0.1,
            torch.randn(k, d, device="cuda", generator=gen, dtype=dt) * 0.01,
            gidx.to(torch.int32).contiguous(),
            torch.randn(k, BLOCK, width, device="cuda", generator=gen,
                        dtype=dt), cnts)


def phase_wide_gram(worst):
    """B5 at the widths of WIDE_GRAM against its plain version at its auto
    plan, two launches of the widest bit for bit, and its time per launch
    (the kernels alone, CUDA-graph replay).  Returns {(dtype, width):
    (plan, passes, ms)}."""
    optin = kernels.smem_optin("cuda")
    out = {}
    for dt, widths in WIDE_GRAM.items():
        for width in widths:
            args = (*wide_gram_inputs(width, dt), 4.0, False)
            plan = sb.gram_plan(BLOCK, width, dt.itemsize, optin)
            passes = -(-width // plan.cap)
            tag = f"wide rows {str(dt)[6:]} W={width}"
            agree(f"{tag} sparse_block_gram plan={plan} passes={passes}",
                  sb.sparse_block_gram(*args),
                  sb.sparse_block_gram_plain(*args), dt, worst, "B5")
            if width == max(widths):
                bit_for_bit(f"{tag} sparse_block_gram",
                            lambda: sb.sparse_block_gram(*args))
            out[(str(dt)[6:], width)] = (
                plan, passes, graph_ms(lambda: sb.sparse_block_gram(*args),
                                       5))
            del args
    return out


def lasso_reached(traj, target):
    """The first eval round whose gap is at or below ``target``, or None."""
    return next((rec.round for rec in traj.records if rec.gap <= target),
                None)


def phase_prox_block_path(demo_train, demo_seq, lasso, lasso_seq, tall):
    """ProxCoCoA+ through the block round, every kernel's launches counted
    from 0 just before each run and read just after: the demo's columns
    through the CLI with --blockSize=128 on the dense layout (B4) and the
    padded-CSC one (B5, B3, B6), each against phase 9's sequential run
    (``demo_seq`` by layout); the lasso design (``lasso``: dataset, b,
    lambda_max) through run_prox_cocoa for LASSO_ROUNDS rounds at each of
    PROX_BLOCKS, lasso and elastic net, in float32 against phase 9's
    sequential runs (``lasso_seq``) and in float64 against float64
    sequential runs; and the tall design through the fused branch beside
    its own sequential run.  Gaps within relative 1e-3 of the sequential
    run at every eval (float32 lasso design runs: plus F32_GAP_ULPS ulps
    of the primal).  Returns ({run: counts}, {run: ms per round})."""
    launched, per_round = {}, {}
    rounds = 50
    argv = [f"--trainFile={demo_train}", "--numFeatures=9947",
            "--numSplits=4", f"--numRounds={rounds}", "--localIterFrac=0.1",
            "--math=fast", "--dtype=float32", "--lambda=.1",
            "--objective=lasso", "--blockSize=128"]
    nb = -(-max(1, int(0.1 * 9947 / 4)) // BLOCK)
    for layout, kerns in (("dense", ("B4",)), ("sparse", ("B5", "B3",
                                                          "B6"))):
        label = f"demo lasso {layout} --blockSize=128"
        (out, res), got = reset_and_run(run_cli, argv + [f"--layout={layout}"])
        (OUT / f"chip_smoke_demo_lasso_{layout}_block.log").write_text(out)
        want = {name: rounds * nb if name in kerns else 0 for name in KERNELS}
        check(got == want, f"{label}: launches {got}, want {want}")
        check_same_gaps(f"{label} vs sequential", res, demo_seq[layout])
        launched[label] = got
        per_round[label] = res[0].trajectory.records[-1].wall_time \
            / rounds * 1e3
        print(f"phase 11: {label} ok: {'/'.join(kerns)} {nb} a round each, "
              f"gaps within rel 1e-3 of the sequential run; "
              f"{per_round[label]:.3f} ms per round (evals included)")
    ds, b, lam_max = lasso
    d = ds.n
    h = d // ds.k // 10
    target = 1e-3 * 0.5 * float(b @ b)
    # float32, the timed runs beside phase 9's sequential ones; float64,
    # whose certificate resolves the gaps far below a float32 ulp of the
    # primal (the float32 gaps of the last evals are a few of those)
    f32, f64 = torch.float32, torch.float64
    runs = {(f32, 0, tag): lasso_seq[f"lasso design {tag}"]
            for tag in ("lasso", "elastic net")}
    for dt in (f32, f64):
        dsd, bd = (ds, b) if dt == f32 else (as_dtype(ds, dt), b.to(dt))
        for bs, route, kern in ((0, "sequential", "B2"), *PROX_BLOCKS):
            if bs:
                check(cocoa_mod.block_route("dense", bs, dt) == route,
                      f"lasso design B={bs} does not route {route}")
            elif dt == f32:
                continue
            nbl = -(-h // (bs or h))
            for tag, l2 in (("lasso", 0.0), ("elastic net", 0.1)):
                label = f"lasso design {str(dt)[6:]} {tag} B={bs} {route}"
                params = Params(n=d, num_rounds=LASSO_ROUNDS, local_iters=h,
                                lam=0.3 * lam_max, loss="lasso", smoothing=l2)
                (x, r, traj), got = reset_and_run(
                    run_prox_cocoa, dsd, bd, params,
                    DebugParams(debug_iter=50, seed=0), quiet=True,
                    math="fast", block_size=bs)
                check(got == only(kern, LASSO_ROUNDS * nbl),
                      f"{label}: launches {got}, want "
                      f"{only(kern, LASSO_ROUNDS * nbl)}")
                check(bool(torch.isfinite(x).all()
                           and torch.isfinite(r).all()),
                      f"{label}: x or r not finite")
                runs[(dt, bs, tag)] = res = [
                    cli.RunResult(traj.algorithm, r, x, traj)]
                launched[label] = got
                ms = traj.records[-1].wall_time / LASSO_ROUNDS * 1e3
                per_round[label] = ms
                seq = runs[(dt, 0, tag)][0].trajectory
                if bs:
                    check_same_gaps(label, res, runs[(dt, 0, tag)],
                                    ulps=F32_GAP_ULPS if dt == f32 else 0)
                print(f"phase 11: {label} ok: {nbl} {kern} launches per "
                      f"round, {ms:.3f} ms per round (evals included; "
                      f"sequential B2 "
                      f"{seq.records[-1].wall_time / LASSO_ROUNDS * 1e3:.3f}"
                      f"); 1e-3 relative target {target:.6g} reached at "
                      f"round {lasso_reached(traj, target)} (sequential: "
                      f"{lasso_reached(seq, target)}); round:gap/sequential "
                      + " ".join(f"{a.round}:{a.gap:.6g}/{c.gap:.6g}"
                                 for a, c in zip(traj.records, seq.records)))
        del dsd, bd
    ds, b, lam_max = tall
    h = max(1, ds.n // ds.k // 10)
    params = Params(n=ds.n, num_rounds=TALL_ROUNDS, local_iters=h,
                    lam=0.3 * lam_max, loss="lasso", smoothing=0.0)
    runs = {}
    for bs, kern in ((0, "B2"), (BLOCK, "B4")):
        label = f"tall lasso design B={bs or 'sequential'}"
        (x, r, traj), got = reset_and_run(
            run_prox_cocoa, ds, b, params, DebugParams(debug_iter=10, seed=0),
            quiet=True, math="fast", block_size=bs)
        check(got == only(kern, TALL_ROUNDS * (-(-h // (bs or h)))),
              f"{label}: launches {got}")
        gaps = [rec.gap for rec in traj.records]
        check(all(np.isfinite(g) and g >= 0 for g in gaps)
              and gaps[-1] < gaps[0], f"{label}: gaps {gaps}")
        runs[bs] = [cli.RunResult(traj.algorithm, r, x, traj)]
        launched[label] = got
        per_round[label] = traj.records[-1].wall_time / TALL_ROUNDS * 1e3
        print(f"phase 11: {label} ok: 1 {kern} launch per round, "
              f"{per_round[label]:.3f} ms per round (evals included); gaps "
              + " ".join(f"{rec.round}:{rec.gap:.6g}" for rec in
                         traj.records))
    check_same_gaps("tall lasso design fused vs sequential", runs[BLOCK],
                    runs[0])
    return launched, per_round



# --- phase 12: the gap-targeted driver ladder -------------------------------

GAP_TARGET = 1e-4
# the coherent shards' data seed whose bail-out round does not move with
# rounding: 425 in 12 of 12 CPU runs with X perturbed by 3e-7, in float32
# and float64 (tests/test_torch_gap_target.py); the oscillation multiplies
# a rounding difference by ~10 every 25 rounds
COHERENT_SEED = 7


def coherent_shards(k=4, m=32, d=16, seed=COHERENT_SEED):
    """tests/test_divergence.py's K identical shards (the same m unit rows
    K times: the true coupling is sigma' = K), dense float32 on the card."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.where(x @ rng.standard_normal(d) >= 0, 1.0, -1.0)
    n = k * m
    data = LibsvmData(labels=np.tile(y, k),
                      indptr=np.arange(0, (n + 1) * d, d, dtype=np.int64),
                      indices=np.tile(np.arange(d, dtype=np.int32), n),
                      values=np.tile(x, (k, 1)).reshape(-1), num_features=d)
    return shard_dataset(data, k, layout="dense", dtype=torch.float32,
                         device="cuda"), n


def stop_of(traj):
    """(stopped, last eval round, wall seconds to it)."""
    last = traj.records[-1]
    return traj.stopped, last.round, last.wall_time


def ladder_line(label, results, got):
    """One case's line: each run's stop, round and seconds, and the
    launches of every kernel that ran."""
    runs = "; ".join(f"{r.algorithm} {r.trajectory.stopped} at round "
                     f"{r.trajectory.records[-1].round} in "
                     f"{r.trajectory.records[-1].wall_time:.3f} s"
                     for r in results)
    kern = ", ".join(f"{k} {v}" for k, v in got.items() if v) or "none"
    print(f"phase 12: {label}: {runs}; launches {kern}")


def check_gaps_common(label, res, ref, debug_iter, rel=1e-3):
    """The same stop reason, stop rounds within one ``debug_iter``, and
    every common eval's gap within relative ``rel``."""
    for r, p in zip(res, ref):
        a, b = r.trajectory, p.trajectory
        check(a.stopped == b.stopped,
              f"{label} {r.algorithm}: stopped {a.stopped} vs {b.stopped}")
        check(abs(a.records[-1].round - b.records[-1].round) <= debug_iter,
              f"{label} {r.algorithm}: stop round {a.records[-1].round} vs "
              f"{b.records[-1].round}")
        for x, y in zip(a.records, b.records):
            check(x.round == y.round and abs(x.gap - y.gap) <= rel * y.gap,
                  f"{label} {r.algorithm} round {x.round}: gap {x.gap} vs "
                  f"{y.gap}")


def phase_ladder(rcv1, lasso, card):
    """The gap-targeted driver ladder on the card, float32, --math=fast,
    every kernel's count set to 0 just before each run and read just
    after: (a) the demo to a 1e-4 gap through the CLI (accel auto) against
    the same run through the plain versions; (b) the demo's ladder runs
    (--sigma=auto anneal and trial, --warmStart); (c) rcv1-like data with
    sigma' auto, and at the safe sigma' with accel auto and off; (d) the
    rcv1-like block path; (e) the coherent shards' bail-out on B2 against
    the plain route; (f) the lasso design to 1e-3 |b|^2/2, sequential and
    at B=512.  Returns {run: counts}."""
    launched = {}
    demo = [f"--trainFile={DEMO_TRAIN}", f"--testFile={DEMO_TEST}",
            "--numFeatures=9947", "--numSplits=4", "--numRounds=500",
            "--localIterFrac=0.1", "--lambda=.001", "--math=fast",
            "--dtype=float32", f"--gapTarget={GAP_TARGET}"]

    def rounds_run(res):
        return sum(r.trajectory.records[-1].round for r in res)

    # (a) the demo to the target, kernels against the plain versions
    (out, res), got = reset_and_run(run_cli, demo)
    (OUT / "chip_smoke_demo_gap_target.log").write_text(out)
    check(all(r.trajectory.stopped == "target" for r in res),
          f"(a) demo: stopped {[r.trajectory.stopped for r in res]}")
    check(got == only("B1", rounds_run(res)),
          f"(a) demo: launches {got}, want {only('B1', rounds_run(res))}")
    check_run(res, "(a) demo to 1e-4")
    with plain_kernels():
        (_, plain), got_p = reset_and_run(run_cli, demo)
    check(not any(got_p.values()), f"(a) plain run launched {got_p}")
    check_gaps_common("(a) demo kernel vs plain", res, plain, 10)
    launched["(a) demo"] = got
    ladder_line("(a) demo CLI --gapTarget=1e-4 (accel auto)", res, got)
    ladder_line("(a) the same through the plain versions", plain, got_p)
    print(f"  (a) restarts: {out.count('momentum restart')} (kernels), "
          f"the plain run stops at "
          + ", ".join(str(p.trajectory.records[-1].round) for p in plain))

    # (b) the demo's ladder runs
    for label, extra in (("--sigma=auto", ["--sigma=auto"]),
                         ("--sigma=auto --sigmaSchedule=trial",
                          ["--sigma=auto", "--sigmaSchedule=trial"]),
                         ("--warmStart=0.5,30", ["--warmStart=0.5,30"])):
        (out, res), got = reset_and_run(run_cli, demo + extra)
        check(all(r.trajectory.stopped == "target" for r in res),
              f"(b) demo {label}: stopped "
              f"{[r.trajectory.stopped for r in res]}")
        check(got == only("B1", rounds_run(res)),
              f"(b) demo {label}: launches {got}")
        check_run(res, f"(b) demo {label}")
        sig = [rec.sigma for rec in res[0].trajectory.records]
        if label == "--sigma=auto":
            check(all(s in base.anneal_levels(2.0, 4.0) for s in sig),
                  f"(b) {label}: CoCoA+ sigma' {sig}")
        else:
            check(all(s is None for s in sig), f"(b) {label}: sigma' {sig}")
        check(all(rec.sigma is None for rec in res[1].trajectory.records),
              f"(b) {label}: CoCoA ran a schedule")
        launched[f"(b) demo {label}"] = got
        ladder_line(f"(b) demo {label}", res, got)
        print(f"  (b) CoCoA+ sigma' by eval: {sorted(set(sig), key=str)}; "
              f"restart lines {out.count('restarting with the safe')}, "
              f"backoff lines {out.count('backing off')}")

    # (c) rcv1-like with sigma' auto; the safe sigma' with accel on, off
    k, h = 8, rcv1.n // 8 // 10
    ds = shard_dataset(rcv1, k, layout="sparse", dtype=torch.float32,
                       device="cuda")
    debug = DebugParams(debug_iter=25, seed=0)
    run = dict(plus=True, quiet=True, math="fast", gap_target=GAP_TARGET,
               rng="permuted")

    def rcv1_params(sigma):
        return Params(n=rcv1.n, num_rounds=1600, local_iters=h, lam=1e-4,
                      sigma=sigma)

    seq = {}
    for label, sigma, kw in (("sigma' auto", "auto", {}),
                             ("safe sigma' accel auto", None,
                              dict(accel="auto")),
                             ("safe sigma' accel off", None,
                              dict(accel="off"))):
        (w, alpha, traj), got = reset_and_run(
            cocoa_mod.run_cocoa, ds, rcv1_params(sigma), debug, **run, **kw)
        res = [cli.RunResult(traj.algorithm, w, alpha, traj)]
        rounds = traj.records[-1].round
        check(traj.stopped == "target", f"(c) rcv1-like {label}: stopped "
                                        f"{traj.stopped} at {rounds}")
        check(got == only("B1", rounds), f"(c) {label}: launches {got}")
        check_run(res, f"(c) rcv1-like {label}")
        if sigma == "auto":
            check(all(rec.sigma == k / 2.0 for rec in traj.records),
                  "(c) rcv1-like sigma' auto backed off")
        seq[label] = res
        launched[f"(c) rcv1-like {label}"] = got
        ladder_line(f"(c) rcv1-like K=8 H={h} lambda=1e-4 {label}", res,
                    got)
    auto_stop = seq["sigma' auto"][0].trajectory.records[-1].round
    print(f"  (c) rcv1-like sigma' auto stops at round {auto_stop} (JAX's "
          f"pin, tests/test_sigma_anneal.py:337: <= 575), no "
          f"backoff; the safe sigma' to 1e-4: accel auto "
          + " vs accel off ".join(
              f"{seq[lb][0].trajectory.records[-1].round} rounds in "
              f"{seq[lb][0].trajectory.records[-1].wall_time:.3f} s"
              for lb in ("safe sigma' accel auto", "safe sigma' accel off")))

    # the host builds each chunk's (C, K, H) draw tables: their time a
    # round in --rng=permuted (these runs) and reference (phase 4)
    tables_ms = {}
    for mode in ("permuted", "reference"):
        sampler = base.IndexSampler(mode, 0, h, ds.counts)
        t0 = time.perf_counter()
        for t in range(1, auto_stop + 1, 25):
            sampler.chunk_indices(t, 25)
        tables_ms[mode] = (time.perf_counter() - t0) / auto_stop * 1e3
    auto_wall = seq["sigma' auto"][0].trajectory.records[-1].wall_time
    print(f"  (c) wall clock per round to the stop (evals included): "
          f"sigma' auto {auto_wall / auto_stop * 1e3:.3f} ms; host draw "
          f"tables per round: " + ", ".join(
              f"{mode} {ms:.3f} ms" for mode, ms in tables_ms.items()))

    # (d) the rcv1-like block path, sigma' auto
    (w, alpha, traj), got = reset_and_run(
        cocoa_mod.run_cocoa, ds, rcv1_params("auto"), debug, block_size=BLOCK,
        **run)
    res = [cli.RunResult(traj.algorithm, w, alpha, traj)]
    nb = -(-h // BLOCK) * traj.records[-1].round
    want = {name: 0 for name in KERNELS}
    want.update(B3=nb, B5=nb, B6=nb)
    check(traj.stopped == "target", f"(d) block: stopped {traj.stopped}")
    check(got == want, f"(d) block: launches {got}, want {want}")
    check_run(res, "(d) rcv1-like block")
    a, b = traj.records, seq["sigma' auto"][0].trajectory.records
    for x, y in zip(a, b):
        check(x.round == y.round and abs(x.gap - y.gap) <= 1e-3 * y.gap,
              f"(d) block round {x.round}: gap {x.gap} vs sequential {y.gap}")
    launched["(d) rcv1-like block"] = got
    ladder_line(f"(d) rcv1-like --blockSize={BLOCK} sigma' auto", res, got)
    del ds

    # (e) the coherent shards' bail-out, B2 against the plain route
    coh, n = coherent_shards()
    params = Params(n=n, num_rounds=1600, local_iters=16, lam=1e-4,
                    sigma=1.0)
    kw = dict(plus=True, math="fast", gap_target=1e-3, rng="jax")
    outs = {}
    # plain_kernels() patches as it is called, so each context is made
    # just before its run
    for label, ctx in (("kernel", contextlib.nullcontext),
                       ("plain", plain_kernels)):
        buf = io.StringIO()
        with ctx(), contextlib.redirect_stdout(buf):
            (_, _, traj), got = reset_and_run(
                cocoa_mod.run_cocoa, coh, params, debug, **kw)
        line = [ln for ln in buf.getvalue().splitlines() if "DIVERGED" in ln]
        check(traj.stopped == "diverged" and len(line) == 1,
              f"(e) coherent {label}: stopped {traj.stopped}")
        outs[label] = (traj, got, line[0])
    (tk, got, line), (tp, got_p, _) = outs["kernel"], outs["plain"]
    check(got == only("B2", tk.records[-1].round) and not any(got_p.values()),
          f"(e) coherent: launches {got} (plain run {got_p})")
    check(tk.records[-1].round == tp.records[-1].round,
          f"(e) coherent: DIVERGED at round {tk.records[-1].round} on the "
          f"kernel, {tp.records[-1].round} on the plain route")
    launched["(e) coherent"] = got
    print(f"phase 12: (e) coherent shards K=4 sigma'=1 dense (seed "
          f"{COHERENT_SEED}): {line}; the plain route at round "
          f"{tp.records[-1].round}; {tk.records[-1].wall_time:.3f} s; "
          f"launches B2 {got['B2']}")

    # (f) the lasso design to 1e-3 |b|^2 / 2, sequential and B=512
    lds, lb, lam_max = lasso
    target = 1e-3 * 0.5 * float(lb @ lb)
    hl = lds.n // lds.k // 10
    for tag, l2, want_rounds in (("lasso", 0.0, 550),
                                 ("elastic net", 0.1, 350)):
        params = Params(n=lds.n, num_rounds=LASSO_ROUNDS, local_iters=hl,
                        lam=0.3 * lam_max, loss="lasso", smoothing=l2)
        for b, kern in ((0, "B2"), (4 * BLOCK, "B3")):
            (x, r, traj), got = reset_and_run(
                run_prox_cocoa, lds, lb, params,
                DebugParams(debug_iter=50, seed=0), quiet=True, math="fast",
                gap_target=target, block_size=b)
            rounds = traj.records[-1].round
            check(traj.stopped == "target",
                  f"(f) {tag} B={b}: stopped {traj.stopped}")
            check(got == only(kern, rounds),
                  f"(f) {tag} B={b}: launches {got}")
            check(bool(torch.isfinite(x).all() and torch.isfinite(r).all()),
                  f"(f) {tag}: x or r not finite")
            launched[f"(f) {tag} B={b}"] = got
            print(f"phase 12: (f) lasso design {tag} "
                  f"{'sequential' if not b else f'B={b} split'} to "
                  f"{target:.6g}: stopped at round {rounds} (PERF.md §5: "
                  f"{want_rounds}) in {traj.records[-1].wall_time:.3f} s; "
                  f"launches {kern} {got[kern]}")
    print(f"phase 12: card {card}")
    return launched



# --- phase 13: the captured round loop and the tables made on the card

# the draw kernel's cases, (K, H, shard sizes, rounds a chunk): the demo's,
# the rcv1-like and epsilon-like main paths', and shards near 2^30 rows,
# where nextInt rejects about half of its raw draws
DRAW_SHAPES = {
    "demo": (4, 50, [500] * 4, 10),
    "rcv1-like": (8, 253, [2531] * 2 + [2530] * 6, 25),
    "epsilon-like": (8, 5000, [50_000] * 8, 10),
    "near 2^30": (4, 64, [(1 << 30) + 1, (1 << 30) + 3, (1 << 30) - 1,
                          1 << 30], 4),
}
# the draw kernel's timed shapes: the main path's chunk (phase 4: K=8,
# H=253, 25 rounds) and the epsilon-like sequential chunk (K=8, H=5000,
# 10 rounds)
DRAW_TIMED = {"rcv1-like": (8, 253, [2531] * 2 + [2530] * 6, 25),
              "epsilon-like": (8, 5000, [50_000] * 8, 10)}


def late_round(h: int, c: int) -> int:
    """A first round near 10^6 whose permuted global steps stay in int32
    (the host's rule)."""
    return min(1_000_000, (1 << 31) // h - c - 2)


def draw_case(mode, seed, h, counts, t0, c):
    """(kernel tables on the card, host tables)."""
    got = prng.draw_tables(
        mode, seed, h, torch.as_tensor(counts, dtype=torch.int64,
                                       device="cuda"),
        torch.tensor(t0, dtype=torch.int64, device="cuda"), c)
    return got, prng.host_tables(mode, seed, h, np.asarray(counts), t0, c)


def phase_draw_tables():
    """(a) The draw kernel against the host tables, bit for bit: the three
    modes at every shape of DRAW_SHAPES, first rounds 1 and near 10^6,
    seeds 0 and 2^31 - 1 - the last round; then its time per launch
    (CUDA-graph replay), its plain version's (the host tables) and its
    bound at DRAW_TIMED's shapes, and one lane alone (the reference
    mode's dependent chain).  Returns {shape: {mode: timing}}."""
    cases = 0
    for name, (k, h, counts, c) in DRAW_SHAPES.items():
        for mode in prng.MODES:
            for t0 in (1, late_round(h, c)):
                for seed in (0, (1 << 31) - 1 - (t0 + c)):
                    got, want = draw_case(mode, seed, h, counts, t0, c)
                    check(torch.equal(got.cpu(), want),
                          f"draw kernel {mode} {name} t0={t0} seed={seed}: "
                          f"{int((got.cpu() != want).sum())} entries differ")
                    cases += 1
    print(f"phase 13: (a) the draw kernel equals the host tables bit for "
          f"bit in {cases} cases (modes x shapes {list(DRAW_SHAPES)} x "
          f"first rounds 1 and ~1e6 x seeds 0 and 2^31-1-rounds)")
    timing = {}
    for name, (k, h, counts, c) in DRAW_TIMED.items():
        counts_d = torch.as_tensor(counts, dtype=torch.int64, device="cuda")
        one = counts_d[:1].contiguous()
        t0 = torch.tensor(1, dtype=torch.int64, device="cuda")
        n_bytes = c * k * h * 4 + k * 8 + 8
        timing[name] = {}
        for mode in prng.MODES:
            ms = graph_ms(lambda: prng.draw_tables(mode, 0, h, counts_d, t0,
                                                   c), 20)
            start = time.perf_counter()
            for _ in range(3):
                prng.host_tables(mode, 0, h, np.asarray(counts), 1, c)
            plain = (time.perf_counter() - start) / 3 * 1e3
            t = {"ms": ms, "plain_ms": plain, "n_bytes": n_bytes,
                 "bound": (n_bytes / HBM_BYTES_PER_S * 1e3, "bytes")}
            if mode == "reference":
                t["lane_ms"] = graph_ms(
                    lambda: prng.draw_tables(mode, 0, h, one, t0, 1), 20)
            timing[name][mode] = t
            print(f"  draw kernel {name} (C={c}, K={k}, H={h}) {mode}: "
                  f"{ms:.4f} ms per launch, plain (host) {plain:.3f} ms, "
                  f"bound {t['bound'][0]:.5f} ms (bytes: {n_bytes} B)"
                  + (f"; one lane alone (H={h} draws in sequence) "
                     f"{t['lane_ms']:.4f} ms" if "lane_ms" in t else ""))
    return timing


def steady_ms(traj) -> float:
    """ms per round between the first eval and the last: past the first
    chunk, which a captured run spends running eagerly and capturing."""
    a, b = traj.records[0], traj.records[-1]
    return (b.wall_time - a.wall_time) / max(1, b.round - a.round) * 1e3


def same_bits(res, ref) -> bool:
    """Two runs' trajectories and final iterates bit for bit."""
    for r, p in zip(res, ref):
        ta, tb = r.trajectory, p.trajectory
        if ta.stopped != tb.stopped or len(ta.records) != len(tb.records):
            return False
        for x, y in zip(ta.records, tb.records):
            if (x.round, x.primal, x.gap, x.test_error) != \
                    (y.round, y.primal, y.gap, y.test_error):
                return False
        if not torch.equal(r.w, p.w):
            return False
        if (r.alpha is None) != (p.alpha is None) or (
                r.alpha is not None and not torch.equal(r.alpha, p.alpha)):
            return False
    return True


def close_runs(label, res, ref) -> None:
    """Phase 12's tolerances where bits differ: equal stop reasons and
    rounds, each eval's gap (else primal) within relative 1e-3."""
    for r, p in zip(res, ref):
        a, b = r.trajectory, p.trajectory
        check(a.stopped == b.stopped and [x.round for x in a.records]
              == [y.round for y in b.records],
              f"{label} {r.algorithm}: stops or eval rounds differ")
        for x, y in zip(a.records, b.records):
            got, want = (x.gap, y.gap) if y.gap is not None else \
                (x.primal, y.primal)
            check(abs(got - want) <= 1e-3 * abs(want),
                  f"{label} {r.algorithm} round {x.round}: {got} vs {want}")


def captured_vs_eager(label, run, want):
    """(b, c) ``run(capture) -> [RunResult]`` eager, captured, captured,
    eager, every kernel's count set to 0 before each and read after: the
    captured runs launch ``want`` (and the eager ones the same); the two
    eager runs equal bit for bit, the two captured runs equal bit for bit,
    and the captured run equal to the eager run bit for bit.  Returns a
    summary dict."""
    runs = {}
    for tag, capture in (("eager", False), ("captured", True),
                         ("captured2", True), ("eager2", False)):
        reset_counts()
        prng.draw_tables.launches = 0
        res = run(capture)
        torch.cuda.synchronize()
        got = counts()
        check(got == want, f"{label} {tag}: launches {got}, want {want}")
        runs[tag] = (res, prng.draw_tables.launches)
    eager, captured = runs["eager"][0], runs["captured"][0]
    check(same_bits(eager, runs["eager2"][0]),
          f"{label}: two eager runs differ")
    check(same_bits(captured, runs["captured2"][0]),
          f"{label}: two captured runs differ")
    check(same_bits(captured, eager),
          f"{label}: the captured run differs from the eager run")
    out = {"eager_ms": [steady_ms(r.trajectory) for tag in ("eager", "eager2")
                        for r in runs[tag][0]],
           "captured_ms": [steady_ms(r.trajectory)
                           for tag in ("captured", "captured2")
                           for r in runs[tag][0]],
           "capture_s": {f"{r.algorithm} {key}": sec for r in captured
                         for key, sec in r.trajectory.graphs.items()},
           "draws": runs["captured"][1]}
    n = len(captured)
    print(f"phase 13: (b) {label}: eager == eager, captured == captured, "
          f"captured == eager, bit for bit"
          f"; launches {dict((k, v) for k, v in want.items() if v)}, draw "
          f"kernel {out['draws']}; (c) steady ms per round (evals "
          f"included), eager/captured by run in turns: "
          + ", ".join(f"{captured[i].algorithm} "
                      f"{out['eager_ms'][i]:.3f},{out['eager_ms'][n + i]:.3f}"
                      f" / {out['captured_ms'][i]:.3f},"
                      f"{out['captured_ms'][n + i]:.3f}" for i in range(n))
          + "; capture s: " + ", ".join(f"{key} {sec:.3f}" for key, sec in
                                         out["capture_s"].items()))
    return out


def sdca_run(fn, *args, **kw):
    def run(capture):
        w, alpha, traj = fn(*args, capture=capture, **kw)
        return [cli.RunResult(traj.algorithm, w, alpha, traj)]
    return run


def phase_captured(rcv1, rcv1_w, eps, lasso):
    """(b, c) Each path captured and eager on the same draws
    (:func:`captured_vs_eager`): rcv1-like sequential (B1), hybrid (B1h)
    and block (B5, B3, B6), epsilon-like sequential (B2) and fused B=128
    (B4), the lasso design (B2 prox), and the demo's menu through the CLI
    (B1; SGD, DistGD and mini-batch CD).  Returns {path: summary}."""
    f32 = torch.float32
    k, h = 8, rcv1.n // 8 // 10
    rounds = 100
    debug = DebugParams(debug_iter=25, seed=0)
    params = Params(n=rcv1.n, num_rounds=rounds, local_iters=h, lam=1e-4)
    fast = dict(plus=True, math="fast", quiet=True)
    out = {}
    ds = shard_dataset(rcv1, k, layout="sparse", dtype=f32, device="cuda")
    nb = -(-h // BLOCK) * rounds
    out["rcv1-like sequential"] = captured_vs_eager(
        "rcv1-like sequential", sdca_run(cocoa_mod.run_cocoa, ds, params,
                                         debug, **fast), only("B1", rounds))
    want = {name: 0 for name in KERNELS}
    want.update(B3=nb, B5=nb, B6=nb)
    out["rcv1-like block"] = captured_vs_eager(
        "rcv1-like block B=128", sdca_run(cocoa_mod.run_cocoa, ds, params,
                                          debug, block_size=BLOCK, **fast),
        want)
    del ds
    hyb = shard_dataset(rcv1, k, layout="sparse", dtype=f32, device="cuda",
                        hot_cols=rcv1_w)
    out["rcv1-like hybrid"] = captured_vs_eager(
        "rcv1-like hybrid sequential", sdca_run(
            cocoa_mod.run_cocoa, hyb, params, debug, **fast),
        only("B1h", rounds))
    del hyb
    n, d, ke = EPS_SHAPE
    eps_rounds = 30
    eps_params = Params(n=n, num_rounds=eps_rounds, local_iters=n // ke // 10,
                        lam=1e-3)
    eps_debug = DebugParams(debug_iter=10, seed=0)
    out["epsilon-like sequential"] = captured_vs_eager(
        "epsilon-like sequential", sdca_run(
            cocoa_mod.run_cocoa, eps, eps_params, eps_debug, **fast),
        only("B2", eps_rounds))
    nbe = -(-eps_params.local_iters // BLOCK) * eps_rounds
    out["epsilon-like fused"] = captured_vs_eager(
        "epsilon-like fused B=128", sdca_run(
            cocoa_mod.run_cocoa, eps, eps_params, eps_debug,
            block_size=BLOCK, **fast), only("B4", nbe))
    lds, lb, lam_max = lasso
    lasso_rounds = 100
    lparams = Params(n=lds.n, num_rounds=lasso_rounds,
                     local_iters=lds.n // lds.k // 10, lam=0.3 * lam_max,
                     loss="lasso", smoothing=0.0)

    def lasso_run(capture):
        x, r, traj = run_prox_cocoa(lds, lb, lparams,
                                    DebugParams(debug_iter=50, seed=0),
                                    quiet=True, math="fast", capture=capture)
        return [cli.RunResult(traj.algorithm, r, x, traj)]

    out["lasso design"] = captured_vs_eager(
        "lasso design sequential", lasso_run, only("B2", lasso_rounds))
    menu_rounds = 50
    argv = [f"--trainFile={DEMO_TRAIN}", f"--testFile={DEMO_TEST}",
            "--numFeatures=9947", "--numSplits=4",
            f"--numRounds={menu_rounds}", "--localIterFrac=0.1",
            "--lambda=.001", "--math=fast", "--dtype=float32",
            "--justCoCoA=false", "--layout=sparse"]
    out["demo menu"] = captured_vs_eager(
        "demo --justCoCoA=false (CoCoA+, CoCoA, mini-batch CD, SGD x2, "
        "DistGD)", lambda capture: run_cli(argv, capture=capture)[1],
        only("B1", 3 * menu_rounds))
    return out


def phase_retime(rcv1, demo_argv):
    """(d) Phase 12's time-to-gap runs again, in turns: rcv1-like permuted
    draws with sigma' auto to a 1e-4 gap as before (eager chunks, host
    tables), captured with host tables, and captured with device tables;
    the demo to 1e-4 (accel auto) eager with host tables and captured
    with device tables.  Returns {case: [(rounds, seconds)]}."""
    k, h = 8, rcv1.n // 8 // 10
    ds = shard_dataset(rcv1, k, layout="sparse", dtype=torch.float32,
                       device="cuda")
    params = Params(n=rcv1.n, num_rounds=1600, local_iters=h, lam=1e-4,
                    sigma="auto")
    debug = DebugParams(debug_iter=25, seed=0)
    settings = {"eager, host tables": dict(capture=False, sampling="host"),
                "captured, host tables": dict(sampling="host"),
                "captured, device tables": dict(sampling="device")}
    out = {}
    for label in (*settings, *reversed(settings)):
        w, alpha, traj = cocoa_mod.run_cocoa(
            ds, params, debug, plus=True, quiet=True, math="fast",
            gap_target=GAP_TARGET, rng="permuted", **settings[label])
        check(traj.stopped == "target", f"(d) {label}: {traj.stopped}")
        last = traj.records[-1]
        out.setdefault(f"rcv1-like permuted sigma' auto, {label}", []) \
            .append((last.round, last.wall_time))
    del ds
    demo = demo_argv + ["--numRounds=500", f"--gapTarget={GAP_TARGET}"]
    for label, extra, capture in (
            ("eager, host tables", ["--sampling=host"], False),
            ("captured, device tables", [], None),
            ("captured, device tables", [], None),
            ("eager, host tables", ["--sampling=host"], False)):
        _, res = run_cli(demo + extra, capture=capture)
        out.setdefault(f"demo to 1e-4 accel auto, {label}", []).append(
            tuple((r.trajectory.records[-1].round,
                   r.trajectory.records[-1].wall_time) for r in res))
    for case, runs in out.items():
        print(f"phase 13: (d) {case}: " + "; ".join(str(r) for r in runs)
              + " (stop round, seconds)")
    stops = {runs[0][0] for case, runs in out.items()
             if case.startswith("rcv1")}
    check(len(stops) == 1, f"(d) rcv1-like stop rounds differ: {stops}")
    return out


def phase_busy(rcv1, rcv1_w):
    """(e) Busy shares by profile_round.py's method: rcv1-like CoCoA+,
    sequential, block and hybrid, captured and eager, 100 rounds each."""
    import profile_round

    out = {}
    sets = {"unsplit": 0, "hybrid": rcv1_w}
    for layout, hot in sets.items():
        ds = shard_dataset(rcv1, 8, layout="sparse", dtype=torch.float32,
                           device="cuda", hot_cols=hot)
        for block in ((0, BLOCK) if not hot else (0,)):
            for capture in (True, False):
                label = (f"{layout} {'block' if block else 'sequential'} "
                         f"{'captured' if capture else 'eager'}")
                print(f"phase 13: (e) {label}:")
                out[label] = profile_round.profile_config(
                    ds, block, 100, capture=capture)
        del ds
    return out


# --- phase 14: the device-resident run (--deviceLoop)


def transitions(traj) -> int:
    """The changes of sigma' between consecutive evals of a run."""
    sig = [r.sigma for r in traj.records]
    return sum(a != b for a, b in zip(sig, sig[1:]))


def loop_turns(label, run):
    """``run(device_loop) -> [RunResult]`` chunked (each chunk a captured
    CUDA graph), device loop, device loop, chunked, every kernel's count
    set to 0 just before each run and read just after.  Each device-loop
    run launches what the chunked run launches (its live chunks; the draw
    kernel too), stops where it stops with the same ``stopped``, equals it
    bit for bit where the two chunked runs agree bit for bit, else within
    relative 1e-3 with equal rounds, and reads the card once, plus once a
    change of sigma'.  Returns a summary: per run, (stop round, seconds,
    ms per round, fetches, capture seconds, dead chunks), and the device
    runs' launches."""
    runs = {}
    for tag, loop in (("chunked", False), ("device", True),
                      ("device2", True), ("chunked2", False)):
        reset_counts()
        prng.draw_tables.launches = 0
        t0 = time.perf_counter()
        res = run(loop)
        torch.cuda.synchronize()
        runs[tag] = (res, counts(), prng.draw_tables.launches,
                     time.perf_counter() - t0)
    chunked, device = runs["chunked"][0], runs["device"][0]
    for tag in ("device", "device2"):
        check(runs[tag][1:3] == runs["chunked"][1:3],
              f"{label} {tag}: launches {runs[tag][1:3]}, the chunked run "
              f"{runs['chunked'][1:3]}")
    stable = same_bits(chunked, runs["chunked2"][0])
    check(same_bits(device, runs["device2"][0]) or not stable,
          f"{label}: two device-loop runs differ where two chunked runs "
          f"agree")
    if stable:
        check(same_bits(device, chunked), f"{label}: the device loop differs "
                                          f"from the chunked run, which is "
                                          f"bit-stable")
    else:
        close_runs(label, device, chunked)
    for r in device:
        tr = r.trajectory
        check(tr.fetches == 1 + transitions(tr),
              f"{label} {r.algorithm}: {tr.fetches} fetches for one "
              f"super-block and {transitions(tr)} changes of sigma'")
        check(all(rec.wall_time is None for rec in tr.records[:-1])
              and tr.records[-1].wall_time is not None,
              f"{label} {r.algorithm}: wall times inside the super-block")
    out = {"stable": stable, "launches": runs["device"][1],
           "draws": runs["device"][2], "runs": {}}
    for tag in ("chunked", "device", "device2", "chunked2"):
        for r in runs[tag][0]:
            tr, last = r.trajectory, r.trajectory.records[-1]
            out["runs"].setdefault(f"{r.algorithm} {tag[:7]}", []).append(
                (last.round, last.wall_time,
                 last.wall_time / last.round * 1e3, tr.fetches,
                 sum(tr.graphs.values()), tr.dead_chunks))
    held = "bit for bit" if stable else \
        "within rel 1e-3 (the chunked runs differ in their bits)"
    print(f"phase 14: {label}: device loop == chunked {held}; launches "
          f"{dict((k, v) for k, v in out['launches'].items() if v)}, draw "
          f"kernel {out['draws']}; by run in turns (chunked, device, "
          f"device, chunked): stop round, s to it, ms per round, fetches, "
          f"capture s, dead chunks:")
    for name, rows in out["runs"].items():
        print(f"  {name}: " + "; ".join(
            f"{rd} {s:.4f} {ms:.4f} {f} {c:.3f} {dd}"
            for rd, s, ms, f, c, dd in rows))
    return out


def phase_device_loop(rcv1, rcv1_w, eps, lasso, card):
    """The device-resident run against the chunked one (:func:`loop_turns`),
    float32, --math=fast: (a) rcv1-like sigma' auto to a 1e-4 gap, permuted
    draws (B1); (b) the safe sigma' with accel auto and off; (c) the
    block path, sigma' auto (B5, B3, B6); (d) the lasso design, lasso and
    elastic net, to 1e-3 |b|^2/2 (B2 prox); (e) epsilon-like fused B=128
    (B4) and sequential (B2), 30 rounds; (f) the demo's menu through the
    CLI with --deviceLoop --justCoCoA=false; (g) the coherent shards'
    bail-out (B2); (h) rcv1-like hybrid, 100 rounds (B1h).  Then busy
    shares by profile_round.py's method.  Returns a summary."""
    import probe_conditional
    import profile_round

    ver = probe_conditional.versions()
    print(f"phase 14: torch {ver['torch']}, CUDA runtime "
          f"{ver['cuda_runtime']}, driver {ver['driver']}: CUDA graph "
          f"conditional nodes {'present' if ver['api'] else 'absent'} in "
          f"torch; the device loop takes design B (solvers/base.py "
          f"DeviceLoopRunner)")
    out = {"versions": ver}
    k, h = 8, rcv1.n // 8 // 10
    ds = shard_dataset(rcv1, k, layout="sparse", dtype=torch.float32,
                       device="cuda")
    debug = DebugParams(debug_iter=25, seed=0)
    fast = dict(plus=True, quiet=True, math="fast", gap_target=GAP_TARGET,
                rng="permuted")

    def rcv1_run(sigma, **kw):
        params = Params(n=rcv1.n, num_rounds=1600, local_iters=h, lam=1e-4,
                        sigma=sigma)
        return sdca_loop(cocoa_mod.run_cocoa, ds, params, debug, **fast,
                         **kw)

    out["(a)"] = loop_turns("(a) rcv1-like sigma' auto to 1e-4 (B1)",
                            rcv1_run("auto"))
    out["(b) accel auto"] = loop_turns(
        "(b) rcv1-like safe sigma' accel auto to 1e-4",
        rcv1_run(None, accel="auto"))
    out["(b) accel off"] = loop_turns(
        "(b) rcv1-like safe sigma' accel off to 1e-4",
        rcv1_run(None, accel="off"))
    out["(c)"] = loop_turns(
        f"(c) rcv1-like --blockSize={BLOCK} sigma' auto to 1e-4 (B5, B3, "
        f"B6)", rcv1_run("auto", block_size=BLOCK))
    lds, lb, lam_max = lasso
    target = 1e-3 * 0.5 * float(lb @ lb)
    for tag, l2 in (("lasso", 0.0), ("elastic net", 0.1)):
        params = Params(n=lds.n, num_rounds=LASSO_ROUNDS,
                        local_iters=lds.n // lds.k // 10, lam=0.3 * lam_max,
                        loss="lasso", smoothing=l2)

        def lasso_run(loop, params=params):
            x, r, traj = run_prox_cocoa(
                lds, lb, params, DebugParams(debug_iter=50, seed=0),
                quiet=True, math="fast", gap_target=target, device_loop=loop)
            return [cli.RunResult(traj.algorithm, r, x, traj)]

        out[f"(d) {tag}"] = loop_turns(
            f"(d) lasso design {tag} to {target:.6g} (B2 prox)", lasso_run)
    n, _, ke = EPS_SHAPE
    eps_params = Params(n=n, num_rounds=30, local_iters=n // ke // 10,
                        lam=1e-3)
    eps_debug = DebugParams(debug_iter=10, seed=0)
    for tag, b in (("fused B=128 (B4)", BLOCK), ("sequential (B2)", 0)):
        out[f"(e) {tag}"] = loop_turns(
            f"(e) epsilon-like {tag}, 30 rounds", sdca_loop(
                cocoa_mod.run_cocoa, eps, eps_params, eps_debug, plus=True,
                quiet=True, math="fast", block_size=b))
    argv = [f"--trainFile={DEMO_TRAIN}", f"--testFile={DEMO_TEST}",
            "--numFeatures=9947", "--numSplits=4", "--numRounds=50",
            "--localIterFrac=0.1", "--lambda=.001", "--math=fast",
            "--dtype=float32", "--justCoCoA=false", "--layout=sparse"]
    out["(f)"] = loop_turns(
        "(f) demo --justCoCoA=false (CoCoA+, CoCoA, mini-batch CD, SGD x2, "
        "DistGD)", lambda loop: run_cli(
            argv + (["--deviceLoop"] if loop else []))[1])
    coh, nc = coherent_shards()
    out["(g)"] = loop_turns(
        f"(g) coherent shards sigma'=1 (seed {COHERENT_SEED}, B2)",
        sdca_loop(cocoa_mod.run_cocoa, coh, Params(
            n=nc, num_rounds=1600, local_iters=16, lam=1e-4, sigma=1.0),
                  debug, plus=True, quiet=True, math="fast",
                  gap_target=1e-3, rng="jax"))
    for name, want in (("(a)", "target"), ("(g)", "diverged")):
        rec = out[name]["runs"]["CoCoA+ device"][0]
        print(f"  {name} stops ({want}) at round {rec[0]}")
    hyb = shard_dataset(rcv1, k, layout="sparse", dtype=torch.float32,
                        device="cuda", hot_cols=rcv1_w)
    out["(h)"] = loop_turns(
        "(h) rcv1-like hybrid, 100 rounds (B1h)", sdca_loop(
            cocoa_mod.run_cocoa, hyb, Params(n=rcv1.n, num_rounds=100,
                                             local_iters=h, lam=1e-4),
            debug, plus=True, quiet=True, math="fast"))
    del hyb
    busy = {}
    for block in (0, BLOCK):
        name = "block" if block else "sequential"
        print(f"phase 14: busy, rcv1-like {name}, chunked (captured):")
        busy[f"{name} chunked"] = profile_round.profile_config(ds, block,
                                                               100)
        print(f"phase 14: busy, rcv1-like {name}, device loop:")
        busy[f"{name} device loop"] = profile_round.profile_device_loop(
            ds, block, 100)
    out["busy"] = busy
    del ds
    launched = {}
    for case in out.values():
        if isinstance(case, dict) and "launches" in case:
            for name, v in case["launches"].items():
                launched[name] = launched.get(name, 0) + v
    launched["D"] = sum(c["draws"] for c in out.values()
                        if isinstance(c, dict) and "draws" in c)
    for name, v in launched.items():
        check(v > 0, f"phase 14: {name} never launched from a device-loop run")
    out["launched"] = launched
    print(f"phase 14: device-loop launches " + ", ".join(
        f"{name} {v}" for name, v in launched.items()) + f"; card {card}")
    return out


def sdca_loop(fn, *args, **kw):
    def run(loop):
        w, alpha, traj = fn(*args, device_loop=loop, **kw)
        return [cli.RunResult(traj.algorithm, w, alpha, traj)]
    return run


# --- phase 15: checkpoints and --resume --------------------------------------

RESUME_AT = 300      # the rcv1-like and lasso cases' mid-run checkpoint
KILL_ROUNDS = 10000  # the killed demo run's budget (CoCoA+ ~0.08 ms a round)
KILL_CHKPT = 1000


class Counted:
    """Phase 15's launches: every kernel's count (and the draw kernel's)
    set to 0 just before each in-process run and read just after, summed
    over the phase (``total``) and over its resumed runs alone
    (``resumed``)."""

    def __init__(self):
        self.total = dict.fromkeys([*KERNELS, "D"], 0)
        self.resumed = dict.fromkeys(self.total, 0)
        self.last = dict.fromkeys(self.total, 0)

    def __call__(self, fn, *args, **kw):
        reset_counts()
        prng.draw_tables.launches = 0
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        self.last = {**counts(), "D": prng.draw_tables.launches}
        for name, n in self.last.items():
            self.total[name] += n
        return out

    def resume(self, label, kernels, fn, *args, **kw):
        """A resumed run (``restore_from`` in ``kw``): its own launches
        are read apart, and each of ``kernels`` must have launched in
        it."""
        out = self(fn, *args, **kw)
        for name, n in self.last.items():
            self.resumed[name] += n
        for name in kernels:
            check(self.last[name] > 0,
                  f"phase 15: {label}: {name} never launched from the "
                  f"resumed run")
        return out


def restore_kw(directory, algorithm, prox=False):
    """The keywords the CLI's ``--resume`` passes (cli.py ``_restore``:
    ``latest``, then ``load_full``), its line kept off the console;
    ProxCoCoA+'s as (r_init, x_init)."""
    with contextlib.redirect_stdout(io.StringIO()):
        kw = cli._restore(RunConfig(chkpt_dir=directory), algorithm, True)
    check(bool(kw), f"no checkpoint of {algorithm} in {directory}")
    if prox:
        kw = dict(r_init=kw["w_init"], x_init=kw["alpha_init"],
                  start_round=kw["start_round"])
    return kw


def after(results, m):
    """Runs cut to their records past round ``m`` (views for
    :func:`same_bits` and :func:`close_runs`)."""
    out = []
    for r in results:
        traj = Trajectory(r.algorithm, quiet=True)
        traj.records = [x for x in r.trajectory.records if x.round > m]
        traj.stopped = r.trajectory.stopped
        out.append(cli.RunResult(r.algorithm, r.w, r.alpha, traj))
    return out


def hold_resumed(label, res, full, m) -> None:
    """Resumed runs against the uninterrupted ones past round ``m``, one
    algorithm at a time, bit for bit: every algorithm's uninterrupted run
    is bit-stable (DistGD's sparse pass adds in slot order,
    ops/subgradient.py), so a resume that differs fails."""
    res, cut = after(res, m), after(full, m)
    for r, f in zip(res, cut):
        check(same_bits([r], [f]),
              f"{label} {f.algorithm}: the resume differs from the "
              f"uninterrupted run")


def resume_case(label, run, m, counted, kernels, loops=(False, True)):
    """Phase 15 (a) for one configuration: ``run(loop, rounds, save_to,
    restore_from) -> [RunResult]`` uninterrupted, then to round ``m``
    saving there, then resumed from that checkpoint (``latest`` and
    ``load_full``, as ``--resume``), on each loop; the resumed run must
    launch each of ``kernels`` (:meth:`Counted.resume`) and equal the
    uninterrupted run bit for bit (:func:`hold_resumed`).  Returns, per
    loop, the resumed run's seconds."""
    out = {}
    for loop in loops:
        tag = "device loop" if loop else "chunked"
        with tempfile.TemporaryDirectory(dir=OUT) as d:
            full = counted(run, loop, None)
            half = counted(run, loop, m, save_to=d)
            for r in half:
                check(r.trajectory.saves >= 1,
                      f"{label} {tag} {r.algorithm}: no checkpoint saved")
                path = checkpoint.latest(d, r.algorithm)
                check(path is not None and path.endswith(f"-r{m:06d}.npz"),
                      f"{label} {tag} {r.algorithm}: latest is {path}")
            t0 = time.perf_counter()
            res = counted.resume(f"{label} {tag}", kernels, run, loop,
                                 None, restore_from=d)
            sec = time.perf_counter() - t0
        hold_resumed(f"{label} {tag}", res, full, m)
        out[tag] = sec
    print(f"phase 15 (a): {label}: resumed at round {m + 1} == "
          f"uninterrupted, " + "; ".join(
              f"{tag} bit for bit ({sec:.3f} s resumed)"
              for tag, sec in out.items()))
    return out


def rcv1_resume_run(ds, rcv1, h, sigma, **kw):
    """rcv1-like CoCoA+ to the 1e-4 gap (phase 14 (a)-(c)'s runs), with a
    checkpoint budget."""
    def run(loop, rounds, save_to=None, restore_from=None, chkpt_iter=None):
        n_rounds = rounds or 1600
        debug = DebugParams(debug_iter=25, seed=0,
                            chkpt_iter=chkpt_iter or n_rounds,
                            chkpt_dir=save_to or "")
        extra = restore_kw(restore_from, "CoCoA+") if restore_from else {}
        w, alpha, traj = cocoa_mod.run_cocoa(
            ds, Params(n=rcv1.n, num_rounds=n_rounds, local_iters=h,
                       lam=1e-4, sigma=sigma), debug, plus=True, quiet=True,
            math="fast", gap_target=kw.get("gap", GAP_TARGET),
            rng="permuted", device_loop=loop, **{
                k: v for k, v in kw.items() if k != "gap"}, **extra)
        return [cli.RunResult(traj.algorithm, w, alpha, traj)]
    return run


def phase_resume(rcv1, rcv1_w, lasso, card):
    """Phase 15: checkpoints and --resume on the card's kernels, float32,
    --math=fast.  (a) each configuration uninterrupted, to a mid-run
    checkpoint and resumed from it (:func:`resume_case`): rcv1-like sigma'
    auto (the anneal: a mid-schedule sched vector), the safe sigma' with
    accel auto (a mid-momentum bank), the block path (B5, B3, B6) and
    the hybrid (B1h); the lasso design sequentially (B2) and fused B=128
    (B4); the demo's menu through the CLI; then a device-loop resume that
    saves at a stop mid-super-block, where a dead chunk replays; (b) the
    demo through ``python -m cocoa_torch.cli``, chunked and
    --deviceLoop, SIGKILLed after its first checkpoint and relaunched
    with --resume; (c) a torn newest generation; (d) seconds a save and
    seconds to the gap with and without checkpoints.  Returns a
    summary."""
    counted = Counted()
    out = {"card": card, "(a)": {}}
    k, h = 8, rcv1.n // 8 // 10
    ds = shard_dataset(rcv1, k, layout="sparse", dtype=torch.float32,
                       device="cuda")
    t0 = time.perf_counter()
    cases = {
        "rcv1-like sigma' auto (B1, anneal)":
            (rcv1_resume_run(ds, rcv1, h, "auto"), RESUME_AT, ("B1",)),
        "rcv1-like accel auto (B1, accel)":
            (rcv1_resume_run(ds, rcv1, h, None, accel="auto"), RESUME_AT,
             ("B1",)),
        "rcv1-like block (B5, B3, B6)":
            (rcv1_resume_run(ds, rcv1, h, "auto", block_size=BLOCK),
             RESUME_AT, ("B5", "B3", "B6"))}
    for label, (run, m, kernels) in cases.items():
        out["(a)"][label] = resume_case(label, run, m, counted, kernels)
    hyb = shard_dataset(rcv1, k, layout="sparse", dtype=torch.float32,
                        device="cuda", hot_cols=rcv1_w)

    def hybrid_run(loop, rounds, save_to=None, restore_from=None):
        extra = restore_kw(restore_from, "CoCoA+") if restore_from else {}
        n_rounds = rounds or 100
        w, alpha, traj = cocoa_mod.run_cocoa(
            hyb, Params(n=rcv1.n, num_rounds=n_rounds, local_iters=h,
                        lam=1e-4),
            DebugParams(debug_iter=25, seed=0, chkpt_iter=n_rounds,
                        chkpt_dir=save_to or ""), plus=True, quiet=True,
            math="fast", device_loop=loop, **extra)
        return [cli.RunResult(traj.algorithm, w, alpha, traj)]

    out["(a)"]["rcv1-like hybrid (B1h)"] = resume_case(
        "rcv1-like hybrid, 100 rounds (B1h)", hybrid_run, 50, counted,
        ("B1h",))
    del hyb
    lds, lb, lam_max = lasso
    target = 1e-3 * 0.5 * float(lb @ lb)
    for name, block, kernel in (("sequential (B2)", 0, "B2"),
                                (f"fused B={BLOCK} (B4)", BLOCK, "B4")):
        def lasso_run(loop, rounds, save_to=None, restore_from=None,
                      block=block):
            extra = restore_kw(restore_from, "ProxCoCoA+", prox=True) \
                if restore_from else {}
            n_rounds = rounds or LASSO_ROUNDS
            x, r, traj = run_prox_cocoa(
                lds, lb, Params(n=lds.n, num_rounds=n_rounds,
                                local_iters=lds.n // lds.k // 10,
                                lam=0.3 * lam_max, loss="lasso",
                                smoothing=0.0),
                DebugParams(debug_iter=50, seed=0, chkpt_iter=n_rounds,
                            chkpt_dir=save_to or ""), quiet=True,
                math="fast", gap_target=target, device_loop=loop,
                block_size=block, **extra)
            return [cli.RunResult(traj.algorithm, r, x, traj)]

        out["(a)"][f"lasso design {name}"] = resume_case(
            f"lasso design {name} to {target:.6g}", lasso_run, RESUME_AT,
            counted, (kernel,))
    menu_argv = [f"--trainFile={DEMO_TRAIN}", f"--testFile={DEMO_TEST}",
                 "--numFeatures=9947", "--numSplits=4",
                 "--localIterFrac=0.1", "--lambda=.001", "--math=fast",
                 "--dtype=float32", "--justCoCoA=false", "--layout=sparse"]

    def menu_run(loop, rounds, save_to=None, restore_from=None):
        argv = menu_argv + [f"--numRounds={rounds or 100}"] + (
            ["--deviceLoop"] if loop else [])
        if save_to:
            argv += [f"--chkptDir={save_to}", f"--chkptIter={rounds}"]
        if restore_from:
            argv += [f"--chkptDir={restore_from}", "--chkptIter=1000",
                     "--resume"]
        text, res = run_cli(argv)
        check(not restore_from or text.count("resuming ") == len(MENU),
              "the demo menu: not every algorithm resumed")
        return res

    out["(a)"]["demo menu"] = resume_case(
        "demo --justCoCoA=false (CoCoA+, CoCoA, mini-batch CD, SGD x2, "
        "DistGD), 100 rounds", menu_run, 50, counted, ("B1",))
    out["(a)"]["dead chunk"] = phase_dead_chunk(cases["rcv1-like sigma' "
                                                      "auto (B1, anneal)"][0],
                                                counted)
    print(f"phase 15 (a): all cases in {time.perf_counter() - t0:.1f} s")
    out["(b)"] = phase_kill_resume()
    out["(c)"] = phase_torn(cases["rcv1-like sigma' auto (B1, anneal)"][0],
                            counted)
    out["(d)"] = phase_resume_costs(ds, lasso, cases, counted, card)
    del ds
    out["launched"] = counted.total
    out["launched_resumed"] = counted.resumed
    check(counted.resumed["D"] > 0,
          "phase 15: D never launched from a resumed run")
    print("phase 15: launches of its in-process runs " + ", ".join(
        f"{name} {v}" for name, v in counted.total.items())
          + "; of its resumed runs alone " + ", ".join(
        f"{name} {v}" for name, v in counted.resumed.items())
          + f"; card {card}")
    return out


def phase_dead_chunk(run, counted):
    """(a) on design B: the chunked run stops at S (575), and its state
    saved at S - 45 (530) resumes on the device loop with chkptIter=40
    (super-blocks of 2 chunks of 25): the head runs to S - 25, and the
    block from S - 24 stops at S after one chunk, 45 >= 40 rounds past
    the restored round, so it saves at S while the block's second chunk
    replays dead.  The checkpoint holds the round and state the run
    returns, bit for bit."""
    with tempfile.TemporaryDirectory(dir=OUT) as d, \
            tempfile.TemporaryDirectory(dir=OUT) as d2:
        full = counted(run, False, None)
        stop = full[0].trajectory.records[-1].round
        counted(run, False, stop - 45, save_to=d)
        (res,) = counted.resume("dead chunk", ("B1",), run, True, None,
                                save_to=d2, restore_from=d, chkpt_iter=40)
        meta, arrays = checkpoint.load_full(checkpoint.latest(d2, "CoCoA+"))
    tr = res.trajectory
    check(meta["round"] == tr.records[-1].round,
          f"dead chunk: checkpoint round {meta['round']}, the run stopped "
          f"at {tr.records[-1].round}")
    check(np.array_equal(arrays["w"], res.w.cpu().numpy())
          and np.array_equal(arrays["alpha"], res.alpha.cpu().numpy()),
          "dead chunk: the checkpoint is not the state the run returned")
    print(f"phase 15 (a): device loop resumed at {stop - 44} with "
          f"chkptIter=40: "
          f"stops at {tr.records[-1].round} (uninterrupted: {stop}), saves "
          f"at round {meta['round']} after {tr.dead_chunks} dead chunk(s), "
          f"the checkpoint equal to the returned state bit for bit")
    return {"stop": tr.records[-1].round, "saved": meta["round"],
            "dead_chunks": tr.dead_chunks}


def kill_argv(loop, directory):
    return [sys.executable, "-m", "cocoa_torch.cli",
            f"--trainFile={DEMO_TRAIN}", "--numFeatures=9947",
            "--numSplits=4", f"--numRounds={KILL_ROUNDS}",
            "--localIterFrac=0.1", "--lambda=.001", "--math=fast",
            "--dtype=float32", "--debugIter=100",
            f"--chkptIter={KILL_CHKPT}", f"--chkptDir={directory}"] + (
        ["--deviceLoop"] if loop else [])


def summary_lines(text):
    return [ln.strip() for ln in text.splitlines()
            if "Total Objective" in ln or "Duality Gap" in ln]


def phase_kill_resume():
    """(b) tests/test_crash_resume.py on the card: the demo through
    ``python -m cocoa_torch.cli`` (CoCoA+ and CoCoA, 10000 rounds,
    chkptIter 1000), chunked and --deviceLoop side by side, each
    SIGKILLed once its first checkpoint exists, then both relaunched
    with --resume; each resumed summary equals the uninterrupted run's
    (in process, the same flags) bit for bit."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        dirs = {loop: os.path.join(tmp, f"ck{int(loop)}")
                for loop in (False, True)}
        procs = {}
        for loop, d in dirs.items():
            os.makedirs(d)
            log = open(os.path.join(tmp, f"killed{int(loop)}.log"), "w")
            procs[loop] = (subprocess.Popen(kill_argv(loop, d), cwd=ROOT,
                                            env=env, stdout=log,
                                            stderr=subprocess.STDOUT), log)
        killed_at = {}
        try:
            deadline = time.time() + 240
            while len(killed_at) < len(procs) and time.time() < deadline:
                for loop, (proc, _) in procs.items():
                    if loop in killed_at:
                        continue
                    if any(f.endswith(".npz") for f in os.listdir(dirs[loop])):
                        proc.send_signal(signal.SIGKILL)
                        proc.wait(timeout=30)
                        killed_at[loop] = time.perf_counter() - t0
                    else:
                        check(proc.poll() is None,
                              f"kill: the run finished before a checkpoint "
                              f"(loop={loop})")
                time.sleep(0.002)
        finally:
            for proc, log in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        check(len(killed_at) == len(procs), "kill: no checkpoint in 240 s")
        resumed = {loop: subprocess.Popen(
            kill_argv(loop, d) + ["--resume"], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for loop, d in dirs.items()}
        texts = {}
        for loop, proc in resumed.items():
            o, e = proc.communicate(timeout=300)
            check(proc.returncode == 0,
                  f"resume exited {proc.returncode}: {e[-2000:]}")
            texts[loop] = o
    out = {}
    for loop, text in texts.items():
        tag = "device loop" if loop else "chunked"
        (OUT / f"chip_smoke_resume_{tag.replace(' ', '_')}.log").write_text(
            text)
        lines = [ln for ln in text.splitlines() if ln.startswith("resuming")]
        check(len(lines) == 1 and lines[0].startswith("resuming CoCoA+ "),
              f"kill {tag}: resumed lines {lines}")
        r0 = int(lines[0].split("from round ")[1].split()[0])
        check(r0 < KILL_ROUNDS, f"kill {tag}: resumed at {r0}, the end")
        argv = [a for a in kill_argv(loop, "")[3:]
                if not a.startswith("--chkpt")]
        ref_text, _ = run_cli(argv)
        want = summary_lines(ref_text)
        got = summary_lines(text)
        check(got == want, f"kill {tag}: the resumed summary {got} differs "
                           f"from the uninterrupted {want}")
        out[tag] = {"killed_s": killed_at[loop], "resumed_from": r0,
                    "summary": got}
        print(f"phase 15 (b): {tag}: SIGKILLed {killed_at[loop]:.2f} s "
              f"after launch, resumed from round {r0} of {KILL_ROUNDS}; "
              f"summary equal to the uninterrupted run's: "
              + " | ".join(got))
    print(f"phase 15 (b): in {time.perf_counter() - t0:.1f} s")
    return out


def phase_torn(run, counted):
    """(c) tests/test_chaos.py:484 on the card: the rcv1-like run to round
    300 saved every 50 rounds (two generations kept: 250 and 300); the
    newest torn, ``latest`` falls back to 250 with its stderr line, and
    the run resumed from it ends bit for bit as the run that wrote them."""
    prev = RESUME_AT - 50
    with tempfile.TemporaryDirectory(dir=OUT) as d:
        (full,) = counted(run, False, RESUME_AT, save_to=d, chkpt_iter=50)
        gens = checkpoint.generations(d, "CoCoA+")
        check([os.path.basename(g) for g in gens] == [
            f"CoCoA+-r{prev:06d}.npz", f"CoCoA+-r{RESUME_AT:06d}.npz"],
            f"torn: generations {gens}")
        with open(gens[-1], "r+b") as f:
            f.truncate(100)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            path = checkpoint.latest(d, "CoCoA+")
        check(path == gens[0] and "falling back to the previous generation"
              in err.getvalue(), f"torn: latest gave {path}")
        res = counted.resume("torn", ("B1",), run, False, RESUME_AT,
                             restore_from=d)
    hold_resumed("torn", res, [full], prev)
    print(f"phase 15 (c): newest generation (r{RESUME_AT}) torn: latest "
          f"falls back to r{prev} (\"{err.getvalue().strip()[:90]}...\"), "
          f"the resume ends bit for bit as the run that wrote them")
    return {"exact": True}


def phase_resume_costs(ds, lasso, cases, counted, card):
    """(d) the seconds of one save (w, alpha, and the bank and sched vector
    where a run has them) at rcv1-like and lasso-design shapes, the
    median of 7; and seconds to the 1e-4 gap for rcv1-like sigma' auto
    with --chkptIter=100 and without, chunked and device loop, in turns
    (without, with, with, without)."""
    out = {}
    run = cases["rcv1-like sigma' auto (B1, anneal)"][0]
    (res,) = counted(cases["rcv1-like accel auto (B1, accel)"][0], False,
                     None)
    lds, lb, _ = lasso
    rng = torch.Generator(device="cuda").manual_seed(0)
    shapes = {
        "rcv1-like (w, alpha, hist, sched)": (
            res.w, res.alpha,
            torch.rand((2,) + tuple(res.alpha.shape), generator=rng,
                       device="cuda"),
            base.sched_init_array(1, accel=True)),
        "lasso design (r, x)": (
            torch.rand(lds.num_features, generator=rng, device="cuda"),
            torch.rand((lds.k, lds.n_shard), generator=rng, device="cuda"),
            None, None)}
    with tempfile.TemporaryDirectory(dir=OUT) as d:
        for name, (w, alpha, hist, sched) in shapes.items():
            secs = []
            for i in range(7):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                path = checkpoint.save(d, "timing", i + 1, w, alpha,
                                       sched=sched, hist=hist, gap=1.0)
                secs.append(time.perf_counter() - t0)
            n_bytes = os.path.getsize(path)
            out[name] = {"s": float(np.median(secs)), "bytes": n_bytes}
            print(f"phase 15 (d): one save, {name}: {np.median(secs):.5f} s "
                  f"(median of 7; min {min(secs):.5f}, max {max(secs):.5f}), "
                  f"{n_bytes} bytes; card {card}")
    with tempfile.TemporaryDirectory(dir=OUT) as d:
        turns = {}
        for loop in (False, True):
            for ck in (False, True, True, False):
                tag = (f"{'device loop' if loop else 'chunked'} "
                       f"{'chkptIter=100' if ck else 'no checkpoints'}")
                t0 = time.perf_counter()
                (r,) = counted(run, loop, None, save_to=d if ck else None,
                               chkpt_iter=100 if ck else None)
                turns.setdefault(tag, []).append(
                    (time.perf_counter() - t0, r.trajectory.records[-1].round,
                     r.trajectory.saves, r.trajectory.fetches))
        out["to 1e-4"] = turns
        for tag, rows in turns.items():
            print(f"phase 15 (d): rcv1-like sigma' auto to {GAP_TARGET:g}, "
                  f"{tag}: "
                  + "; ".join(f"{s:.4f} s to round {rd}, {sv} saves, "
                              f"{f} fetches" for s, rd, sv, f in rows)
                  + f"; card {card}")
    return out


# --- phase 16: the rest of the single-GPU training surface


PIPE_CASES = (("epsilon-like fused B=128", "eps", BLOCK, "B4"),
              ("epsilon-like split B=512", "eps", 4 * BLOCK, "B3"),
              ("lasso design fused B=128", "lasso", BLOCK, "B4"))
PIPE_ROUNDS = {"eps": 30, "lasso": 100}
# each case's kernel as the profiler names it, to find the device loop's
# replayed chunks (profile_round.replay_window)
PIPE_MAIN = {"B4": "fused_kernel", "B3": "chain_kernel"}


def graph_forks(fn):
    """``fn()`` run eagerly once, then captured as one CUDA graph (kept
    after instantiation) and replayed: (nodes of the graph with two or
    more successors in its DOT dump, i.e. where it forks into concurrent
    branches, or None where no dump could be read; edges; ``fn``'s output
    of the replay)."""
    import ctypes
    import re

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = fn()
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=OUT) as d:
        path = os.path.join(d, "graph.dot")
        # libcuda's DOT printer on the kept cudaGraph_t
        ctypes.CDLL("libcuda.so.1").cuGraphDebugDotPrint(
            ctypes.c_void_p(graph.raw_cuda_graph()), path.encode(),
            ctypes.c_uint(0))
        text = Path(path).read_text() if os.path.exists(path) else ""
    edges = re.findall(r'"?([\w.]+)"?\s*->\s*"?([\w.]+)"?', text)
    succ = {}
    for a, _ in edges:
        succ[a] = succ.get(a, 0) + 1
    forks = sum(1 for n in succ.values() if n > 1) if edges else None
    return forks, len(edges), out


def pipe_run(ds, b_vec, block, rounds, debug_iter):
    """``run(device_loop, pipeline) -> [RunResult]``: CoCoA+ in blocks of
    ``block`` on ``ds`` (ProxCoCoA+ with ``b_vec``), float32, on permuted
    draws (no row twice in a block, so the alpha scatter adds in one
    order and every run is bit-stable)."""
    def run(loop, pipeline):
        debug = DebugParams(debug_iter=debug_iter, seed=0)
        if b_vec is not None:
            params = Params(n=ds.n, num_rounds=rounds,
                            local_iters=ds.n // ds.k // 10, lam=b_vec[1],
                            loss="lasso", smoothing=0.0)
            x, r, traj = run_prox_cocoa(
                ds, b_vec[0], params, debug, quiet=True, math="fast",
                rng="permuted",
                block_size=block, block_pipeline=pipeline, device_loop=loop)
            return [cli.RunResult(traj.algorithm, r, x, traj)]
        params = Params(n=ds.n, num_rounds=rounds,
                        local_iters=ds.n // ds.k // 10, lam=1e-3)
        w, alpha, traj = cocoa_mod.run_cocoa(
            ds, params, debug, plus=True, quiet=True, math="fast",
            rng="permuted", block_size=block, block_pipeline=pipeline,
            device_loop=loop)
        return [cli.RunResult(traj.algorithm, w, alpha, traj)]
    return run


def turns(runs, key, fmt="{:.4f}"):
    """``runs``' values at ``key``, in their order, for one printed line."""
    return ", ".join(fmt.format(m[key]) for m in runs)


def phase_pipeline(eps, lasso, counted, card):
    """(a) ``--blockPipeline``: each of PIPE_CASES off, on, on, off on the
    captured chunked loop and on the device loop, every kernel's count set
    to 0 before each run and read after: the four runs of a loop equal
    bit for bit, trajectories and final (w, alpha), each launching the
    case's kernel as many times; ms per round past the first chunk and
    the capture, the chunked runs' on the host's clock between their
    first eval and their last, the device loop's under the profiler
    (kernels only) on the device's timeline (profile_round.replay_window),
    with the device's busy share there, the union of the kernels' spans;
    each run's whole ms per round, capture included, on the host's clock,
    and the time its captures took (``Trajectory.graphs``); and whether
    the captured round forks into concurrent branches (on) and does not
    (off)."""
    import profile_round
    from torch.profiler import ProfilerActivity, profile

    lds, lb, lam_max = lasso
    sets = {"eps": (eps, None), "lasso": (lds, (lb, 0.3 * lam_max))}
    out = {}
    for label, key, block, kern in PIPE_CASES:
        t_case = time.perf_counter()
        ds, b_vec = sets[key]
        rounds = PIPE_ROUNDS[key]
        run = pipe_run(ds, b_vec, block, rounds, 10 if key == "eps" else 25)
        nb = -(-(ds.n // ds.k // 10) // block)
        check(nb > 1, f"{label}: one block a round, nothing to pipeline")
        case = {}
        for loop in (False, True):
            tag = "device loop" if loop else "chunked"
            runs = []
            for flag in (False, True, True, False):
                # the profiler's host work would slow the chunked loop,
                # which waits on the host at each eval
                with profile(activities=[ProfilerActivity.CUDA]) if loop \
                        else contextlib.nullcontext() as prof:
                    t0 = time.perf_counter()
                    res = counted(run, loop, flag)
                    sec = time.perf_counter() - t0
                tr = res[0].trajectory
                if loop:
                    wall, dev, _ = profile_round.replay_window(
                        profile_round.device_events(prof), PIPE_MAIN[kern],
                        rounds)
                    ms = {"steady": wall, "busy": dev / wall}
                else:
                    ms = {"steady": steady_ms(tr)}
                ms.update(whole=sec / rounds * 1e3,
                          capture=sum(tr.graphs.values()) * 1e3)
                runs.append((flag, res, dict(counted.last), ms))
            ref = runs[0]
            for flag, res, got, _ in runs[1:]:
                check(same_bits(res, ref[1]),
                      f"{label} {tag} pipeline {flag}: differs from off")
                check(got == ref[2],
                      f"{label} {tag}: launches {got} against {ref[2]}")
            check(ref[2][kern] == rounds * nb,
                  f"{label} {tag}: {ref[2][kern]} {kern} launches for "
                  f"{rounds} rounds of {nb} blocks")
            case[tag] = {"ms": [(flag, ms) for flag, _, _, ms in runs],
                         "launches": {k: v for k, v in ref[2].items() if v}}
        w = torch.zeros(ds.num_features, device="cuda")
        alpha = torch.zeros(ds.k, ds.n_shard, device="cuda")
        idxs = torch.stack([torch.randperm(int(c), device="cuda")[
            :ds.n // ds.k // 10] for c in ds.counts]).to(torch.int32)
        if b_vec is not None:
            w = -b_vec[0].to(w.dtype)
        route = cocoa_mod.block_route("dense", block, torch.float32)
        mode = "prox" if b_vec is not None else "plus"
        kw = dict(mode=mode, sigma=float(ds.k), block=block, route=route,
                  loss="lasso" if b_vec is not None else "hinge",
                  smoothing=0.0 if b_vec is not None else 1.0)
        shards = ds.shard_arrays()
        lam, n = (b_vec[1], 1) if b_vec is not None else (1e-3, ds.n)
        forks = {}
        outs = {}
        for flag in (False, True):
            forks[flag] = graph_forks(
                lambda flag=flag: cocoa_mod.local_sdca_block_batched(
                    w, alpha, shards, idxs, lam, n, pipeline=flag, **kw))
            outs[flag] = forks[flag][2]
        check(all(torch.equal(a, b) for a, b in zip(outs[True], outs[False])),
              f"{label}: the captured pipelined round differs from the "
              f"serial one")
        if forks[True][0] is not None:
            check(forks[True][0] > 0 and forks[False][0] == 0,
                  f"{label}: forks in the captured round, on "
                  f"{forks[True][0]}, off {forks[False][0]}")
        case["forks"] = {str(f): v[:2] for f, v in forks.items()}
        out[label] = case
        ch, dl = ([ms for _, ms in case[tag]["ms"]]
                  for tag in ("chunked", "device loop"))
        print(f"phase 16 (a): {label}: on == off bit for bit on both "
              f"loops, {nb} blocks a round, launches a run "
              f"{case['chunked']['launches']}; ms per round in turns (off, "
              f"on, on, off), past the first chunk and the capture: chunked "
              f"{turns(ch, 'steady')} (host clock), device loop "
              f"{turns(dl, 'steady')} (profiler on, device timeline; busy "
              f"there {turns(dl, 'busy', '{:.1%}')}); whole runs, capture "
              f"included: chunked {turns(ch, 'whole')}, device loop "
              f"{turns(dl, 'whole')}; ms a run capturing its "
              f"graphs: chunked {turns(ch, 'capture', '{:.1f}')}, device "
              f"loop {turns(dl, 'capture', '{:.1f}')}; captured round forks "
              f"(nodes with >1 successor, edges): "
              f"on {forks[True][:2]}, off {forks[False][:2]}; "
              f"{time.perf_counter() - t_case:.1f} s; card {card}")
    return out


def phase_eval_twin(rcv1, demo, counted, card):
    """(b) ``--evalDense``: rcv1-like CoCoA+ sequentially (B1) and at
    B=128 (B5, B3, B6), 100 rounds, an eval every 25, on permuted draws
    (a block that draws a row twice adds its alpha deltas by atomics in a
    varying order, so only these are bit-stable), without the twin,
    with it, with it, without: training bit for bit, each eval within
    relative 1e-5; ms per round with the evals; ms per eval with the twin
    and with the sparse gather, by CUDA events, in turns; and the
    ``evalDense=auto`` lines at rcv1-like (without and with
    ``--hotCols=auto``) and on the demo."""
    from cocoa_torch.evals import objectives

    k, h = 8, rcv1.n // 8 // 10
    plain = shard_dataset(rcv1, k, layout="sparse", dtype=torch.float32,
                          device="cuda")
    t0 = time.perf_counter()
    twin = shard_dataset(rcv1, k, layout="sparse", dtype=torch.float32,
                         device="cuda", eval_dense=True)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0,
           "twin_bytes": twin.X_eval.numel() * 4}
    params = Params(n=rcv1.n, num_rounds=100, local_iters=h, lam=1e-4)
    debug = DebugParams(debug_iter=25, seed=0)
    for label, block, kerns in (("sequential", 0, ("B1",)),
                                (f"block B={BLOCK}", BLOCK,
                                 ("B5", "B3", "B6"))):
        runs = []
        for tag, ds in (("sparse", plain), ("twin", twin), ("twin", twin),
                        ("sparse", plain)):
            w, alpha, traj = counted(cocoa_mod.run_cocoa, ds, params, debug,
                                     plus=True, quiet=True, math="fast",
                                     block_size=block, rng="permuted")
            for kern in kerns:
                check(counted.last[kern] > 0,
                      f"(b) {label} {tag}: {kern} never launched")
            runs.append((tag, w, alpha, traj))
        _, w0, a0, traj0 = runs[0]
        for tag, w, alpha, traj in runs[1:]:
            check(torch.equal(w, w0) and torch.equal(alpha, a0),
                  f"(b) {label} {tag}: the trained state differs")
            for x, y in zip(traj.records, traj0.records):
                for got, want in ((x.primal, y.primal), (x.gap, y.gap)):
                    check(abs(got - want) <= 1e-5 * abs(want),
                          f"(b) {label} {tag} round {x.round}: {got} "
                          f"against {want}")
        out[label] = [(tag, steady_ms(traj)) for tag, _, _, traj in runs]
        print(f"phase 16 (b): rcv1-like {label}: with the twin == without, "
              f"trained state bit for bit, evals within rel 1e-5; ms per "
              f"round with an eval every 25 (in turns): " + ", ".join(
                  f"{tag} {ms:.4f}" for tag, ms in out[label]))
    w = w0.clone()
    evals = {}
    for tag, ds in (("sparse", plain), ("twin", twin), ("twin", twin),
                    ("sparse", plain)):
        shards = ds.shard_arrays()
        evals.setdefault(tag, []).append(cuda_ms(
            lambda: objectives.eval_metrics(w, a0, shards, 1e-4, rcv1.n),
            20))
    out["eval_ms"] = evals
    del twin
    lines = {}
    for name, data, kk, hot in (("rcv1-like", rcv1, 8, None),
                                ("rcv1-like --hotCols=auto", rcv1, 8, "auto"),
                                ("demo", demo, 4, None)):
        cfg = RunConfig(num_features=data.num_features, num_splits=kk,
                        eval_dense="auto", hot_cols=hot)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            layout, hot_n, decided = cli._layout_knobs(
                cfg, data.n, int(data.indptr[-1]),
                hybrid.column_counts(data), kk, torch.float32)
            cli._announce_eval(cfg, layout, hot_n, decided)
        lines[name] = (decided, [ln for ln in buf.getvalue().splitlines()
                                 if ln.startswith("evalDense")])
    check(not lines["rcv1-like"][0] and lines["demo"][0],
          f"(b) evalDense=auto decided {lines}")
    out["auto"] = lines
    print(f"phase 16 (b): the twin {out['twin_bytes'] / 1e9:.3f} GB, built "
          f"in {out['build_s']:.1f} s; ms per eval (eval_metrics, CUDA "
          f"events, in turns) " + ", ".join(
              f"{tag} " + "/".join(f"{v:.4f}" for v in vs)
              for tag, vs in evals.items())
          + "; evalDense=auto: " + "; ".join(
              f"{name}: {ln}" for name, (_, ln) in lines.items())
          + f"; card {card}")
    return out


def phase_parser(rcv1, card):
    """(c) The native LIBSVM parser: built into cocoa_torch/_build/ and
    taken by ``load_libsvm`` (its ``parse_file`` called), equal to the
    Python parser bit for bit, and each one's seconds, on the demo and on
    an rcv1-like file written from ``synth_sparse``'s rows."""
    from cocoa_torch.data import libsvm, native_loader

    t0 = time.perf_counter()
    check(native_loader.available(), "the native LIBSVM parser did not build")
    out = {"build_s": time.perf_counter() - t0,
           "library": str(native_loader.library_path().relative_to(ROOT))}
    with tempfile.TemporaryDirectory(dir=OUT) as d:
        path = os.path.join(d, "rcv1_like.svm")
        write_libsvm(rcv1, path)
        for name, p, nf in (("demo", str(DEMO_TRAIN), 9947),
                            ("rcv1-like", path, RCV1_SHAPE[1])):
            secs, took = [], []
            real = native_loader.parse_file

            def spy(*args):
                data = real(*args)
                took.append(data is not None)
                return data

            for _ in range(2):
                with mock.patch.object(native_loader, "parse_file", spy):
                    t0 = time.perf_counter()
                    nat = load_libsvm(p, nf)
                    secs.append(time.perf_counter() - t0)
            check(took == [True, True],
                  f"(c) {name}: load_libsvm did not take the native parser")
            t0 = time.perf_counter()
            py = libsvm.load_libsvm_python(p, nf)
            py_s = time.perf_counter() - t0
            for f in ("labels", "indptr", "indices", "values"):
                a, b = getattr(nat, f), getattr(py, f)
                check(a.dtype == b.dtype and np.array_equal(a, b),
                      f"(c) {name}: native {f} differs from Python's")
            out[name] = {"bytes": os.path.getsize(p), "native_s": secs,
                         "python_s": py_s, "rows": nat.n,
                         "nnz": int(nat.indptr[-1])}
            print(f"phase 16 (c): {name} ({out[name]['bytes']} bytes, "
                  f"{nat.n} rows, {int(nat.indptr[-1])} nonzeros): native "
                  f"{secs[0]:.4f}/{secs[1]:.4f} s, Python {py_s:.3f} s, bit "
                  f"for bit; card's host, {card}")
    return out


def atomic_subgradient_pass(w, shards, lam, loss="hinge", smoothing=1.0,
                            slots=None):
    """DistGD's sparse pass with one ``scatter_add_`` over every slot of
    a shard, whose atomics add a column's terms in a varying order: the
    form the order-stable pass (ops/subgradient.py) replaced, timed
    beside it in (d)."""
    from cocoa_torch.ops import losses
    from cocoa_torch.ops.rows import shard_margins

    labels = shards["labels"]
    coef = labels * losses.grad_factor(loss, labels * shard_margins(w, shards),
                                       smoothing=smoothing)
    k = coef.shape[0]
    dw = torch.zeros(k, w.shape[0], dtype=w.dtype, device=w.device)
    dw.scatter_add_(1, shards["sp_indices"].reshape(k, -1).long(),
                    (shards["sp_values"] * coef[..., None]).reshape(k, -1))
    return dw - lam * w


def phase_dist_gd(demo, counted, card):
    """(d) ROADMAP C4: the demo menu through the CLI twice, 100 rounds,
    sparse layout: every algorithm bit for bit, DistGD included; then
    DistGD alone on the demo's shards, 500 rounds, with the scatter it
    replaced and with the order-stable pass, in turns (atomic, ordered,
    ordered, atomic): ms per round past the first chunk, and whether each
    pair of runs is bit-stable."""
    from cocoa_torch.solvers import dist_gd as dist_gd_mod

    argv = [f"--trainFile={DEMO_TRAIN}", f"--testFile={DEMO_TEST}",
            "--numFeatures=9947", "--numSplits=4", "--localIterFrac=0.1",
            "--lambda=.001", "--math=fast", "--dtype=float32",
            "--justCoCoA=false", "--layout=sparse", "--numRounds=100"]
    (_, first), (_, second) = (counted(run_cli, argv) for _ in range(2))
    for a, b in zip(first, second):
        check(same_bits([a], [b]),
              f"(d) demo menu {a.algorithm}: two uninterrupted runs differ")
    check(counted.last["B1"] > 0, "(d) demo menu: B1 never launched")
    ds = shard_dataset(demo, 4, layout="sparse", dtype=torch.float32,
                       device="cuda")
    params = Params(n=demo.n, num_rounds=500, local_iters=1, lam=1e-3)
    debug = DebugParams(debug_iter=25, seed=0)
    runs = {}
    for tag in ("atomic", "ordered", "ordered", "atomic"):
        fn = atomic_subgradient_pass if tag == "atomic" else \
            dist_gd_mod.subgradient_pass
        with mock.patch.object(dist_gd_mod, "subgradient_pass", fn):
            w, traj = dist_gd_mod.run_dist_gd(ds, params, debug, quiet=True)
        torch.cuda.synchronize()
        runs.setdefault(tag, []).append(
            (cli.RunResult(traj.algorithm, w, None, traj), steady_ms(traj)))
    stable = {tag: same_bits([r[0][0]], [r[1][0]])
              for tag, r in runs.items()}
    check(stable["ordered"], "(d) two order-stable DistGD runs differ")
    out = {"ms": {tag: [ms for _, ms in r] for tag, r in runs.items()},
           "bit_stable": stable}
    print(f"phase 16 (d): the demo menu twice, every algorithm bit for bit "
          f"(DistGD included); DistGD 500 rounds, ms per round in turns: "
          + "; ".join(f"{tag} " + "/".join(f"{ms:.4f}" for ms in v)
                      + f" (two runs bit for bit: {stable[tag]})"
                      for tag, v in out["ms"].items()) + f"; card {card}")
    return out


def phase_entry_point():
    """(e) ``python -m cocoa_torch`` on the demo in a subprocess: exit 0,
    both algorithms' summaries."""
    argv = [sys.executable, "-m", "cocoa_torch", f"--trainFile={DEMO_TRAIN}",
            f"--testFile={DEMO_TEST}", "--numFeatures=9947", "--numSplits=4",
            "--numRounds=20", "--localIterFrac=0.1", "--lambda=.001",
            "--math=fast", "--debugIter=10"]
    t0 = time.perf_counter()
    res = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                         timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    sec = time.perf_counter() - t0
    check(res.returncode == 0, f"(e) python -m cocoa_torch exited "
                               f"{res.returncode}: {res.stderr[-2000:]}")
    lines = summary_lines(res.stdout)
    check(len(lines) == 4, f"(e) summary lines {lines}")
    print(f"phase 16 (e): python -m cocoa_torch on the demo: exit 0 in "
          f"{sec:.1f} s (process start included): " + " | ".join(lines))
    return {"s": sec, "summary": lines}


def phase_reference_block(rcv1, counted, card):
    """(f) The rcv1-like block round at B=128 (B5, B3, B6) on reference
    draws, which repeat a row in most blocks: two captured runs of 100
    rounds, an eval every 25, bit for bit, trajectories and (w, alpha),
    with the same launches (the block round adds its alpha deltas in slot
    order, ops/local_sdca.py ``_block_alpha_add``)."""
    k, h = 8, rcv1.n // 8 // 10
    ds = shard_dataset(rcv1, k, layout="sparse", dtype=torch.float32,
                       device="cuda")
    params = Params(n=rcv1.n, num_rounds=100, local_iters=h, lam=1e-4)
    debug = DebugParams(debug_iter=25, seed=0)
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        w, alpha, traj = counted(cocoa_mod.run_cocoa, ds, params, debug,
                                 plus=True, quiet=True, math="fast",
                                 block_size=BLOCK, rng="reference")
        runs.append(([cli.RunResult(traj.algorithm, w, alpha, traj)],
                     dict(counted.last), time.perf_counter() - t0))
    nb = -(-h // BLOCK) * params.num_rounds
    for kern in ("B5", "B3", "B6"):
        check(runs[0][1][kern] == runs[1][1][kern] == nb,
              f"(f) {kern}: launches {runs[0][1][kern]}, "
              f"{runs[1][1][kern]}, want {nb}")
    check(same_bits(runs[0][0], runs[1][0]),
          "(f) rcv1-like block B=128 on reference draws: two runs differ")
    print(f"phase 16 (f): rcv1-like block B={BLOCK}, reference draws, "
          f"{params.num_rounds} rounds: two captured runs bit for bit "
          f"(gap {runs[0][0][0].trajectory.records[-1].gap:.6e}); s a run "
          f"{runs[0][2]:.3f}, {runs[1][2]:.3f}; card {card}")
    return {"s": [r[2] for r in runs]}


def phase_surface(rcv1, demo, eps, lasso, card):
    """Phase 16: (a) the block pipeline, (b) the eval twin, (c) the native
    parser, (d) DistGD bit-stable, (e) ``python -m cocoa_torch``, (f) the
    rcv1-like block round on reference draws bit for bit.  Returns a
    summary with the launches of its in-process runs."""
    counted = Counted()
    out = {"card": card}
    for key, fn, args in (("(a)", phase_pipeline, (eps, lasso, counted)),
                          ("(b)", phase_eval_twin, (rcv1, demo, counted)),
                          ("(c)", phase_parser, (rcv1,)),
                          ("(d)", phase_dist_gd, (demo, counted)),
                          ("(e)", phase_entry_point, ()),
                          ("(f)", phase_reference_block, (rcv1, counted))):
        t0 = time.perf_counter()
        out[key] = fn(*args, card) if key != "(e)" else fn()
        print(f"phase 16 {key}: in {time.perf_counter() - t0:.1f} s")
    out["launched"] = counted.total
    print("phase 16: launches of its in-process runs " + ", ".join(
        f"{name} {v}" for name, v in counted.total.items()))
    return out



# --- phase 17: telemetry on the card ---------------------------------------

# the rcv1-like sequential run to the 1e-4 gap through the CLI, sigma'
# auto on permuted draws, checkpoints every 100 rounds (the CLI's accel
# auto is on for CoCoA+, which then stops at round 400, not phase 14
# (a)'s 575); "on" adds every telemetry sink
TELEMETRY_ROUNDS = 800


def telemetry_argv(path, loop, block=0):
    return [f"--trainFile={path}", f"--numFeatures={RCV1_SHAPE[1]}",
            "--numSplits=8", "--localIterFrac=0.1", "--lambda=1e-4",
            "--math=fast", "--dtype=float32", "--rng=permuted",
            f"--numRounds={TELEMETRY_ROUNDS}", "--debugIter=25",
            "--sigma=auto", f"--gapTarget={GAP_TARGET}", "--chkptIter=100",
            "--quiet"] + (["--deviceLoop"] if loop else []) + (
        [f"--blockSize={block}"] if block else [])


def read_events(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def check_stream(label, d, res):
    """One "on" run's artifacts against its results: the port's schema
    accepts the stream; each algorithm's round_eval rounds and gaps are
    its trajectory's; one checkpoint_write event and one checkpoint_save
    span per save; the metrics textfile counts every eval.  Returns
    (events, stream bytes)."""
    from cocoa_torch.telemetry import schema as tele_schema

    ev_path = os.path.join(d, "ev.jsonl")
    errs = tele_schema.check_file(ev_path)
    check(errs == [], f"{label}: schema violations {errs[:5]}")
    evs = read_events(ev_path)
    check([e["event"] for e in evs[:2]] == ["run_start", "ingest"],
          f"{label}: the stream starts {[e['event'] for e in evs[:2]]}")
    check(evs[0]["manifest"]["device_kind"] == torch.cuda.get_device_name(0),
          f"{label}: manifest device {evs[0]['manifest']['device_kind']}")
    n_evals = 0
    for r in res:
        tr = r.trajectory
        got = [(e["t"], e["gap"]) for e in evs if e["event"] == "round_eval"
               and e["algorithm"] == r.algorithm]
        want = [(rec.round, rec.gap) for rec in tr.records]
        check(got == want, f"{label} {r.algorithm}: round_eval (t, gap) "
                           f"{got[:3]}... against the trajectory's "
                           f"{want[:3]}...")
        writes = [e for e in evs if e["event"] == "checkpoint_write"
                  and e["algorithm"] == r.algorithm.replace(" ", "_")]
        saves = [e for e in evs if e["event"] == "span"
                 and e["phase"] == "checkpoint_save"
                 and e["algorithm"] == r.algorithm]
        check(len(writes) == len(saves) == tr.saves > 0,
              f"{label} {r.algorithm}: {len(writes)} checkpoint_write, "
              f"{len(saves)} checkpoint_save spans, {tr.saves} saves")
        check([e["round"] for e in writes] == [e["round"] for e in saves],
              f"{label} {r.algorithm}: save rounds differ")
        n_evals += len(tr.records)
    phases = {e["phase"] for e in evs if e["event"] == "span"}
    check({"local_solve", "checkpoint_save"} <= phases,
          f"{label}: span phases {phases}")
    with open(os.path.join(d, "m.prom")) as f:
        prom = f.read()
    check(f"cocoa_evals_total {n_evals}\n" in prom,
          f"{label}: the metrics textfile does not count {n_evals} evals")
    return evs, os.path.getsize(ev_path)


def same_results(label, res, ref):
    """Two CLI runs' results: bit for bit (w, alpha, every record) and the
    same fetches and saves."""
    check([r.algorithm for r in res] == [r.algorithm for r in ref],
          f"{label}: algorithms differ")
    check(same_bits(res, ref), f"{label}: results differ in their bits")
    for r, p in zip(res, ref):
        check((r.trajectory.fetches, r.trajectory.saves)
              == (p.trajectory.fetches, p.trajectory.saves),
              f"{label} {r.algorithm}: fetches, saves "
              f"{(r.trajectory.fetches, r.trajectory.saves)} against "
              f"{(p.trajectory.fetches, p.trajectory.saves)}")


def sigterm_flightrec(tmp):
    """A ``python -m cocoa_torch`` run on the demo with --events and the
    flight recorder, SIGTERMed at its first eval: it dies by the signal
    and leaves a ``.flightrec`` dump the port's schema accepts."""
    from cocoa_torch.telemetry import schema as tele_schema

    ev = os.path.join(tmp, "killed.jsonl")
    argv = [sys.executable, "-m", "cocoa_torch", f"--trainFile={DEMO_TRAIN}",
            "--numFeatures=9947", "--numSplits=4", "--numRounds=10000000",
            "--localIterFrac=0.1", "--lambda=.001", "--math=fast",
            "--debugIter=100", "--quiet", f"--events={ev}",
            "--flightRecorder=on", "--trace"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": str(ROOT)})
    try:
        deadline = time.time() + 180
        while time.time() < deadline and proc.poll() is None:
            if os.path.exists(ev) and '"round_eval"' in open(ev).read():
                break
            time.sleep(0.05)
        if proc.poll() is not None:
            check(False, f"the SIGTERM run ended by itself: "
                         f"{proc.stderr.read()[-2000:]}")
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == -signal.SIGTERM,
          f"the SIGTERMed run exited {proc.returncode}: {err[-2000:]}")
    dump = ev + ".flightrec"
    check(os.path.exists(dump), "SIGTERM left no .flightrec")
    errs = tele_schema.check_file(dump)
    check(errs == [], f"the .flightrec: schema violations {errs[:5]}")
    head = read_events(dump)[0]["flightrec_manifest"]
    check(head["reason"] == "sigterm" and head["n_events"] > 0,
          f"the .flightrec manifest {head}")
    sec = time.perf_counter() - t0
    print(f"phase 17: python -m cocoa_torch SIGTERMed at its first eval: "
          f"exit {proc.returncode}, .flightrec valid ({head['n_events']} "
          f"events, reason {head['reason']}), {sec:.1f} s")
    return {"n_events": head["n_events"], "seconds": sec}


# the kernels of phase 17's paths as an exported trace names them (the
# demangled name: namespace, then template arguments and parameters)
TRACE_NAMES = {"B1": re.compile(r"::sparse_sdca_round_kernel<"),
               "B3": re.compile(r"::chain_kernel<"),
               "B5": re.compile(r"::gram(_pass)?_kernel<"),
               "B6": re.compile(r"::apply_kernel<")}


class CountingProfile:
    """A ``torch.profiler.profile`` that reads the launch counts as it
    starts and as it stops (``queued``: the launches queued while it ran).
    The CLI starts and stops it between replays, after a fetch or before
    the run, so every kernel queued in that span also ran in it."""

    spans = []

    def __init__(self, inner):
        self.inner = inner
        self.at_start = None

    def start(self):
        self.inner.start()
        self.at_start = counts()

    def stop(self):
        CountingProfile.spans.append(
            {k: v - self.at_start[k] for k, v in counts().items()})
        self.inner.stop()

    def export_chrome_trace(self, path):
        self.inner.export_chrome_trace(path)


def profiled(label, argv, prof, counted, names):
    """A CLI run under ``--profile`` (in ``argv``; its traces in ``prof``):
    one trace, and each kernel of ``names`` in it by name, each launch at
    most once and at least 90 % of those queued while the profiler ran
    (CUPTI has been seen to miss one launch as a window opens).  Returns
    (results, launches of the run, what the trace held)."""
    from cocoa_torch.telemetry import profiling

    inner = profiling.profiler
    CountingProfile.spans = []
    profiling.profiler = lambda: CountingProfile(inner())
    try:
        _, res = counted(run_cli, argv)
    finally:
        profiling.profiler = inner
    check(len(CountingProfile.spans) == 1,
          f"{label}: the profiler ran {len(CountingProfile.spans)} times")
    queued = CountingProfile.spans[0]
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    rows, total_us = profiling.device_table(profiling.parse_trace(prof),
                                            top=8)
    launches = profiling.kernel_launches(prof)
    traced = {name: sum(n for k, n in launches.items()
                        if TRACE_NAMES[name].search(k)) for name in names}
    print(f"phase 17: {label}: {len(traces)} trace(s), "
          f"{sum(launches.values())} kernel events over {len(launches)} "
          f"kernels, {total_us / 1e3:.3f} ms of kernel time; traced/queued "
          + ", ".join(f"{name} {traced[name]}/{queued[name]}"
                      for name in names) + "; top kernels (ms):")
    for track, name, us in rows:
        print(f"  {us / 1e3:9.4f}  {launches.get(name, 0):5d}x  "
              f"{name[:90]}  [{track}]")
    if not all(traced.values()):
        cats = {}
        for e in profiling.trace_events(prof):
            cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
        print(f"phase 17: {label}: the trace lacks a kernel of its path; "
              f"its events by category: {cats}")
    check(len(traces) == 1, f"{label}: --profile wrote {traces}")
    for name in names:
        check(queued[name] > 0 and
              0.9 * queued[name] <= traced[name] <= queued[name],
              f"{label}: the trace holds {traced[name]} {name} launches, "
              f"{queued[name]} queued while the profiler ran (want at most "
              f"one event a launch and at least 90 % of them)")
    return res, dict(counted.last), {
        "traced": traced, "queued": {n: queued[n] for n in names},
        "kernel_ms": total_us / 1e3,
        "top": [(name, us / 1e3, launches.get(name, 0))
                for _, name, us in rows]}


def profile_runs(path, tmp, counted, chunked_off, chunked_n):
    """--profile=DIR,100,200 on the chunked run (B1) and on the block
    path's --deviceLoop run (B5, B3, B6; the window at super-block
    fetches), every sink on; then --profile=DIR on the chunked run, the
    profiler started before the graphs are captured: its w and alpha,
    fetches and launches are the unprofiled run's (``chunked_off``,
    ``chunked_n``)."""
    out = {}
    for tag, loop, block, names in (("chunked", False, 0, ("B1",)),
                                    ("block device loop", True, BLOCK,
                                     ("B5", "B3", "B6"))):
        d = os.path.join(tmp, f"profiled {tag}")
        prof = os.path.join(d, "profile")
        os.makedirs(d)
        argv = telemetry_argv(path, loop, block) + [
            f"--chkptDir={d}/ck", f"--events={d}/ev.jsonl",
            f"--metrics={d}/m.prom", "--trace", f"--profile={prof},100,200"]
        res, _, out[tag] = profiled(f"--profile=DIR,100,200 ({tag})", argv,
                                    prof, counted, names)
        check_stream(f"profiled {tag}", d, res)
    d = os.path.join(tmp, "profiled whole")
    prof = os.path.join(d, "profile")
    os.makedirs(d)
    argv = telemetry_argv(path, False) + [f"--chkptDir={d}/ck",
                                          f"--profile={prof}"]
    res, launched, out["whole"] = profiled("--profile=DIR (chunked, the "
                                           "whole run)", argv, prof,
                                           counted, ("B1",))
    same_results("profiled whole vs off", res, chunked_off)
    check(launched == chunked_n, f"profiled whole: launches {launched} "
                                 f"against {chunked_n}")
    print("phase 17: --profile=DIR (chunked, the whole run): w and alpha "
          "bit for bit the unprofiled run's, the same fetches, saves and "
          "launches")
    return out


def phase_telemetry(path, card):
    """Telemetry on the card, through the CLI on the rcv1-like
    file: the sequential run to the 1e-4 gap (B1), chunked and with
    --deviceLoop, each in turns off, on, on, off ("on": --events
    --metrics --trace --flightRecorder=on), and one chunked "on" run with
    the textfile debounced (--metricsInterval=10); the block path (B=128:
    B5, B3, B6) on --deviceLoop off, on, off.  On against off: w and alpha
    bit for bit, the same fetches, saves and launches (the block path's
    permuted draws never repeat a row within a round, and its kernels
    sum in a fixed order, so it is held bit for bit too); every stream
    valid and equal to its trajectory (:func:`check_stream`).  Then
    --profile (:func:`profile_runs`) and a SIGTERMed subprocess.  Prints
    each run's seconds to the gap (CoCoA+)."""
    counted = Counted()
    out = {"card": card, "runs": {}}
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        def run(tag, loop, on, block=0, extra=()):
            d = os.path.join(tmp, tag)
            os.makedirs(d)
            argv = telemetry_argv(path, loop, block) + [f"--chkptDir={d}/ck"]
            if on:
                argv += [f"--events={d}/ev.jsonl", f"--metrics={d}/m.prom",
                         "--trace", "--flightRecorder=on", *extra]
            t0 = time.perf_counter()
            _, res = counted(run_cli, argv)
            sec = time.perf_counter() - t0
            launched = dict(counted.last)
            stream = check_stream(tag, d, res) if on else (None, 0)
            first = res[0].trajectory
            out["runs"][tag] = {
                "stop": first.records[-1].round,
                "to_gap_s": first.records[-1].wall_time,
                "run_s": sec, "fetches": [r.trajectory.fetches for r in res],
                "saves": [r.trajectory.saves for r in res],
                "events": len(stream[0] or ()), "stream_bytes": stream[1]}
            return res, launched

        for loop, name in ((False, "chunked"), (True, "device loop")):
            runs = {}
            for tag, on in (("off", False), ("on", True), ("on2", True),
                            ("off2", False)):
                runs[tag] = run(f"{name} {tag}", loop, on)
            base_res, base_n = runs["off"]
            if not loop:
                chunked = (base_res, base_n)
            check(base_n["B1"] > 0, f"{name}: B1 never launched")
            same_results(f"{name} off2 vs off", runs["off2"][0], base_res)
            for tag in ("on", "on2"):
                same_results(f"{name} {tag} vs off", runs[tag][0], base_res)
                check(runs[tag][1] == base_n, f"{name} {tag}: launches "
                      f"{runs[tag][1]} against {base_n}")
            print(f"phase 17: rcv1-like sigma' auto to {GAP_TARGET} "
                  f"({name}): CoCoA+ stops at round "
                  f"{out['runs'][name + ' off']['stop']}; seconds to the "
                  f"gap in turns (off, on, on, off): " + ", ".join(
                      f"{out['runs'][f'{name} {t}']['to_gap_s']:.4f}"
                      for t in ("off", "on", "on2", "off2"))
                  + f"; fetches {out['runs'][name + ' off']['fetches']} "
                  f"on and off; bit for bit; launches {base_n}")
            if not loop:
                # the textfile rewritten at most every 10 s, not at each
                # event: what of the cost of "on" the rewrites are
                res, _ = run("chunked on debounced", False, True,
                             extra=["--metricsInterval=10"])
                same_results("chunked on debounced vs off", res, base_res)
                print(f"phase 17: chunked, on with --metricsInterval=10: "
                      f"{out['runs']['chunked on debounced']['to_gap_s']:.4f}"
                      f" s to the gap")
        runs = {}
        for tag, on in (("off", False), ("on", True), ("off2", False)):
            runs[tag] = run(f"block {tag}", True, on, block=BLOCK)
        base_res, base_n = runs["off"]
        for name in ("B3", "B5", "B6"):
            check(base_n[name] > 0, f"block: {name} never launched")
        same_results("block off2 vs off", runs["off2"][0], base_res)
        same_results("block on vs off", runs["on"][0], base_res)
        check(runs["on"][1] == base_n,
              f"block on: launches {runs['on'][1]} against {base_n}")
        print(f"phase 17: rcv1-like --blockSize={BLOCK} --deviceLoop: "
              f"CoCoA+ stops at round {out['runs']['block off']['stop']}; "
              f"seconds to the gap (off, on, off): " + ", ".join(
                  f"{out['runs'][f'block {t}']['to_gap_s']:.4f}"
                  for t in ("off", "on", "off2"))
              + f": on == off == off2 bit for bit; launches {base_n}")
        out["profile"] = profile_runs(path, tmp, counted, *chunked)
        out["sigterm"] = sigterm_flightrec(tmp)
    on_runs = [v for k, v in out["runs"].items() if " on" in k]
    print("phase 17: the 'on' streams: " + ", ".join(
        f"{v['events']} events / {v['stream_bytes']} bytes"
        for v in on_runs) + f"; card {card}")
    out["launched"] = dict(counted.total)
    return out


# --- phase 18: serving on the card (--serve) --------------------------------

# the serving processes' and the trainer's --device
SERVE_DEVICE = "cuda"
# the trainer behind the server: rcv1-like CoCoA+ for up to this many
# rounds, a checkpoint each SERVE_CHKPT; it is stopped once the traffic
# has seen SERVE_SWAPS generations and run SERVE_TRAFFIC_S seconds
SERVE_ROUNDS = 200_000
SERVE_CHKPT = 50
SERVE_SWAPS = 3
SERVE_TRAFFIC_S = 6.0
SERVE_BATCHES = (1, 64, 256, 1024)
SERVE_BUCKETS = (64, 256, 1024)
SERVE_MAX_NNZ = 548
SERVE_TENANTS = 4
# a margin against its float64 reference: of sum_j |w_j x_j|
SERVE_REL = 1e-5

# the archiver: a process of its own (no GIL shared with the client) that
# hard-links each CoCoA+ generation into ARCHIVE as it lands, before the
# trainer's pruning (two generations kept) unlinks it
ARCHIVER = r"""
import os, re, sys, time
src, dst, stop = sys.argv[1:4]
seen = set()
while not os.path.exists(stop):
    try:
        names = os.listdir(src)
    except OSError:
        names = []
    for n in names:
        if re.fullmatch(r"CoCoA\+-r\d+\.npz", n) and n not in seen:
            try:
                os.link(os.path.join(src, n), os.path.join(dst, n))
                seen.add(n)
            except FileExistsError:
                seen.add(n)
            except OSError:
                pass
    time.sleep(0.0005)
"""


class ServeProc:
    """One ``python -m cocoa_torch.cli`` process of this phase, its output
    read on a thread: ``wait_for`` finds a line, ``address`` the announce
    line's, ``close`` stops it (``shutdown``, then SIGTERM, then kill)."""

    def __init__(self, name, argv):
        self.name = name
        self.argv = argv
        self.lines = []
        self._cv = threading.Condition()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "cocoa_torch.cli", *argv], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONPATH": str(ROOT)})
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stdout:
            with self._cv:
                self.lines.append(line)
                self._cv.notify_all()
        with self._cv:
            self._cv.notify_all()

    def wait_for(self, needle, count=1, timeout=240.0) -> str:
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                hits = [ln for ln in self.lines if needle in ln]
                if len(hits) >= count:
                    return hits[count - 1]
                left = deadline - time.monotonic()
                if left <= 0 or self.proc.poll() is not None:
                    check(False, f"{self.name}: no {needle!r} (rc "
                                 f"{self.proc.poll()}):\n"
                                 + "".join(self.lines[-40:]))
                self._cv.wait(min(left, 0.5))

    def address(self, needle="listening on"):
        host, port = self.wait_for(needle).split(needle)[1].split()[0] \
            .split(":")
        return host, int(port)

    def close(self, addr=None, timeout=60.0) -> int:
        if addr is not None and self.proc.poll() is None:
            try:
                with socket.create_connection(addr, timeout=10) as s:
                    s.sendall(b"shutdown\n")
                    s.makefile("rb").readline()
            except OSError:
                pass
        try:
            return self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            return self.stop()

    def stop(self) -> int:
        """SIGTERM (a fleet's router then stops its replicas), SIGKILL
        if it does not exit."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                return self.proc.wait(20)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        return self.proc.wait(15)


class LineClient:
    """One connection to a line-protocol server: ``ask`` sends a request
    line and returns its parsed response and the seconds it took."""

    def __init__(self, addr):
        self.sock = socket.create_connection(addr, timeout=60)
        self.f = self.sock.makefile("rwb")

    def ask(self, line):
        t0 = time.perf_counter()
        self.f.write(line.encode() + b"\n")
        self.f.flush()
        raw = self.f.readline()
        sec = time.perf_counter() - t0
        check(raw != b"", "a serving connection closed mid-request")
        return json.loads(raw), sec

    def close(self):
        self.f.close()
        self.sock.close()


def serve_argv(*flags):
    return ["--serve=0", f"--numFeatures={RCV1_SHAPE[1]}",
            f"--device={SERVE_DEVICE}", *flags]


def query_rows(data, start, n):
    """Rows ``start .. start+n`` of ``data`` (wrapping), as (idx, val)."""
    out = []
    for r in range(start, start + n):
        lo, hi = data.indptr[r % data.n], data.indptr[r % data.n + 1]
        out.append((data.indices[lo:hi].astype(np.int32),
                    data.values[lo:hi]))
    return out


def query_text(qi, qv):
    return " ".join(f"{i + 1}:{v!r}" for i, v in zip(qi.tolist(),
                                                     qv.tolist()))


def entries(resp):
    return resp if isinstance(resp, list) else [resp]


def margin_error(m, w, qi, qv):
    """(|m - w.x| in float64 with x as float32, sum_j |w_j x_j|)."""
    terms = np.asarray(w, np.float64)[qi] * \
        np.asarray(qv, np.float32).astype(np.float64)
    return abs(float(m) - float(terms.sum())), float(np.abs(terms).sum())


def hold_margin(label, m, w, qi, qv, slack=0.0):
    err, scale = margin_error(m, w, qi, qv)
    check(err <= SERVE_REL * scale + slack,
          f"{label}: margin {m} is {err:.3g} from w.x (sum |w x| "
          f"{scale:.3g}, slack {slack:.3g})")


def read_generation(path):
    meta, arrays = checkpoint.load_full(path)
    return meta["round"], np.asarray(arrays["w"], np.float32)


def save_generation(directory, round_t, w):
    return checkpoint.save(directory, "CoCoA+", round_t, w, None, gap=1e-4)


def percentiles(secs):
    ms = np.sort(np.asarray(secs)) * 1e3
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def serve_traffic(label, addr, data, deadline_s, min_rounds):
    """(a)'s traffic: lines of 1, 64, 256 and 1024 rcv1-like rows in turn
    on one connection while the trainer saves generations, until
    ``min_rounds`` generations answered and ``deadline_s`` passed (or
    30 s).  Returns [(round, query, margin)] in the order answered."""
    client = LineClient(addr)
    answered, start, t0 = [], 0, time.perf_counter()
    try:
        while True:
            for b in SERVE_BATCHES:
                rows = query_rows(data, start, b)
                start += b
                resp, _ = client.ask(";".join(query_text(*q) for q in rows))
                got = entries(resp)
                check(len(got) == b and all("margin" in g for g in got),
                      f"{label}: a failed or dropped line: "
                      f"{str(resp)[:300]}")
                check(all(g["dtype"] == "f32" for g in got),
                      f"{label}: served {str(resp)[:300]}")
                # a line's queries may span batches, and so generations
                answered += [(g["round"], q, g["margin"])
                             for g, q in zip(got, rows)]
            elapsed = time.perf_counter() - t0
            seen = len({a[0] for a in answered})
            if (elapsed >= deadline_s and seen >= min_rounds) \
                    or elapsed >= 30.0:
                return answered
    finally:
        client.close()


def phase_serve_while_training(path, rcv1, tmp, card):
    """(a): a port trainer on the card (rcv1-like, CoCoA+, a checkpoint
    each SERVE_CHKPT rounds) and ``python -m cocoa_torch.cli --serve=0``
    beside it; lines of 1, 64, 256 and 1024 rows while it trains: every
    margin against a host float64 w.x of the generation its response
    names, no failed or dropped line, rounds non-decreasing, at least
    SERVE_SWAPS generations answered; then, the trainer stopped, the
    server's margins on the last generation bit for bit those of a cold
    start on it (one query a line: bucket 64 on both)."""
    d = RCV1_SHAPE[1]
    ck = os.path.join(tmp, "ck")
    archive = os.path.join(tmp, "archive")
    stop_file = os.path.join(tmp, "archive.stop")
    os.makedirs(ck)
    os.makedirs(archive)
    archiver = subprocess.Popen([sys.executable, "-c", ARCHIVER, ck, archive,
                                 stop_file])
    t0 = time.perf_counter()
    trainer_err = open(os.path.join(tmp, "trainer.err"), "w+")
    trainer = subprocess.Popen(
        [sys.executable, "-m", "cocoa_torch.cli", f"--trainFile={path}",
         f"--numFeatures={d}", "--numSplits=8", "--localIterFrac=0.1",
         "--lambda=1e-4", "--math=fast", "--dtype=float32",
         f"--numRounds={SERVE_ROUNDS}", f"--debugIter={SERVE_CHKPT}",
         f"--chkptIter={SERVE_CHKPT}", f"--chkptDir={ck}", "--quiet",
         f"--device={SERVE_DEVICE}"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=trainer_err,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    server = ServeProc("the server", serve_argv(
        f"--chkptDir={ck}", f"--serveMaxNnz={SERVE_MAX_NNZ}"))
    try:
        try:
            addr = server.address()
            up_s = time.perf_counter() - t0
            answered = serve_traffic("(a)", addr, rcv1, SERVE_TRAFFIC_S,
                                     SERVE_SWAPS)
            traffic_s = time.perf_counter() - t0 - up_s
            trainer.terminate()
            trainer.wait(60)
            trainer_err.seek(0)
            check(trainer.returncode in (0, -signal.SIGTERM),
                  f"(a) trainer exited {trainer.returncode}: "
                  f"{trainer_err.read()[-2000:]}")
            final = checkpoint.latest(ck, "CoCoA+")
            r_final, w_final = read_generation(final)
            # the server swaps to the last generation within its 0.25 s poll
            time.sleep(1.0)
        finally:
            with open(stop_file, "w"):
                pass
            archiver.wait(30)
            if trainer.poll() is None:
                trainer.kill()
                trainer.wait()
            trainer_err.close()
        gens = {}
        for name in os.listdir(archive):
            r, w = read_generation(os.path.join(archive, name))
            gens[r] = w
        rounds = [a[0] for a in answered]
        check(rounds == sorted(rounds), f"(a) rounds went back: {rounds}")
        swaps = sum("hot-swapped to" in ln for ln in server.lines)
        check(len(set(rounds)) >= SERVE_SWAPS and swaps >= 1,
              f"(a) {len(set(rounds))} generations answered, {swaps} swaps")
        worst = 0.0
        for r, (qi, qv), m in answered:
            check(r in gens, f"(a) generation r{r} answered, not archived")
            err, scale = margin_error(m, gens[r], qi, qv)
            check(err <= SERVE_REL * scale,
                  f"(a) r{r}: margin {m} is {err:.3g} from w.x "
                  f"(sum |w x| {scale:.3g})")
            worst = max(worst, err / max(scale, 1e-30))
        # the last generation: the server against a cold start, bit for bit
        rows = query_rows(rcv1, 5000, 24)
        client = LineClient(addr)
        got = [client.ask(query_text(*q))[0] for q in rows]
        client.close()
        check(all(g["round"] == r_final for g in got),
              f"(a) after the trainer stopped: rounds "
              f"{sorted({g['round'] for g in got})}, newest r{r_final}")
        cold = serve_stack(w_final, r_final, final)
        want = [cold_margin(cold, q) for q in rows]
        check([g["margin"] for g in got] == want,
              "(a) the swapped server and a cold start differ on the last "
              "generation")
        print(f"phase 18 (a): server up {up_s:.1f} s after the trainer "
              f"started; {len(answered)} margins in lines of "
              f"{', '.join(map(str, SERVE_BATCHES))} in "
              f"{traffic_s:.1f} s of traffic, generations r{rounds[0]}.."
              f"r{rounds[-1]} ({len(set(rounds))} answered, {swaps} hot-swaps "
              f"logged, {len(gens)} archived), every margin within "
              f"{SERVE_REL:g} of sum |w x| of its generation's float64 w.x "
              f"(worst {worst:.3g}), rounds non-decreasing, 0 failed; after "
              f"the stop r{r_final} bit for bit a cold start (24 margins); "
              f"card {card}")
        return server, addr, (r_final, w_final, final, gens), {
            "up_s": up_s, "traffic_s": traffic_s, "margins": len(answered),
            "generations": len(set(rounds)),
            "swaps": swaps, "worst_rel": worst, "r_final": r_final}
    except BaseException:   # stop the server, whatever failed
        server.stop()
        raise


def serve_stack(w, round_t, path, sd="f32", calibration=None,
                flip_guard=None, hot_ids=None, n_tenants=None):
    """An in-process serving stack on the card (what a server process
    builds at its start): model slots and a bucket scorer."""
    from cocoa_torch import serving

    info = serving.ModelInfo(round=round_t, path=path, birth_ts=time.time(),
                             gap=1e-4, seq=0)
    slots = serving.ModelSlots(w, info, dtype=sd, calibration=calibration,
                               flip_guard=flip_guard, device=SERVE_DEVICE)
    scorer = serving.BatchScorer(RCV1_SHAPE[1], dtype=sd,
                                 buckets=SERVE_BUCKETS,
                                 max_nnz=SERVE_MAX_NNZ, hot_ids=hot_ids,
                                 model_width=int(np.shape(w)[-1]),
                                 n_tenants=n_tenants, device=SERVE_DEVICE)
    w_dev, scale, _, form = slots.current()
    scorer.warmup(w_dev, scale, form)
    return slots, scorer


def stack_margins(stack, queries, tenants=None):
    """The margins of ``queries`` as one padded bucket, as floats."""
    from cocoa_torch.serving import pick_bucket

    slots, scorer = stack
    w_dev, scale, _, form = slots.current()
    bucket = pick_bucket(len(queries), scorer.buckets)
    idx, val, hot = scorer.assemble(queries, bucket)
    tenant = (None if tenants is None
              else scorer.assemble_tenants(tenants, bucket))
    out = scorer.score(w_dev, idx, val, hot, scale, tenant, form)
    return [float(m) for m in out.cpu()[:len(queries)]]


def cold_margin(stack, query, tenant=None):
    """One query alone, as a server scores a one-query line."""
    return stack_margins(stack, [query],
                         None if tenant is None else [tenant])[0]


def serve_timing(addr, rcv1, card):
    """Queries/s and latency through the TCP server: 300 one-row lines
    one after another, then 40 lines of 64, 20 of 256 and 10 of 1024."""
    client = LineClient(addr)
    out = {}
    try:
        for b, n in ((1, 300), (64, 40), (256, 20), (1024, 10)):
            lines = [";".join(query_text(*q) for q in
                              query_rows(rcv1, 7000 + i * b, b))
                     for i in range(n)]
            secs = []
            t0 = time.perf_counter()
            for line in lines:
                resp, sec = client.ask(line)
                check(all("margin" in e for e in entries(resp)),
                      f"(e) a failed line at batch {b}")
                secs.append(sec)
            wall = time.perf_counter() - t0
            p50, p99 = percentiles(secs)
            out[b] = {"qps": b * n / wall, "p50_ms": p50, "p99_ms": p99}
    finally:
        client.close()
    print("phase 18 (e): through the TCP server (one connection, rcv1-like "
          "rows, f32): " + "; ".join(
              f"lines of {b}: {v['qps']:.0f} queries/s, p50 "
              f"{v['p50_ms']:.2f} ms, p99 {v['p99_ms']:.2f} ms a line"
              for b, v in out.items()) + f"; card {card}")
    return out


def serve_margins_timing(rcv1, w, hot_ids, card):
    """(e): ms a batch of ops/rows.py serve_margins by CUDA events, per
    bucket x form x plain or hot panel, on rcv1-like rows, beside the
    bytes it must move at 3.35 TB/s: the padded batch's index and value
    (8 B a slot), the model gathered at each slot (4, 2 or 1 B), the
    panel (4 B a lane a row) and its model lanes, the margins out.  The
    f32 margins are held bit for bit to ops/rows.py shard_margins' on the
    batch taken as one shard, the evaluator's margin."""
    from cocoa_torch.ops import rows as rows_mod
    from cocoa_torch.serving import BatchScorer, quantize

    out = {}
    lanes = {"f32": 4, "bf16": 2, "int8": 1}
    for layout, ids in (("plain", None), ("hot", hot_ids)):
        scorer = BatchScorer(RCV1_SHAPE[1], buckets=SERVE_BUCKETS,
                             max_nnz=SERVE_MAX_NNZ, hot_ids=ids,
                             device=SERVE_DEVICE)
        for b in SERVE_BUCKETS:
            batch = scorer.assemble(query_rows(rcv1, 11000, b), b)
            idx, val, hot = (None if a is None else
                             torch.from_numpy(a).to(SERVE_DEVICE)
                             for a in batch)
            shard = {"sp_indices": idx, "sp_values": val}
            if hot is not None:
                shard["X_hot"] = hot
                shard["hot_cols"] = torch.from_numpy(
                    np.asarray(hot_ids, np.int64)).to(SERVE_DEVICE)
            w32 = torch.from_numpy(np.asarray(w, np.float32)).to(
                SERVE_DEVICE)
            check(torch.equal(
                rows_mod.serve_margins(w32, shard),
                rows_mod.shard_margins(w32, {k: v[None] for k, v in
                                             shard.items()})[0]),
                  f"(e) {layout} bucket {b}: f32 serving is not "
                  f"shard_margins bit for bit")
            for sd in ("f32", "bf16", "int8"):
                qm = quantize.quantize(w, sd)
                w_dev = quantize.device_words(qm, SERVE_DEVICE)
                ms = cuda_ms(lambda: rows_mod.serve_margins(
                    w_dev, shard, qm.scale, sd), 50)
                slots = b * SERVE_MAX_NNZ
                n_bytes = slots * (8 + lanes[sd]) + b * 4
                if hot is not None:
                    n_bytes += b * scorer.n_hot * 4 \
                        + scorer.n_hot * (8 + lanes[sd])
                bound = n_bytes / HBM_BYTES_PER_S * 1e3
                out[f"{layout} {b} {sd}"] = {"ms": ms, "bound_ms": bound,
                                             "bytes": n_bytes}
    print("phase 18 (e): f32 serve_margins bit for bit shard_margins at "
          "every bucket, plain and hot; serve_margins ms a batch (CUDA "
          "events) / byte bound ms at 3.35 TB/s, max_nnz 548, hot panel "
          f"{len(hot_ids)} lanes: " + "; ".join(
              f"{k} {v['ms']:.4f} / {v['bound_ms']:.5f}"
              for k, v in out.items()) + f"; card {card}")
    return out


def phase_low_precision(procs, gen, rcv1, tmp, card):
    """(b): a ``--serveDtype=bf16`` and an ``int8`` server on the last
    generation, with --events: 64 rows, then a new generation (the same
    w, a later round) whose certificate is taken over those 64 rows, the
    rows again: each response's dtype is the one its generation's
    model_quantize event says was served; quantized margins lie within
    that event's bound (plus the f32 rounding of 1e-5 of sum |w x|) of
    the f32 model's; in process on the card, a forced fallback is bit for
    bit the f32 control, and a forced quantized stack's margins lie
    within the certificate computed on its queries."""
    from cocoa_torch import serving
    from cocoa_torch.serving import quantize

    r_final, w, final, _ = gen
    rows = query_rows(rcv1, 3000, 64)
    line = ";".join(query_text(*q) for q in rows)
    f32 = serve_stack(w, r_final, final)
    f32_margins = stack_margins(f32, rows)
    out = {}
    for sd in ("bf16", "int8"):
        proc, directory, events = procs[sd]
        addr = proc.address()
        client = LineClient(addr)
        first = entries(client.ask(line)[0])
        save_generation(directory, r_final + 1, w)
        deadline = time.monotonic() + 30
        while True:
            time.sleep(0.3)
            quant = [e for e in read_events(events)
                     if e["event"] == "model_quantize"]
            if len(quant) >= 2 or time.monotonic() > deadline:
                break
        second = entries(client.ask(line)[0])
        client.close()
        check(proc.close(addr) == 0, f"(b) {sd} server exit")
        check(len(quant) == 2 and [e["swap_seq"] for e in quant] == [0, 1],
              f"(b) {sd}: model_quantize events {quant}")
        for resp, ev, r in ((first, quant[0], r_final),
                            (second, quant[1], r_final + 1)):
            check(all(e["round"] == r and e["dtype"] == ev["served"]
                      for e in resp),
                  f"(b) {sd}: responses {resp[:2]} against the event {ev}")
        ev = quant[1]
        check(ev["calib_n"] == 64, f"(b) {sd}: calibration {ev['calib_n']}")
        worst = 0.0
        for (qi, qv), m, m32 in zip(rows, [e["margin"] for e in second],
                                    f32_margins):
            _, scale = margin_error(m, w, qi, qv)
            gap = abs(m - m32)
            if ev["served"] == sd:
                check(gap <= ev["bound"] + 2 * SERVE_REL * scale,
                      f"(b) {sd}: |m - m_f32| {gap:.3g} past the bound "
                      f"{ev['bound']:.3g}")
            else:
                check(gap == 0.0, f"(b) {sd}: the fallback's margin {m} "
                                  f"is not the f32 control's {m32}")
            worst = max(worst, gap)
        # in process: the forced fallback and the forced quantized form
        calib = serving.CalibrationBuffer(RCV1_SHAPE[1], max_nnz=8, seed=3)
        for q in rows:
            calib.record(*q)
        fb = serve_stack(w, r_final, final, sd, calib, flip_guard=0.0)
        check(fb[0].served_dtype == "f32" and fb[0].fallbacks_total == 1,
              f"(b) {sd}: the forced fallback served {fb[0].served_dtype}")
        check(stack_margins(fb, rows) == f32_margins,
              f"(b) {sd}: the forced fallback is not the f32 control")
        q_stack = serve_stack(w, r_final, final, sd, calib,
                              flip_guard=float("inf"))
        check(q_stack[0].served_dtype == sd,
              f"(b) {sd}: the forced quantized stack served "
              f"{q_stack[0].served_dtype}")
        wq = quantize.dequantize(quantize.quantize(w, sd), RCV1_SHAPE[1])
        bound, weakest, flips = quantize.margin_error_bound(w, wq, rows)
        for (qi, qv), m, m32 in zip(rows, stack_margins(q_stack, rows),
                                    f32_margins):
            hold_margin(f"(b) {sd} forced", m, wq, qi, qv)
            _, scale = margin_error(m, w, qi, qv)
            check(abs(m - m32) <= bound + 2 * SERVE_REL * scale,
                  f"(b) {sd} forced: past the certificate {bound:.3g}")
        out[sd] = {"load": quant[0]["served"], "swap": ev["served"],
                   "bound": ev["bound"], "worst": worst,
                   "forced_bound": bound, "forced_flips": flips}
        print(f"phase 18 (b): --serveDtype={sd}: served {quant[0]['served']} "
              f"at load (bound {quant[0]['bound']}), {ev['served']} after "
              f"the swap (bound {ev['bound']:.4g} over the 64 rows), "
              f"largest |m - m_f32| "
              f"{worst:.4g}; forced fallback bit for bit the f32 control; "
              f"forced {sd}: bound {bound:.4g}, {flips} flips; card {card}")
    return out


def phase_hot_panel(hot_proc, plain_addr, gen, rcv1, card):
    """(c): ``--hotCols=auto --trainFile`` on the last generation against
    the plain server of (a): the same lines, every margin within 1e-5 of
    sum |w x| of the plain one and of the host's float64 w.x."""
    r_final, w, _, _ = gen
    addr = hot_proc.address()
    panel = hot_proc.wait_for("hot panel over")
    clients = [LineClient(addr), LineClient(plain_addr)]
    worst, n = 0.0, 0
    try:
        for i, b in enumerate(SERVE_BATCHES):
            rows = query_rows(rcv1, 9000 + 1100 * i, b)
            line = ";".join(query_text(*q) for q in rows)
            hot, plain = (entries(c.ask(line)[0]) for c in clients)
            for (qi, qv), h, p in zip(rows, hot, plain):
                check(h["round"] == p["round"] == r_final,
                      f"(c) rounds {h['round']} / {p['round']}")
                err, scale = margin_error(h["margin"], w, qi, qv)
                check(abs(h["margin"] - p["margin"]) <= SERVE_REL * scale
                      and err <= SERVE_REL * scale,
                      f"(c) hot {h['margin']} plain {p['margin']}")
                worst = max(worst, abs(h["margin"] - p["margin"])
                            / max(scale, 1e-30))
                n += 1
    finally:
        for c in clients:
            c.close()
    check(hot_proc.close(addr) == 0, "(c) the hot-panel server's exit")
    print(f"phase 18 (c): {panel.strip()}; {n} margins through the panel "
          f"and residual within {SERVE_REL:g} of sum |w x| of the plain "
          f"server's (worst {worst:.3g}); card {card}")
    return {"margins": n, "worst_rel": worst, "panel": panel.strip()}


def http_get(addr, route):
    import urllib.request

    with urllib.request.urlopen(f"http://{addr[0]}:{addr[1]}{route}",
                                timeout=30) as r:
        return r.read().decode()


def phase_fleet(fleet, cat_path, W, rcv1, tmp, card):
    """(d): ``--serveReplicas=2 --serveRoute=tenant`` over the (T=4, d)
    catalogue the port saved: every tenant's margins bit for bit those of
    a solo server of its model (one query a line); a replica SIGKILLed
    under traffic: 0 failed lines, cocoa_serve_requeue_total >= 1, a
    respawn; /metrics, /healthz and /slo answer; one query_trace a traced
    line (--traceSample=1)."""
    from cocoa_torch import serving

    addr = fleet.address("fleet listening on")
    status = fleet.address("status listening on")
    pid0 = int(fleet.wait_for("replica r0 pid=").split("pid=")[1].split()[0])
    solos = []
    for t in range(SERVE_TENANTS):
        slots, scorer = serve_stack(W[t], 1, cat_path)
        batcher = serving.MicroBatcher(scorer, slots, sla_s=0.05)
        srv = serving.MarginServer(batcher, RCV1_SHAPE[1], SERVE_MAX_NNZ,
                                   port=0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        solos.append((batcher, srv, thread))
    rows = query_rows(rcv1, 13000, 8)
    client = LineClient(addr)
    n_same = 0
    try:
        for t in range(SERVE_TENANTS):
            solo = LineClient(solos[t][1].address)
            for q in rows:
                text = query_text(*q)
                got = client.ask(f"tenant={t};{text}")[0]
                want = solo.ask(text)[0]
                check(got.get("tenant") == t
                      and got["margin"] == want["margin"],
                      f"(d) tenant {t}: fleet {got} solo {want}")
                n_same += 1
            solo.close()
    finally:
        # stop each loop before closing its socket: a serve_forever left
        # polling a closed socket spins, and holds the interpreter lock
        for batcher, srv, thread in solos:
            srv.stop()
            thread.join(timeout=10)
            srv.close()
            batcher.stop()
    failed, sent = [], [0]
    stop = threading.Event()

    def traffic():
        c = LineClient(addr)
        i = 0
        while not stop.is_set():
            t = i % SERVE_TENANTS
            qi, qv = rows[i % len(rows)]
            resp = c.ask(f"tenant={t};{query_text(qi, qv)}")[0]
            sent[0] += 1
            if "margin" not in resp:
                failed.append(resp)
            i += 1
        c.close()

    pump = threading.Thread(target=traffic, daemon=True)
    pump.start()
    time.sleep(0.5)
    t_kill = time.perf_counter()
    os.kill(pid0, signal.SIGKILL)
    fleet.wait_for("replica r0 died")
    fleet.wait_for("replica r0 pid=", count=2)
    respawn_s = time.perf_counter() - t_kill
    time.sleep(0.5)
    stop.set()
    pump.join(60)
    check(not pump.is_alive() and failed == [],
          f"(d) {len(failed)} failed lines under the SIGKILL: {failed[:3]}")
    traced = [client.ask(f"trace={i:04x};tenant={i % SERVE_TENANTS};"
                         f"{query_text(*rows[i % len(rows)])}")[0]
              for i in range(6)]
    check(all(r["trace"]["id"] == f"{i:04x}" for i, r in enumerate(traced)),
          f"(d) traced responses {traced[:2]}")
    health = json.loads(http_get(status, "/healthz"))
    slo = json.loads(http_get(status, "/slo"))
    merged = http_get(status, "/metrics")
    client.close()
    check(health["status"] == "ok" and health["replicas_live"] == 2,
          f"(d) /healthz {health}")
    check("attainment" in slo and slo["replicas_live"] == 2, f"(d) /slo {slo}")
    requeues = [float(ln.split()[-1]) for ln in merged.splitlines()
                if ln.startswith('cocoa_serve_requeue_total{replica="'
                                 'router"}')]
    check(requeues and requeues[0] >= 1,
          f"(d) cocoa_serve_requeue_total {requeues}")
    check(fleet.close(addr) == 0, "(d) the fleet's exit")
    events = read_events(os.path.join(tmp, "fleet.jsonl"))
    n_traces = sum(e["event"] == "query_trace" for e in events)
    check(n_traces == len(traced), f"(d) {n_traces} query_trace events for "
                                   f"{len(traced)} traced lines")
    print(f"phase 18 (d): fleet of 2 replicas, route tenant, catalogue "
          f"{W.shape}: {n_same} margins bit for bit four solo servers'; r0 "
          f"SIGKILLed under traffic ({sent[0]} lines, 0 failed, requeues "
          f"{requeues[0]:g}), respawned in {respawn_s:.1f} s; /healthz "
          f"{health['status']}, /slo attainment {slo['attainment']}, "
          f"/metrics {len(merged.splitlines())} lines; {n_traces} "
          f"query_trace for {len(traced)} traced lines; card {card}")
    return {"same": n_same, "lines": sent[0], "requeues": requeues[0],
            "respawn_s": respawn_s, "slo": slo, "traces": n_traces}


def phase_serving(path, rcv1, card):
    """Phase 18: serving on the card, (a)-(e)."""
    from cocoa_torch.data import hybrid as hybrid_lib

    out = {"card": card}
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        server, plain_addr, gen, out["a"] = phase_serve_while_training(
            path, rcv1, tmp, card)
        r_final, w, final, gens = gen
        # (e) first, with no other process starting beside it
        counts = hybrid_lib.column_counts(rcv1)
        hot_n = hybrid_lib.resolve_hot_width("auto", counts, rcv1.n, 1,
                                             torch.float32)
        hot_ids = hybrid_lib.hottest_columns(counts, hot_n)
        out["e_margins"] = serve_margins_timing(rcv1, w, hot_ids, card)
        out["e_tcp"] = serve_timing(plain_addr, rcv1, card)
        # (b), (c) and (d)'s processes start together
        procs = {}
        for sd in ("bf16", "int8"):
            d = os.path.join(tmp, f"ck_{sd}")
            save_generation(d, r_final, w)
            events = os.path.join(tmp, f"{sd}.jsonl")
            procs[sd] = (ServeProc(f"the {sd} server", serve_argv(
                f"--chkptDir={d}", f"--serveMaxNnz={SERVE_MAX_NNZ}",
                f"--serveDtype={sd}", f"--events={events}")), d, events)
        d_hot = os.path.join(tmp, "ck_hot")
        save_generation(d_hot, r_final, w)
        hot_proc = ServeProc("the hot-panel server", serve_argv(
            f"--chkptDir={d_hot}", f"--serveMaxNnz={SERVE_MAX_NNZ}",
            "--hotCols=auto", f"--trainFile={path}"))
        picks = sorted(gens)
        picks = [picks[i * (len(picks) - 1) // (SERVE_TENANTS - 1)]
                 for i in range(SERVE_TENANTS)]
        W = np.stack([gens[r] for r in picks])
        cat = os.path.join(tmp, "ck_cat")
        cat_path = checkpoint.save(
            cat, "CoCoA+", 1, W, None, gap=1e-4,
            tenant_gaps=[1e-4] * SERVE_TENANTS,
            tenant_cert_ts=[time.time()] * SERVE_TENANTS)
        fleet = ServeProc("the fleet", serve_argv(
            f"--chkptDir={cat}", f"--serveMaxNnz={SERVE_MAX_NNZ}",
            "--serveReplicas=2", "--serveRoute=tenant", "--statusPort=0",
            f"--metrics={tmp}/fleet.prom", f"--events={tmp}/fleet.jsonl",
            "--traceSample=1"))
        try:
            out["b"] = phase_low_precision(procs, gen, rcv1, tmp, card)
            out["c"] = phase_hot_panel(hot_proc, plain_addr, gen, rcv1, card)
            out["d"] = phase_fleet(fleet, cat_path, W, rcv1, tmp, card)
            check(server.close(plain_addr) == 0, "(a) the server's exit")
        finally:
            for proc in [server, hot_proc, fleet] + [p[0] for p in
                                                     procs.values()]:
                proc.stop()
    return out


# --- phase 19: fleet training on the card ----------------------------------

FLEET_README = dict(tenants=256, n=128, d=64, gap=1e-2, k=2, rounds=400,
                    debug_iter=20, frac=0.25)
FLEET_SOLO = 16
FLEET_BITS = dict(n=1024, d=128, k=4, frac=0.25, rounds=200, debug_iter=10,
                  gap=1e-3, map_gap=3e-4, map_lam=(3e-3, 1e-1))
FLEET_PATH = dict(tenants=64, n=8192, d=2048, k=4, frac=0.1, rounds=300,
                  debug_iter=10, gap=1e-3, lam=(1e-4, 1e-1), solo=2,
                  profiled_rounds=20)
FLEET_DEVICE = "cuda"


def fleet_solo(fleet, t, rounds, debug_iter, gap, **kw):
    """Tenant t of ``fleet`` as a solo CoCoA+ run (the chunked loop,
    captured), to ``gap``."""
    ds = fleet.tenant_ds(t)
    params = Params(n=ds.n, num_rounds=rounds, local_iters=fleet.local_iters,
                    lam=float(fleet.lams[t]), sigma=kw.pop("sigma", None))
    return cocoa_mod.run_cocoa(ds, params, DebugParams(debug_iter=debug_iter,
                                                       seed=0),
                               plus=True, quiet=True, gap_target=gap, **kw)


def fleet_lane_is_solo(label, res, t, solo) -> None:
    """Lane t of a fleet run against a solo run, bit for bit: (w, alpha)
    and every eval's primal and gap up to the solo run's stop."""
    w, alpha, traj = solo
    m = alpha.shape[1]
    check(torch.equal(res.w[t], w), f"{label}: lane {t}'s w differs")
    check(torch.equal(res.alpha[t, :, :m], alpha),
          f"{label}: lane {t}'s alpha differs")
    n = len(traj.records)
    check([r.primal for r in traj.records] == list(res.traj[:n, t, 0])
          and [r.gap for r in traj.records] == list(res.traj[:n, t, 1]),
          f"{label}: lane {t}'s evals differ from the solo run's")
    check(bool(res.certified[t]) == (traj.stopped == "target") and (
        traj.stopped != "target"
        or int(res.cert_round[t]) == traj.records[-1].round),
        f"{label}: lane {t} certified at {int(res.cert_round[t])}, the "
        f"solo run stopped {traj.stopped} at {traj.records[-1].round}")


def phase_fleet_readme(tmp, card):
    """(a) The README's fleet through the CLI on the card, then solo runs
    of some of its tenants in-process.  Returns a summary."""
    from cocoa_torch.data.fleet import build_fleet, synth_fleet_specs, \
        write_fleet_manifest
    from cocoa_torch.telemetry import schema as tele_schema

    c = FLEET_README
    man = os.path.join(tmp, "fleet.jsonl")
    specs = synth_fleet_specs(c["tenants"], n=c["n"], d=c["d"],
                              gap_target=c["gap"])
    write_fleet_manifest(man, specs)
    ev, prom = os.path.join(tmp, "fleet_ev.jsonl"), \
        os.path.join(tmp, "fleet.prom")
    argv = [sys.executable, "-m", "cocoa_torch.cli", f"--fleet={man}",
            f"--numSplits={c['k']}", f"--numRounds={c['rounds']}",
            f"--debugIter={c['debug_iter']}",
            f"--localIterFrac={c['frac']}", f"--metrics={prom}",
            f"--events={ev}"]
    if FLEET_DEVICE != "cuda":
        argv.append(f"--device={FLEET_DEVICE}")
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"(a) the fleet CLI exited "
                                f"{proc.returncode}: {proc.stderr[-2000:]}")
    m = re.search(r"^fleet: (\d+)/(\d+) tenants certified, (\d+) rounds, "
                  r"([\d.]+)s, ([\d.]+) models/s \(drive_mode=plain, "
                  r"lanes=vmap\)$", proc.stdout, re.M)
    check(m is not None, f"(a) no fleet summary line: "
                         f"{proc.stdout[-1500:]}")
    certified, t_count, rounds = (int(m.group(i)) for i in (1, 2, 3))
    loop_s, fleet_mps = float(m.group(4)), float(m.group(5))
    check(certified == t_count == c["tenants"],
          f"(a) {certified}/{t_count} tenants certified")
    errs = tele_schema.check_file(ev)
    check(errs == [], f"(a) schema violations {errs[:5]}")
    evs = read_events(ev)
    check(evs[0]["event"] == "run_start"
          and evs[0]["manifest"]["fleet"]["tenants"] == c["tenants"]
          and evs[0]["manifest"]["device_kind"]
          == torch.cuda.get_device_name(0),
          f"(a) run_start {evs[0].get('manifest', {}).get('fleet')}")
    prog = [e for e in evs if e["event"] == "fleet_progress"]
    cert = [e for e in evs if e["event"] == "tenant_certified"]
    fetches = [e["label"] for e in evs if e["event"] == "host_transfer"]
    check(len(cert) == c["tenants"] and prog[-1]["certified_total"]
          == c["tenants"] and prog[-1]["active"] == 0,
          f"(a) {len(cert)} tenant_certified, last progress {prog[-1]}")
    check(prog[-1]["models_per_second"] is not None
          and all(p["models_per_second"] is None for p in prog[:-1]),
          "(a) models/s not on the final fleet_progress alone")
    check(fetches.count("fleet_loop_fetch") == 1
          and fetches.count("fleet_result_fetch") == 1,
          f"(a) fetches {fetches}")
    with open(prom) as f:
        text = f.read()
    check(f"cocoa_tenants_certified_total {c['tenants']}\n" in text
          and "cocoa_fleet_tenants_active 0\n" in text
          and "cocoa_fleet_models_per_second" in text,
          "(a) the metrics textfile lacks the fleet's gauges")
    # the first tenants as solo runs, each to its own target
    fleet = build_fleet(specs[:FLEET_SOLO], k=c["k"],
                        local_iter_frac=c["frac"], device=FLEET_DEVICE)
    t0 = time.perf_counter()
    solo_cert = 0
    for t in range(FLEET_SOLO):
        _, _, traj = fleet_solo(fleet, t, c["rounds"], c["debug_iter"],
                                c["gap"])
        solo_cert += traj.stopped == "target"
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    solo_mps = solo_cert / solo_s
    out = {"cli_s": cli_s, "loop_s": loop_s, "rounds": rounds,
           "fleet_models_per_s": fleet_mps, "solo_models_per_s": solo_mps,
           "solo_certified": solo_cert, "solo_s": solo_s,
           "events": len(evs)}
    print(f"phase 19 (a): {c['tenants']} tenants (n={c['n']}, d={c['d']}, "
          f"K={c['k']}) through the CLI: {certified} certified in {rounds} "
          f"rounds, loop {loop_s:.2f} s ({cli_s:.1f} s the process), "
          f"{fleet_mps:.1f} models/s; events schema-valid, one loop fetch; "
          f"{FLEET_SOLO} of them solo: {solo_cert} certified in "
          f"{solo_s:.2f} s, {solo_mps:.1f} models/s; fleet/solo "
          f"{fleet_mps / max(solo_mps, 1e-9):.1f}x; card {card}")
    return out


def phase_fleet_bits(card):
    """(b) One-tenant fleets against the solo runs, map lanes of an
    unequal-lambda fleet against their solo runs, and an early-certified
    lane frozen, bit for bit on the card.  Returns a summary."""
    from cocoa_torch.data.fleet import build_fleet, synth_fleet_specs
    from cocoa_torch.solvers.fleet import run_cocoa_fleet

    c = FLEET_BITS
    debug = DebugParams(debug_iter=c["debug_iter"], seed=0)
    one = build_fleet(synth_fleet_specs(1, n=c["n"], d=c["d"],
                                        gap_target=c["gap"], lam_lo=1e-2),
                      k=c["k"], local_iter_frac=c["frac"],
                      device=FLEET_DEVICE)
    fparams = Params(n=0, num_rounds=c["rounds"],
                     local_iters=one.local_iters)
    out = {}
    for mode, fkw, skw in (("plain", {}, {}),
                           ("anneal", dict(sigma="auto"),
                            dict(sigma="auto", sigma_schedule="anneal")),
                           ("accel", {}, dict(accel="on"))):
        res = run_cocoa_fleet(one, dataclasses.replace(fparams, **fkw),
                              debug, drive_mode=mode, quiet=True)
        solo = fleet_solo(one, 0, c["rounds"], c["debug_iter"], c["gap"],
                          **skw)
        fleet_lane_is_solo(f"(b) T=1 {mode}", res, 0, solo)
        check(len(res.graphs) == (FLEET_DEVICE == "cuda"),
              f"(b) {mode}: {len(res.graphs)} graphs")
        out[mode] = (int(res.cert_round[0]), res.evals)
    # --math=fast: the solo plain round bit for bit, the solo B2 run close
    res = run_cocoa_fleet(one, fparams, debug, math="fast", quiet=True)
    with mock.patch.object(cocoa_mod, "fast_round_route",
                           lambda *a: "plain"):
        plain = fleet_solo(one, 0, c["rounds"], c["debug_iter"], c["gap"],
                           math="fast")
    fleet_lane_is_solo("(b) T=1 fast, the solo plain round", res, 0, plain)
    reset_counts()
    _, _, b2 = fleet_solo(one, 0, c["rounds"], c["debug_iter"], c["gap"],
                          math="fast")
    check(counts()["B2"] > 0 or FLEET_DEVICE != "cuda",
          "(b) the solo fast run launched no B2")
    n = min(len(b2.records), res.evals)
    worst = max(abs(b2.records[i].gap - res.traj[i, 0, 1])
                / abs(b2.records[i].gap) for i in range(n))
    check(worst <= 1e-3, f"(b) fast fleet against the solo B2 run: gaps "
                         f"within relative {worst:.2e}")
    out["fast_vs_b2_rel"] = worst
    # four tenants of unequal lambda on map lanes
    four = build_fleet(synth_fleet_specs(4, n=c["n"], d=c["d"],
                                         gap_target=c["map_gap"],
                                         lam_lo=c["map_lam"][0],
                                         lam_hi=c["map_lam"][1]),
                       k=c["k"], local_iter_frac=c["frac"],
                       device=FLEET_DEVICE)
    res = run_cocoa_fleet(four, fparams, debug, lane_exec="map", quiet=True)
    for t in range(4):
        fleet_lane_is_solo(f"(b) T=4 map lane {t}", res, t,
                           fleet_solo(four, t, c["rounds"], c["debug_iter"],
                                      c["map_gap"]))
    early = [t for t in range(4) if res.certified[t]
             and int(res.cert_round[t]) < res.rounds_run]
    check(early, f"(b) no lane certified before the others "
                 f"({res.cert_round.tolist()})")
    t = early[0]
    r_a = int(res.cert_round[t])
    short = run_cocoa_fleet(four, dataclasses.replace(fparams,
                                                      num_rounds=r_a),
                            debug, lane_exec="map", quiet=True)
    check(torch.equal(short.w[t], res.w[t])
          and torch.equal(short.alpha[t], res.alpha[t]),
          f"(b) lane {t} moved after certifying at round {r_a}")
    out["map_cert_rounds"] = res.cert_round.tolist()
    print(f"phase 19 (b): T=1 fleets == solo runs bit for bit (certified "
          f"round, evals: " + ", ".join(f"{k} {v}" for k, v in out.items()
                                        if k in ("plain", "anneal",
                                                 "accel"))
          + f"), --math=fast == the solo plain round bit for bit and the "
          f"solo B2 run within relative {worst:.2e}; T=4 map lanes == their "
          f"solo runs (certified at {out['map_cert_rounds']}), lane {t} "
          f"frozen from round {r_a}; card {card}")
    return out


def fleet_busy(events) -> float:
    """The device's busy share over a profiled fleet run's replays: the
    union of its events' spans (profile_round.union_us) over the span
    after the run's longest idle gap (the eager step's capture)."""
    import profile_round

    ev = sorted((a, b) for _, a, b in events)
    first, widest, reach = 0, 0.0, ev[0][1]
    for i in range(1, len(ev)):
        if ev[i][0] - reach > widest:
            first, widest = i, ev[i][0] - reach
        reach = max(reach, ev[i][1])
    window = ev[first:]
    span = max(b for _, b in window) - window[0][0]
    return profile_round.union_us(window) / span


def phase_fleet_path(card):
    """(c) A lambda path of 64 tenants over one 8192 x 2048 set on vmap
    lanes: ms a replayed step and a round, capture s, certified tenants
    and rounds, models/s, dead replays; a shorter run profiled for the
    busy share; 8 tenants' solo certified rounds.  Returns a summary."""
    from torch.profiler import ProfilerActivity, profile

    import profile_round
    from cocoa_torch.data.fleet import TenantSpec, build_fleet
    from cocoa_torch.solvers.fleet import run_cocoa_fleet

    c = FLEET_PATH
    ref = f"synth:dense:n={c['n']},d={c['d']}"
    lams = np.logspace(np.log10(c["lam"][0]), np.log10(c["lam"][1]),
                       c["tenants"])
    t0 = time.perf_counter()
    fleet = build_fleet([TenantSpec(f"lam-{i:02d}", ref, float(lam),
                                    gap_target=c["gap"])
                         for i, lam in enumerate(lams)], k=c["k"],
                        local_iter_frac=c["frac"], device=FLEET_DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    slab_gb = fleet.X.numel() * fleet.X.element_size() / 1e9
    debug = DebugParams(debug_iter=c["debug_iter"], seed=0)
    params = Params(n=0, num_rounds=c["rounds"],
                    local_iters=fleet.local_iters)
    t0 = time.perf_counter()
    res = run_cocoa_fleet(fleet, params, debug, quiet=True)
    run_s = time.perf_counter() - t0
    check(res.dead <= base.FleetRunner.AHEAD - 1,
          f"(c) {res.dead} dead replays")
    check(np.isfinite(res.traj).any() and np.all(res.final_gap >= -1e-4),
          "(c) non-finite or negative final gaps")
    capture_s = sum(res.graphs.values())
    ms_round = (res.replay_ms / c["debug_iter"]
                if res.replay_ms is not None else float("nan"))
    cert = {fleet.tenants[t]: int(res.cert_round[t])
            for t in range(fleet.t) if res.certified[t]}
    prof_params = dataclasses.replace(params,
                                      num_rounds=c["profiled_rounds"])
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_cocoa_fleet(fleet, prof_params, debug, quiet=True)
        torch.cuda.synchronize()
    busy = fleet_busy(profile_round.device_events(prof))
    prof_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    solo = {}
    # from the second quarter of the path on, where solo runs stop early
    picks = np.linspace(fleet.t // 4, fleet.t - 1, c["solo"]).astype(int)
    for t in picks:
        _, _, traj = fleet_solo(fleet, int(t), c["rounds"], c["debug_iter"],
                                c["gap"])
        solo[fleet.tenants[t]] = (traj.records[-1].round
                                  if traj.stopped == "target" else 0)
    solo_s = time.perf_counter() - t0
    differ = {name: (solo[name], cert.get(name, 0)) for name in solo
              if solo[name] != cert.get(name, 0)}
    out = {"build_s": build_s, "slab_gb": slab_gb,
           "replay_ms_step": res.replay_ms, "ms_round": ms_round,
           "capture_s": capture_s, "wall_s": res.wall_s,
           "certified": len(cert), "cert_rounds": cert,
           "models_per_s": res.models_per_second, "dead": res.dead,
           "rounds_run": res.rounds_run, "busy": busy, "solo": solo,
           "solo_differ": differ, "run_s": run_s, "profiled_s": prof_s,
           "solo_s": solo_s}
    print(f"phase 19 (c): lambda path, {fleet.t} tenants x (K={fleet.k}, "
          f"n_shard={fleet.n_shard}, d={fleet.num_features}, "
          f"H={fleet.local_iters}), {slab_gb:.2f} GB of rows stacked in "
          f"{build_s:.1f} s; {res.rounds_run} rounds: {ms_round:.3f} ms a "
          f"round replayed ({res.replay_ms or float('nan'):.2f} ms a step "
          f"of {c['debug_iter']}), capture {capture_s:.2f} s, wall "
          f"{res.wall_s:.2f} s; {len(cert)} certified "
          f"(rounds {sorted(set(cert.values()))}), "
          f"{res.models_per_second:.2f} models/s; dead replays {res.dead}; "
          f"busy {busy:.1%} over a {c['profiled_rounds']}-round profiled "
          f"run's replays; solo certified rounds of {len(solo)} tenants "
          + ("all equal" if not differ else
             f"differ (solo, fleet): {differ}")
          + f"; s: run {run_s:.1f}, profiled run {prof_s:.1f}, solo runs "
          f"{solo_s:.1f}; card {card}")
    return out


def phase_fleet_c5(rcv1, card):
    """(d) The block round's alpha update: the atomic scatter it replaced
    and the order-stable (masked) one, in turns (atomic, own, own,
    atomic), on the rcv1-like block round and the epsilon-like fused
    round (time_block_round.py ``measure``); the order-stable rounds
    bit-stable, each time beside the card."""
    import time_block_round as tbr

    sets = tbr.block_sets(sys.modules[__name__], rcv1)
    runs = [tbr.measure(sets, sys.modules[__name__], form)
            for form in ("atomic", "own", "own", "atomic")]
    for r in runs[1:3]:
        check(r["rcv1_block_stable"] and r["eps_fused_stable"],
              f"(d) the order-stable rounds differ between calls: {r}")
    keys = [k for k in runs[0] if k.endswith("_ms")]
    print("phase 19 (d): the block round's alpha update in turns (atomic, "
          "order-stable, order-stable, atomic), ms by CUDA-graph replay: "
          + "; ".join(f"{k} " + ", ".join(f"{r[k]:.4f}" for r in runs)
                      for k in keys)
          + "; blocks with a repeated row: rcv1-like "
          f"{runs[0]['rcv1_block_repeat_blocks']:.1%}, epsilon-like "
          f"{runs[0]['eps_fused_repeat_blocks']:.1%}; atomic rounds "
          f"bit-stable across two calls: rcv1-like "
          f"{runs[0]['rcv1_block_stable']}, {runs[3]['rcv1_block_stable']}"
          f", epsilon-like {runs[0]['eps_fused_stable']}, "
          f"{runs[3]['eps_fused_stable']}; card {card}")
    return {"turns": runs}


def phase_fleet_training(rcv1, card):
    """Phase 19: fleet training on the card, (a)-(d), ``rcv1`` the
    rcv1-like data of (d).  Returns a summary."""
    out = {"card": card}
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        for key, fn, args in (("(a)", phase_fleet_readme, (tmp,)),
                              ("(b)", phase_fleet_bits, ()),
                              ("(c)", phase_fleet_path, ()),
                              ("(d)", phase_fleet_c5, (rcv1,))):
            t0 = time.perf_counter()
            out[key] = fn(*args, card)
            print(f"phase 19 {key}: in {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
    return out



# --- phase 20: the gang on the card -----------------------------------------

GANG_ROUNDS = 100
GANG_EVAL = 25
GANG_REL = 1e-3          # phase 12's float32 tolerance: gaps relative;
                         # w and alpha relative to their largest entry
GANG_TIMEOUT = 300       # s for a gang's children, then they are killed
GANG_REPS = {"gloo": 50, "nccl": 500}   # all-reduces timed alone

# One process of phase 20: each job is one cli.run (the CLI's own code,
# the gang's flags in its argv), its results hashed and its iterates kept
# in OUT for the parent; then, where asked, the all-reduce of d floats
# timed alone on a fresh group.  Prints one line "GANG <json>".
GANG_CHILD = r"""
import hashlib, json, sys, time
import numpy as np
import torch
from cocoa_torch import cli
from cocoa_torch.ops import block_chain as bc
from cocoa_torch.ops import sparse_block as sb
from cocoa_torch.ops import sparse_sdca as sp
from cocoa_torch.parallel import distributed
from cocoa_torch.parallel.fanout import all_reduce_sum
from cocoa_torch.parallel.mesh import make_mesh
from cocoa_torch.utils import prng

COUNTED = {"B1": (sp.sparse_sdca_round, "launches"),
           "B3": (bc.chain_block_batched, "launches"),
           "B5": (sb.sparse_block_gram, "launches"),
           "B6": (sb.sparse_block_apply, "launches"),
           "D": (prng.draw_tables, "launches"),
           "all_reduce": (all_reduce_sum, "calls")}


def sha(t):
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def run(job, out_dir):
    for fn, attr in COUNTED.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    rc, results = cli.run(job["argv"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    algs, arrays = [], {}
    for r in results:
        recs = r.trajectory.records
        a, b = recs[0], recs[-1]
        timed = a.wall_time is not None and b.wall_time is not None
        algs.append({
            "algorithm": r.algorithm, "stopped": r.trajectory.stopped,
            "records": [[x.round, x.primal, x.gap, x.test_error]
                        for x in recs],
            "ms_round": ((b.wall_time - a.wall_time)
                         / max(1, b.round - a.round) * 1e3
                         if timed else None),
            "w": sha(r.w), "alpha": None if r.alpha is None else sha(r.alpha)})
        key = r.algorithm.replace(" ", "_")
        arrays["w_" + key] = r.w.float().cpu().numpy()
        if r.alpha is not None:
            arrays["alpha_" + key] = r.alpha.float().cpu().numpy()
    np.savez(f"{out_dir}/{job['tag']}.npz", **arrays)
    return {"tag": job["tag"], "rc": rc, "wall_s": wall, "algs": algs,
            "counts": {k: getattr(fn, attr)
                       for k, (fn, attr) in COUNTED.items()}}


def time_all_reduce(spec):
    distributed.maybe_initialize(spec["master"], spec["rank"], spec["world"])
    try:
        mesh = make_mesh(None, "cuda")
        x = torch.randn(spec["d"], device=mesh.device)
        for _ in range(5):
            all_reduce_sum(x, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(spec["reps"]):
            all_reduce_sum(x, mesh)
        torch.cuda.synchronize()
        return {"backend": mesh.backend,
                "ms": (time.perf_counter() - t0) / spec["reps"] * 1e3}
    finally:
        distributed.shutdown()


spec = json.loads(sys.argv[1])
out = {"jobs": [run(job, spec["out"]) for job in spec["jobs"]]}
if spec.get("all_reduce"):
    out["all_reduce"] = time_all_reduce(spec["all_reduce"])
print("GANG " + json.dumps(out), flush=True)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gang_flags(port: int, rank: int, world: int) -> list:
    return [f"--master=127.0.0.1:{port}", f"--processId={rank}",
            f"--numProcesses={world}"]


def spawn_gang(label, specs, env_extra=None, child=GANG_CHILD,
               phase=20) -> list:
    """One ``child`` (GANG_CHILD unless another is given) per spec, all
    started together; each one's log in OUT, its parsed line returned in
    rank order.  Every child is killed and joined on any failure (a hung
    rendezvous holds no port)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "GLOO_SOCKET_IFNAME": "lo",
           **(env_extra or {})}
    procs = [subprocess.Popen([sys.executable, "-c", child,
                               json.dumps(s)], cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for s in specs]
    outs = []
    try:
        deadline = time.time() + GANG_TIMEOUT
        for p in procs:
            o, e = p.communicate(timeout=max(1.0, deadline - time.time()))
            outs.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    parsed = []
    for rank, (rc, o, e) in enumerate(outs):
        (OUT / f"chip_smoke_gang_{label}_{rank}.log").write_text(o + e)
        check(rc == 0, f"phase {phase} {label} rank {rank} exited {rc}: "
                       f"{e[-3000:]}")
        lines = [ln for ln in o.splitlines() if ln.startswith("GANG ")]
        check(len(lines) == 1, f"phase {phase} {label} rank {rank}: no "
                               f"result")
        res = json.loads(lines[0][5:])
        for job in res["jobs"]:
            check(job["rc"] == 0, f"phase {phase} {label} rank {rank} "
                                  f"{job['tag']}: exit {job['rc']}")
        res["stdout"] = o
        parsed.append(res)
    return parsed


def job_of(res, tag):
    return next(j for j in res["jobs"] if j["tag"] == tag)


def same_ranks(label, ranks, tag) -> None:
    """Every rank's records and w bit for bit (alpha is each rank's own
    shards)."""
    ref = job_of(ranks[0], tag)["algs"]
    for r in ranks[1:]:
        got = job_of(r, tag)["algs"]
        check([(a["records"], a["w"], a["stopped"]) for a in got]
              == [(a["records"], a["w"], a["stopped"]) for a in ref],
              f"phase 20 {label} {tag}: the ranks differ")


def close_to_solo(label, algs, ref_results, upto=None) -> None:
    """A gang's records against the solo run's within GANG_REL: the gap,
    the primal where there is none; rounds past ``upto`` left out."""
    for a, r in zip(algs, ref_results):
        check(a["algorithm"] == r.algorithm, f"{label}: algorithms differ")
        want = [x for x in r.trajectory.records
                if upto is None or x.round <= upto]
        got = a["records"][:len(want)]
        check([g[0] for g in got] == [x.round for x in want],
              f"{label} {r.algorithm}: eval rounds differ")
        for g, x in zip(got, want):
            a_v, b_v = (g[2], x.gap) if x.gap is not None else (g[1],
                                                                x.primal)
            check(abs(a_v - b_v) <= GANG_REL * abs(b_v),
                  f"{label} {r.algorithm} round {x.round}: {a_v} vs {b_v}")


def close_arrays(label, got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(got.shape == want.shape, f"{label}: shapes {got.shape} vs "
                                   f"{want.shape}")
    err = float(np.max(np.abs(got - want)))
    check(err <= GANG_REL * float(np.max(np.abs(want))),
          f"{label}: max |diff| {err} against max {np.max(np.abs(want))}")
    return err


def ckpt_arrays(directory, algorithm, round_t):
    meta, arrays = checkpoint.load_full(os.path.join(
        directory, f"{algorithm.replace(' ', '_')}-r{round_t:06d}.npz"))
    check(meta["round"] == round_t, f"{directory}: round {meta['round']}")
    return arrays


def gang_draws() -> str:
    """The draw kernel D given a first global lane: a rank's tables are
    rows [lo, hi) of the whole run's host tables, bit for bit."""
    counts = np.array([2531] * 2 + [2530] * 6)
    t0 = torch.tensor(7, dtype=torch.int64, device="cuda")
    for mode in prng.MODES:
        whole = prng.host_tables(mode, 0, 253, counts, 7, 4)
        for lo, hi in ((0, 4), (4, 8), (6, 8)):
            got = prng.draw_tables(mode, 0, 253, torch.as_tensor(
                counts[lo:hi], device="cuda"), t0, 4, lane0=lo).cpu()
            check(torch.equal(got, whole[:, lo:hi]),
                  f"phase 20: D at lane0={lo} ({mode}) differs from the "
                  f"host rows")
    return "D at first lanes 0, 4, 6 == the whole run's rows, 3 modes"


def phase_gang(path, demo_argv, card):
    """Phase 20: the gang on the card.  (a) two ranks, K=8 (m=4 a rank),
    the rcv1-like file through the CLI, sequential B1 for 100 rounds over
    the gloo device group, against the solo run; the checkpoints; the
    solo process resuming the gang's file.  (b) the block round (B5, B3,
    B6) and the demo menu on the same gang, each rank's launches against
    the m-shard prediction.  (c) NCCL at one rank: the captured chunk
    loop and --deviceLoop, bit for bit with the runs without --master.
    (d) ms per round and the all-reduce alone.  Returns a summary."""
    out = {"card": card, "draws": gang_draws()}
    rcv1 = [f"--trainFile={path}", f"--numFeatures={RCV1_SHAPE[1]}",
            "--numSplits=8", "--localIterFrac=0.1", "--lambda=1e-4",
            "--math=fast", "--dtype=float32", f"--debugIter={GANG_EVAL}"]
    seq = rcv1 + [f"--numRounds={GANG_ROUNDS}"]
    longer = rcv1 + [f"--numRounds={GANG_ROUNDS + 2 * GANG_EVAL}",
                     f"--chkptIter={2 * GANG_EVAL}"]
    block = seq + ["--blockSize=128"]
    menu = [a for a in demo_argv if not a.startswith("--numRounds")] + [
        "--numRounds=50", "--justCoCoA=false"]
    evals = GANG_ROUNDS // GANG_EVAL
    # all-reduces of a CoCoA run: one a round, one an eval, and the end
    # summary's primal and dual sums (cli.py _summary; no test file)
    reduces = 2 * (GANG_ROUNDS + evals + 2)
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        d_solo = os.path.join(tmp, "solo")
        d_rank = [os.path.join(tmp, f"rank{r}") for r in range(2)]
        # the solo runs, in this process (each chunk a captured graph)
        t0 = time.perf_counter()
        _, solo = run_cli(longer + [f"--chkptDir={d_solo}"])
        reset_counts()
        _, solo_block = run_cli(block)
        solo_block_counts = counts()
        _, solo_menu = run_cli(menu)
        solo_s = time.perf_counter() - t0

        # (a) + (b): the gang, two ranks sharing the card over gloo
        t0 = time.perf_counter()
        ports = [free_port() for _ in range(4)]
        specs = [{"out": d_rank[r], "jobs": [
            {"tag": "seq", "argv": seq + gang_flags(ports[0], r, 2) + [
                f"--chkptDir={d_rank[r]}", f"--chkptIter={GANG_ROUNDS}"]},
            {"tag": "block", "argv": block + gang_flags(ports[1], r, 2)},
            {"tag": "menu", "argv": menu + gang_flags(ports[2], r, 2)}],
            "all_reduce": {"master": f"127.0.0.1:{ports[3]}", "rank": r,
                           "world": 2, "d": RCV1_SHAPE[1],
                           "reps": GANG_REPS["gloo"]}}
            for r in range(2)]
        for d in d_rank:
            os.makedirs(d)
        ranks = spawn_gang("ab", specs)
        gang_s = time.perf_counter() - t0
        for tag in ("seq", "block", "menu"):
            same_ranks("(a)/(b)", ranks, tag)
        check("gang: rank 1 of 2 on cuda:0, device group gloo; chunks "
              "eager: a gloo all-reduce cannot be captured"
              in ranks[1]["stdout"], "phase 20 (a): the gang line")
        close_to_solo("phase 20 (a) seq", job_of(ranks[0], "seq")["algs"],
                      solo, upto=GANG_ROUNDS)
        errs = {}
        for alg in ("CoCoA+", "CoCoA"):
            a0 = ckpt_arrays(d_rank[0], alg, GANG_ROUNDS)
            a1 = ckpt_arrays(d_rank[1], alg, GANG_ROUNDS)
            for name in ("w", "alpha"):
                check(a0[name].tobytes() == a1[name].tobytes(),
                      f"phase 20 (a) {alg}: the ranks' checkpoints differ "
                      f"in {name}")
            want = ckpt_arrays(d_solo, alg, GANG_ROUNDS)
            errs[alg] = [close_arrays(f"phase 20 (a) {alg} {name}",
                                      a0[name], want[name])
                         for name in ("w", "alpha")]
        # the solo process resumes the gang's checkpoint at round 100
        _, resumed = run_cli(longer + [f"--chkptDir={d_rank[0]}",
                                       "--resume"])
        for r, f in zip(resumed, solo):
            want = [x for x in f.trajectory.records if x.round > GANG_ROUNDS]
            check([x.round for x in r.trajectory.records]
                  == [x.round for x in want],
                  f"phase 20 (a) resumed {r.algorithm}: eval rounds")
            for x, y in zip(r.trajectory.records, want):
                check(abs(x.gap - y.gap) <= GANG_REL * y.gap,
                      f"phase 20 (a) resumed {r.algorithm} round {x.round}: "
                      f"{x.gap} vs {y.gap}")
            close_arrays(f"phase 20 (a) resumed {r.algorithm} w",
                         r.w.cpu(), f.w.cpu())
        # launches of each rank against the m-shard prediction: one
        # batched launch over its m shards a round (B1) or a block (B5,
        # B3, B6), as the solo run's over all K
        h = int(0.1 * RCV1_SHAPE[0] / 8)
        blocks = -(-h // 128)
        for r, res in enumerate(ranks):
            c = job_of(res, "seq")["counts"]
            check(c["B1"] == 2 * GANG_ROUNDS and c["D"] == 2 * evals
                  and c["all_reduce"] == reduces,
                  f"phase 20 (a) rank {r}: counts {c}")
            c = job_of(res, "block")["counts"]
            for name in ("B3", "B5", "B6"):
                check(c[name] == 2 * GANG_ROUNDS * blocks
                      == solo_block_counts[name],
                      f"phase 20 (b) rank {r}: {name} {c[name]} launches, "
                      f"predicted {2 * GANG_ROUNDS * blocks}, solo "
                      f"{solo_block_counts[name]}")
            c = job_of(res, "menu")["counts"]
            check(c["B1"] == 3 * 50,
                  f"phase 20 (b) rank {r}: menu B1 {c['B1']} launches")
        close_to_solo("phase 20 (b) block", job_of(ranks[0], "block")["algs"],
                      solo_block)
        close_to_solo("phase 20 (b) menu", job_of(ranks[0], "menu")["algs"],
                      solo_menu)

        # (c): NCCL at one rank, captured, against the runs without --master
        t0 = time.perf_counter()
        cports = [free_port() for _ in range(3)]
        nccl = spawn_gang("c", [{"out": tmp, "jobs": [
            {"tag": "solo", "argv": seq},
            {"tag": "nccl", "argv": seq + gang_flags(cports[0], 0, 1)},
            {"tag": "solo-dl", "argv": seq + ["--deviceLoop"]},
            {"tag": "nccl-dl", "argv": seq + ["--deviceLoop"]
             + gang_flags(cports[1], 0, 1)}],
            "all_reduce": {"master": f"127.0.0.1:{cports[2]}", "rank": 0,
                           "world": 1, "d": RCV1_SHAPE[1],
                           "reps": GANG_REPS["nccl"]}}],
            env_extra={"NCCL_SOCKET_IFNAME": "lo"})[0]
        nccl_s = time.perf_counter() - t0
        check("device group nccl; chunks captured with the all-reduce "
              "inside" in nccl["stdout"], "phase 20 (c): the NCCL gang line")
        for plain, gang in (("solo", "nccl"), ("solo-dl", "nccl-dl")):
            a, b = job_of(nccl, plain), job_of(nccl, gang)
            check([(x["records"], x["w"], x["alpha"]) for x in a["algs"]]
                  == [(x["records"], x["w"], x["alpha"]) for x in b["algs"]],
                  f"phase 20 (c) {gang}: not bit for bit with {plain}")
            check(b["counts"]["all_reduce"] == reduces
                  and a["counts"]["all_reduce"] == 0
                  and b["counts"]["B1"] == a["counts"]["B1"]
                  == 2 * GANG_ROUNDS,
                  f"phase 20 (c) {gang}: counts {b['counts']} "
                  f"({plain}: {a['counts']})")
    ms = {
        "gang gloo (uncaptured)": job_of(ranks[0], "seq")["algs"][0][
            "ms_round"],
        "solo (captured)": steady_ms(solo[0].trajectory),
        "nccl one rank (captured)": job_of(nccl, "nccl")["algs"][0][
            "ms_round"],
        "solo in the (c) process (captured)": job_of(nccl, "solo")["algs"][
            0]["ms_round"]}
    ar = {"gloo 2 ranks": [r["all_reduce"]["ms"] for r in ranks],
          "nccl 1 rank": nccl["all_reduce"]["ms"]}
    out.update(ms_round=ms, all_reduce_ms=ar, ckpt_err=errs,
               seconds={"solo": solo_s, "gang": gang_s, "nccl": nccl_s},
               counts={f"rank{r}": {j["tag"]: j["counts"]
                                    for j in res["jobs"]}
                       for r, res in enumerate(ranks)},
               nccl_counts={j["tag"]: j["counts"] for j in nccl["jobs"]})
    print(f"phase 20 (a): 2 ranks x K=8 (m=4) over gloo on one card, "
          f"rcv1-like {GANG_ROUNDS} rounds: ranks bit for bit, checkpoints "
          f"bit for bit, w/alpha max |diff| to the solo run "
          + ", ".join(f"{a} {e[0]:.2e}/{e[1]:.2e}" for a, e in errs.items())
          + f"; the solo process resumed the gang's file within "
          f"{GANG_REL:g}; {out['draws']}")
    print(f"phase 20 (b): block B5/B3/B6 {2 * GANG_ROUNDS * blocks} "
          f"launches a rank == the m-shard prediction == the solo run's; "
          f"demo menu on 2 ranks within {GANG_REL:g} of the solo run")
    print(f"phase 20 (c): NCCL at one rank, chunked and --deviceLoop "
          f"captured, bit for bit with the runs without --master, "
          f"{reduces} all-reduces a run (a round, an eval, the summary's "
          f"two)")
    print("phase 20 (d): ms per round (CoCoA+, steady): " + ", ".join(
        f"{k} {v:.4f}" for k, v in ms.items())
        + f"; all-reduce of {RCV1_SHAPE[1]} float32 alone: gloo 2 ranks "
        + "/".join(f"{v:.4f}" for v in ar["gloo 2 ranks"])
        + f" ms, nccl 1 rank {ar['nccl 1 rank']:.4f} ms; s: solo runs "
        f"{solo_s:.1f}, gang {gang_s:.1f}, nccl {nccl_s:.1f}; card {card}")
    return out


# --- phase 21: streamed ingest and the slab cache -------------------------

INGEST_ROUNDS = 100
INGEST_DEMO_ROUNDS = 50
INGEST_READ_SHARE = 0.6    # a streamed rank reads under this share: its
#                            pass 2 in a gang of 2, both passes in one of 4


# One process of phase 21 (c): one cli.run of the CLI's own code with the
# gang's flags, its ingest spied on (each shard it built, its report, its
# index scan, and its resident set sampled every 0.5 ms through the
# ingest: CUDA's start-up sets the lifetime peak before any ingest);
# prints "GANG <json>" in phase 20's layout
INGEST_CHILD = r"""
import hashlib, json, os, sys, threading, time
import torch
from cocoa_torch import cli
from cocoa_torch.data import ingest
from cocoa_torch.ops import sparse_sdca as sp
from cocoa_torch.parallel.fanout import all_reduce_sum
from cocoa_torch.utils import prng


def sha(t):
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


spec = json.loads(sys.argv[1])
loaded, scans, grown = [], [], []
ingest_svm, build_index = cli._ingest_svm, ingest.build_index


def rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def spy_ingest(*a, **kw):
    before = rss()
    peak, done = [before], threading.Event()

    def sample():
        while not done.wait(0.0005):
            peak[0] = max(peak[0], rss())

    sampler = threading.Thread(target=sample)
    sampler.start()
    try:
        loaded.append(ingest_svm(*a, **kw))
    finally:
        done.set()
        sampler.join()
    after = rss()
    grown.append((max(peak[0], after) - before, after - before))
    return loaded[-1]


def spy_index(*a, **kw):
    index = build_index(*a, **kw)
    scans.append((index.scan_bytes, index.scan_seconds))
    return index


cli._ingest_svm, ingest.build_index = spy_ingest, spy_index
sp.sparse_sdca_round.launches = prng.draw_tables.launches = 0
all_reduce_sum.calls = 0
t0 = time.perf_counter()
rc, results = cli.run(spec["argv"])
torch.cuda.synchronize()
got = loaded[0]
job = {"tag": spec["tag"], "rc": rc, "wall_s": time.perf_counter() - t0,
       "report": got.reports[0].as_fields(),
       "scan": scans[0] if scans else [0, 0.0],
       "shards": {f: [sha(s) for s in t]
                  for f, t in got.ds.shard_arrays().items()},
       "w": [sha(r.w) for r in results],
       "alpha": [sha(r.alpha) for r in results],
       "peak_rss_bytes": ingest.peak_rss_bytes(),
       "ingest_peak_bytes": grown[0][0],
       "rss_growth_bytes": grown[0][1],
       "counts": {"B1": sp.sparse_sdca_round.launches,
                  "D": prng.draw_tables.launches,
                  "all_reduce": all_reduce_sum.calls}}
print("GANG " + json.dumps({"jobs": [job]}), flush=True)
"""


def ingest_run(argv):
    """cli.run of ``argv`` in this process with its ingest spied on:
    (results, what ``cli._ingest_svm`` built, the pass-1 indexes' (scan
    bytes, seconds)), the counts read around the run."""
    loaded, scans = [], []
    ingest_svm, build_index = cli._ingest_svm, ingest_lib.build_index

    def spy_ingest(*a, **kw):
        loaded.append(ingest_svm(*a, **kw))
        return loaded[-1]

    def spy_index(*a, **kw):
        index = build_index(*a, **kw)
        scans.append((index.scan_bytes, index.scan_seconds))
        return index

    cli._ingest_svm, ingest_lib.build_index = spy_ingest, spy_index
    try:
        _, results = run_cli(argv)
    finally:
        cli._ingest_svm, ingest_lib.build_index = ingest_svm, build_index
    torch.cuda.synchronize()
    return results, loaded[0], scans


def same_shards(label, got, want) -> None:
    fa, fb = got.shard_arrays(), want.shard_arrays()
    check(fa.keys() == fb.keys(), f"{label}: fields {sorted(fa)} vs "
                                  f"{sorted(fb)}")
    for f in fa:
        check(fa[f].dtype == fb[f].dtype and torch.equal(fa[f], fb[f]),
              f"{label}: shard tensor {f} differs")
    check(np.array_equal(got.counts, want.counts), f"{label}: counts")


def same_iterates(label, got, want) -> None:
    for a, b in zip(got, want):
        check(torch.equal(a.w, b.w) and torch.equal(a.alpha, b.alpha),
              f"{label} {a.algorithm}: w or alpha not bit for bit")


def pass2_seconds(loaded, scans) -> float:
    """The train file's pass-2 seconds: its report's less its scan's."""
    return loaded.reports[0].parse_seconds - (scans[0][1] if scans else 0.0)


def phase_ingest(path, card):
    """Phase 21: streamed ingest and the slab cache on the card.  (a) The
    rcv1-like file through cli.run five ways (whole, stream, cache cold,
    cache warm, whole warm from the cache): device shards, w and alpha
    bit for bit; the warm runs read no byte.  (b) --hotCols=auto streamed
    against whole (B1h): the same panel, residual and shards; the demo
    dense streamed (B2) bit for bit, and the demo's hybrid through the
    cache cold and warm.  (c) Two gloo ranks streaming against two
    reading the whole file, then four streaming, as child processes:
    each rank's shards and w bit for bit across the modes, every shard
    of four ranks that of two, the bytes a rank reads, rows tiling n,
    each rank's peak resident set through its ingest.  Returns a summary
    with the launches of its runs."""
    size = os.path.getsize(path)
    rcv1 = [f"--trainFile={path}", f"--numFeatures={RCV1_SHAPE[1]}",
            "--numSplits=8", "--localIterFrac=0.1", "--lambda=1e-4",
            "--math=fast", "--dtype=float32", f"--numRounds={INGEST_ROUNDS}",
            "--debugIter=25"]
    demo = [f"--trainFile={DEMO_TRAIN}", f"--testFile={DEMO_TEST}",
            "--numFeatures=9947", "--numSplits=4",
            f"--numRounds={INGEST_DEMO_ROUNDS}", "--localIterFrac=0.1",
            "--lambda=.001", "--math=fast", "--dtype=float32"]
    out = {"card": card, "file_bytes": size}
    reset_counts()
    prng.draw_tables.launches = 0
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        # (a) five ways in this process
        cache = os.path.join(tmp, "cache")
        runs = {}
        for tag, flags in (("whole", ["--ingest=whole"]),
                           ("stream", ["--ingest=stream"]),
                           ("cold", [f"--ingestCache={cache}"]),
                           ("warm", [f"--ingestCache={cache}"]),
                           ("whole warm", ["--ingest=whole",
                                           f"--ingestCache={cache}"])):
            t0 = time.perf_counter()
            runs[tag] = (*ingest_run(rcv1 + flags),
                         time.perf_counter() - t0)
        ref_res, ref, _, _ = runs["whole"]
        for tag, (res, got, scans, _) in runs.items():
            same_shards(f"phase 21 (a) {tag}", got.ds, ref.ds)
            same_iterates(f"phase 21 (a) {tag}", res, ref_res)
            check_run(res, f"phase 21 (a) {tag}")
        reports = {tag: r[1].reports[0] for tag, r in runs.items()}
        for tag in ("warm", "whole warm"):
            rep = reports[tag]
            check(rep.bytes_read == 0 and rep.cache == "hit"
                  and rep.rows == 0, f"phase 21 (a) {tag}: {rep}")
        check(reports["cold"].cache == "miss"
              and reports["stream"].bytes_read == 2 * size
              and reports["whole"].bytes_read == size,
              f"phase 21 (a): {reports}")
        seconds = {
            "whole parse and build": reports["whole"].parse_seconds,
            "index scan": runs["stream"][2][0][1],
            "pass 2": pass2_seconds(runs["stream"][1], runs["stream"][2]),
            "cold scan + pass 2 + publish": reports["cold"].parse_seconds,
            "warm load": reports["warm"].parse_seconds,
            "whole warm load": reports["whole warm"].parse_seconds}
        out["a"] = {"seconds": seconds,
                    "run_s": {t: r[3] for t, r in runs.items()},
                    "cache_bytes": sum(
                        os.path.getsize(os.path.join(d, f))
                        for d, _, fs in os.walk(cache) for f in fs)}
        del runs, ref, ref_res
        print(f"phase 21 (a): rcv1-like {size} bytes through cli.run "
              f"whole, stream, cache cold, cache warm, whole warm: device "
              f"shards, w and alpha bit for bit; warm runs 0 bytes, cache "
              f"hit; s: " + ", ".join(f"{k} {v:.4f}"
                                       for k, v in seconds.items())
              + f"; artifacts {out['a']['cache_bytes']} bytes; card {card}")

        # (b) the hybrid layout streamed; the demo dense; the demo's
        # hybrid through the cache
        hyb = {tag: ingest_run(rcv1 + ["--hotCols=auto", f"--ingest={tag}"])
               for tag in ("whole", "stream")}
        (w_res, w_got, _), (s_res, s_got, _) = hyb["whole"], hyb["stream"]
        check(s_got.ds.n_hot == w_got.ds.n_hot > 0
              and s_got.ds.sp_indices.shape == w_got.ds.sp_indices.shape
              and s_got.split == w_got.split,
              f"phase 21 (b): panel {s_got.ds.n_hot} vs {w_got.ds.n_hot}, "
              f"residual {tuple(s_got.ds.sp_indices.shape)} vs "
              f"{tuple(w_got.ds.sp_indices.shape)}")
        same_shards("phase 21 (b) hybrid", s_got.ds, w_got.ds)
        check_run(s_res, "phase 21 (b) hybrid stream")
        hyb_bits = all(torch.equal(a.w, b.w) for a, b in zip(s_res, w_res))
        panel, resid = w_got.ds.n_hot, int(w_got.ds.sp_indices.shape[-1])
        del hyb, w_res, w_got, s_res, s_got
        dense = {tag: ingest_run(demo + ["--layout=dense",
                                         f"--ingest={tag}"])
                 for tag in ("whole", "stream")}
        same_shards("phase 21 (b) demo dense", dense["stream"][1].ds,
                    dense["whole"][1].ds)
        same_iterates("phase 21 (b) demo dense", dense["stream"][0],
                      dense["whole"][0])
        del dense
        demo_cache = os.path.join(tmp, "demo_cache")
        dh = [ingest_run(demo + ["--hotCols=auto", *flags])
              for flags in ([], [f"--ingestCache={demo_cache}"],
                            [f"--ingestCache={demo_cache}"])]
        for tag, got in zip(("cold", "warm"), dh[1:]):
            same_shards(f"phase 21 (b) demo hybrid cache {tag}", got[1].ds,
                        dh[0][1].ds)
            same_iterates(f"phase 21 (b) demo hybrid cache {tag}", got[0],
                          dh[0][0])
        check(dh[2][1].reports[0].cache == "hit"
              and dh[2][1].reports[0].bytes_read == 0,
              f"phase 21 (b) demo hybrid warm: {dh[2][1].reports[0]}")
        del dh
        out["b"] = {"panel": panel, "residual": resid,
                    "hybrid_w_bits": hyb_bits}
        launched = dict(counts(), D=prng.draw_tables.launches)
        for name in ("B1", "B1h", "B2"):
            check(launched[name] > 0, f"phase 21: {name} never launched")
        print(f"phase 21 (b): rcv1-like --hotCols=auto streamed == whole "
              f"(panel {panel}, residual {resid}, shards equal; w bit for "
              f"bit {hyb_bits}); demo --layout=dense streamed == whole bit "
              f"for bit (B2); the demo's hybrid through the cache cold and "
              f"warm == uncached bit for bit, warm 0 bytes")

        # (c) two ranks streaming beside two reading the whole file, and
        # four streaming (each reads about a quarter in each pass, so its
        # bytes_read, scan and pass 2, is under 0.6): eight processes
        # started together
        ports = [free_port() for _ in range(3)]
        specs = [{"tag": mode, "argv": rcv1 + [f"--ingest={mode}"]
                  + gang_flags(port, r, 2)}
                 for mode, port in zip(("stream", "whole"), ports)
                 for r in range(2)]
        specs += [{"tag": "stream4", "argv": rcv1 + ["--ingest=stream"]
                   + gang_flags(ports[2], r, 4)} for r in range(4)]
        t0 = time.perf_counter()
        ranks = spawn_gang("ingest", specs, child=INGEST_CHILD, phase=21)
        gang_s = time.perf_counter() - t0
    jobs = [res["jobs"][0] for res in ranks[:4]]
    jobs4 = [res["jobs"][0] for res in ranks[4:]]
    stream_jobs, whole_jobs = jobs[:2], jobs[2:]
    for r, (s_job, w_job) in enumerate(zip(stream_jobs, whole_jobs)):
        check(s_job["shards"] == w_job["shards"] and s_job["w"] == w_job["w"]
              and s_job["alpha"] == w_job["alpha"],
              f"phase 21 (c) rank {r}: stream and whole differ")
        # at two ranks the scan alone reads half the file, so the share
        # held is pass 2's; bytes_read (both passes) is about the file's
        pass2 = s_job["report"]["bytes_read"] - s_job["scan"][0]
        check(0 < pass2 < INGEST_READ_SHARE * size,
              f"phase 21 (c) rank {r}: pass 2 read {pass2} of {size}")
        check(w_job["report"]["bytes_read"] == size,
              f"phase 21 (c) rank {r}: whole read "
              f"{w_job['report']['bytes_read']}")
        check(s_job["counts"]["B1"] == w_job["counts"]["B1"]
              == 2 * INGEST_ROUNDS, f"phase 21 (c) rank {r}: counts "
                                    f"{s_job['counts']}")
    check(stream_jobs[0]["w"] == stream_jobs[1]["w"],
          "phase 21 (c): the streamed ranks' w differ")
    check(sum(j["report"]["rows"] for j in stream_jobs) == RCV1_SHAPE[0],
          "phase 21 (c): the streamed ranks' rows do not tile n")
    for r, job in enumerate(jobs4):
        check(0 < job["report"]["bytes_read"] < INGEST_READ_SHARE * size,
              f"phase 21 (c) rank {r} of 4: read "
              f"{job['report']['bytes_read']} of {size}")
        check(job["w"] == jobs4[0]["w"] and job["counts"]["B1"]
              == 2 * INGEST_ROUNDS, f"phase 21 (c) rank {r} of 4: w differs "
                                    f"or counts {job['counts']}")
    check(sum(j["report"]["rows"] for j in jobs4) == RCV1_SHAPE[0],
          "phase 21 (c): the four streamed ranks' rows do not tile n")
    for f in stream_jobs[0]["shards"]:
        check([h for j in jobs4 for h in j["shards"][f]]
              == [h for j in stream_jobs for h in j["shards"][f]],
              f"phase 21 (c): shard {f} of four ranks differs from two")
    out["c"] = {"gang_s": gang_s, "ranks": [
        {"mode": j["tag"], "bytes_read": j["report"]["bytes_read"],
         "scan_bytes": j["scan"][0], "scan_s": j["scan"][1],
         "parse_seconds": j["report"]["parse_seconds"],
         "rows": j["report"]["rows"],
         "peak_rss_bytes": j["peak_rss_bytes"],
         "ingest_peak_bytes": j["ingest_peak_bytes"],
         "rss_growth_bytes": j["rss_growth_bytes"], "wall_s": j["wall_s"]}
        for j in jobs + jobs4]}
    launched["B1"] += sum(j["counts"]["B1"] for j in jobs + jobs4)
    launched["D"] += sum(j["counts"]["D"] for j in jobs + jobs4)
    out["launched"] = launched
    print("phase 21 (c): 2 ranks x K=8 streamed beside 2 reading the whole "
          "file and 4 streamed beside them, one card over gloo: each rank's "
          "shards, w and alpha bit for bit across the modes, every shard of "
          "4 ranks that of 2; rows " + " + ".join(
              str(j["report"]["rows"]) for j in stream_jobs)
          + f" = {RCV1_SHAPE[0]}; per rank (mode: scan bytes + pass-2 "
          f"bytes of {size}, ingest s, lifetime peak RSS MiB, peak RSS "
          f"above the pre-ingest level MiB, resident growth across the "
          f"ingest MiB): " + "; ".join(
              f"{j['tag']} r{i}: {j['scan'][0]} + "
              f"{j['report']['bytes_read'] - j['scan'][0]}, "
              f"{j['report']['parse_seconds']:.4f} s, "
              f"{j['peak_rss_bytes'] / 2**20:.1f}, "
              f"{j['ingest_peak_bytes'] / 2**20:.1f}, "
              f"{j['rss_growth_bytes'] / 2**20:.1f}"
              for i, j in [(i % 2, j) for i, j in enumerate(jobs)]
              + list(enumerate(jobs4)))
          + f"; the eight children {gang_s:.1f} s; card {card}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("error: chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(exist_ok=True)
    kind = torch.cuda.get_device_name(0)

    # --- phase 1: the card, the build
    print("phase 1: the card (nvidia-smi name, power.limit):")
    card = nvidia_smi()
    print(card)
    start = t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels.SOURCES)) as pool:
        logs = dict(zip(kernels.SOURCES,
                        pool.map(kernels.build, kernels.SOURCES)))
    build_s = time.perf_counter() - t0
    print(f"phase 1: built {', '.join(logs)} in {build_s:.1f} s")
    for name, log in logs.items():
        print(f"  nvcc {name}: " + " | ".join(
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "stack frame" in ln))

    # --- phase 2: kernel vs plain on the card
    demo = load_libsvm(str(DEMO_TRAIN), 9947)
    t0 = time.perf_counter()
    rcv1 = synth_sparse(*RCV1_SHAPE, nnz_mean=75, seed=0)
    print(f"phase 2: rcv1-like data {rcv1.n} x {rcv1.num_features}, "
          f"{int(rcv1.indptr[-1])} nonzeros, max row {rcv1.max_nnz}, made in "
          f"{time.perf_counter() - t0:.1f} s")
    demo_h = max(1, int(0.1 * demo.n / 4))
    rcv1_h = max(1, int(0.1 * rcv1.n / 8))
    wide = synth_sparse(*WIDE_SHAPE[:2], nnz_mean=WIDE_SHAPE[2], seed=2)
    worst_b1, plans2 = phase_kernel_vs_plain({
        "demo": (demo, 4, demo_h, 1e-3),
        "rcv1-like": (rcv1, 8, rcv1_h, 1e-4),
        "wide rows": (wide, 4, 50, 1e-3),
    })
    streamed = {plan[0] for plan, width in plans2 if plan[2] < width}
    check(streamed == {True, False},
          f"B1's rows wider than a slot were not held with dw in both "
          f"placements ({streamed})")
    ms, global_ms, plain_ms, bound_ms, bound_by, n_bytes, nnz = \
        phase_timing(rcv1, 8, rcv1_h, 1e-4)
    demo_ms = phase_timing(demo, 4, demo_h, 1e-3)
    b1_stages = {
        name: stage_timing(shard_dataset(data, k, layout="sparse",
                                         dtype=torch.float32, device="cuda"),
                           k, h, lam)
        for name, data, k, h, lam in (("rcv1-like", rcv1, 8, rcv1_h, 1e-4),
                                      ("demo", demo, 4, demo_h, 1e-3))}
    print(f"phase 2: B1 held at {len(plans2)} plans (dw_in_smem, stages, "
          f"slot, hot_in_regs) by row width: "
          + ", ".join(f"{p} W={w}" for p, w in sorted(plans2)))
    print(f"phase 2: all cases agree (max_abs_err {worst_b1:.3e}); rcv1-like "
          f"f32 plus/hinge round: kernel {ms:.4f} ms (dw in global memory "
          f"{global_ms:.4f} ms), plain {plain_ms:.2f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}: {n_bytes} B, {nnz} nonzeros in "
          f"the distinct sampled rows); demo round: kernel {demo_ms[0]:.4f} ms (dw in "
          f"global memory {demo_ms[1]:.4f} ms), plain {demo_ms[2]:.2f} ms, "
          f"bound {demo_ms[3]:.5f} ms")
    for name, t in b1_stages.items():
        print_stage_timing(f"B1 {name} f32 plus/hinge by plan, frozen last",
                           t, rcv1_h if name == "rcv1-like" else demo_h)

    # --- phase 3: the demo through the CLI, kernel and plain
    demo_argv = [f"--trainFile={DEMO_TRAIN}", f"--testFile={DEMO_TEST}",
                 "--numFeatures=9947", "--numSplits=4", "--numRounds=100",
                 "--localIterFrac=0.1", "--lambda=.001", "--math=fast",
                 "--dtype=float32"]
    sp.sparse_sdca_round.launches = 0
    out, res = run_cli(demo_argv)
    launches = sp.sparse_sdca_round.launches
    demo_seq = res
    (OUT / "chip_smoke_demo.log").write_text(out)
    check(launches == 200, f"demo: {launches} launches for 200 rounds")
    check_run(res, "demo")
    check(res[0].trajectory.records[-1].gap < 1e-2,
          "demo CoCoA+ gap did not reach 1e-2")
    def plain_round(*args, row_len=None, **kw):
        return sp.sparse_sdca_round_plain(*args, **kw)

    with mock.patch.object(cocoa_mod, "sparse_sdca_round", plain_round):
        _, res_plain = run_cli(demo_argv)
    for r, p in zip(res, res_plain):
        for a, b in zip(r.trajectory.records, p.trajectory.records):
            rel = abs(a.gap - b.gap) / abs(b.gap)
            check(rel <= 1e-3, f"demo {r.algorithm} round {a.round}: kernel "
                               f"gap {a.gap} vs plain {b.gap} (rel {rel:.2e})")
    print(f"phase 3: demo ok, {launches} launches for 200 rounds, gaps "
          f"within rel 1e-3 of the plain run")
    bf16 = phase_bf16(demo)
    print("phase 3: bfloat16 demo, --math=fast, 20 rounds, through the "
          "plain versions (no kernel launched; B1 called at bf16 refuses): "
          + "; ".join(f"{label} (round:primal/gap) " + ", ".join(ln)
                      for label, ln in bf16.items()))

    # --- phase 4: the main path, rcv1-like at full width
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "rcv1_like.svm")
    write_libsvm(rcv1, path)
    rcv1_argv = [f"--trainFile={path}", f"--numFeatures={RCV1_SHAPE[1]}",
                 "--numSplits=8", "--localIterFrac=0.1", "--lambda=1e-4",
                 "--math=fast", "--dtype=float32", "--numRounds=200",
                 "--debugIter=25"]
    events = []

    def timed_round(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = sp.sparse_sdca_round(*args, **kw)
        stop.record()
        events.append((start, stop))
        return out

    sp.sparse_sdca_round.launches = 0
    prng.draw_tables.launches = 0
    t0 = time.perf_counter()
    out, res = run_cli(rcv1_argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = sp.sparse_sdca_round.launches
    main_draws = prng.draw_tables.launches
    (OUT / "chip_smoke_rcv1.log").write_text(out)
    check(main_launches == 400,
          f"rcv1-like: {main_launches} launches for 400 rounds")
    check(main_draws == 2 * 200 // 25,
          f"rcv1-like: {main_draws} draw-table launches for 16 chunks")
    check_run(res, "rcv1-like")
    rcv1_seq = res
    for r in res:
        per_round = r.trajectory.records[-1].wall_time / 200 * 1e3
        print(f"  rcv1-like {r.algorithm}: {per_round:.3f} ms per round "
              f"wall clock (evals and the first chunk's capture included); "
              f"graphs captured (branch, rounds): seconds "
              + ", ".join(f"{key}: {sec:.3f}" for key, sec in
                          r.trajectory.graphs.items()))
    # the same command with eager chunks, CUDA events around each wrapper
    # call: the kernel's time on this path (events cannot sit in a graph)
    with mock.patch.object(cocoa_mod, "sparse_sdca_round", timed_round):
        _, res_eager = run_cli(rcv1_argv, capture=False)
    torch.cuda.synchronize()
    path_ms = sum(a.elapsed_time(b) for a, b in events) / len(events)
    check(len(events) == 400, f"rcv1-like eager: {len(events)} launches")
    print(f"phase 4: rcv1-like ok in {wall:.1f} s (load included), "
          f"{main_launches} launches for 400 rounds, {main_draws} of the "
          f"draw kernel; {path_ms:.4f} ms per launch on this path (eager "
          f"chunks, CUDA events around each wrapper call, its alpha copy "
          f"included); phase 2 at this shape: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms per round; eager chunks "
          + ", ".join(f"{r.algorithm} "
                      f"{r.trajectory.records[-1].wall_time / 200 * 1e3:.3f}"
                      for r in res_eager)
          + " ms per round")

    # --- phase 5: the block kernels against their plain versions
    t0 = time.perf_counter()
    eps = synth_dense_sharded(*EPS_SHAPE, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"phase 5: epsilon-like data {eps.n} x {eps.num_features} made on "
          f"the card in {time.perf_counter() - t0:.1f} s")
    worst = {}
    plans5 = phase_block_sparse("demo", demo, 4, demo_h, 1e-3, worst)
    plans5 |= phase_block_sparse("rcv1-like", rcv1, 8, rcv1_h, 1e-4, worst)
    held, chains = phase_block_dense(eps, 1e-3, worst)
    plans5 |= chains
    timing = phase_block_timing(rcv1, eps, held[torch.float32], {})
    print("phase 5: all block cases agree (max_abs_err " + ", ".join(
        f"{n} {e:.3e}" for n, e in sorted(worst.items())) + ")")
    for name, t in sorted(timing.items()):
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        wrapped = (f" (wrapper calls {t['wrapper_ms']:.4f} ms)"
                   if "wrapper_ms" in t else "")
        print(f"  {name}: kernel {t['ms']:.4f} ms{wrapped}, plain "
              f"{t['plain_ms']:.3f} ms, library {lib} ms, bound "
              f"{t['bound'][0]:.5f} ms ({t['bound'][1]})")
    print("  plans held against the plain versions (kernel, dtype, B or W, "
          "plan): " + ", ".join(str(p) for p in sorted(plans5)))
    b3, b5 = timing["B3"], timing["B5"]
    print("  B3 at the split shapes: " + "; ".join(
        f"8 x {b} {b3[f'split{b}_ms']:.4f} ms at plan {b3[f'split{b}_plan']}"
        f", bound {b3[f'split{b}_bound'][0]:.5f} ms"
        for b in (2 * BLOCK, 4 * BLOCK)) + "; rcv1-like block by plan "
        + ", ".join(f"stages={st} {plan[:2]} {ms:.4f}"
                    for st, (plan, ms) in b3["stages_ms"].items())
        + f" ms, frozen mode {b3['frozen_ms']:.4f} ms")
    print(f"  B5: rcv1-like block nonzeros {b5['nnz']:.0f}, auto plan "
          f"(T, slots, bytes) {b5['plan']}; by rows_per_cta " + ", ".join(
              f"{r}: {ms:.4f}" for r, ms in b5["rows_ms"].items())
          + f" ms; float64 {b5['f64_ms']:.4f} ms; the hybrid residual "
          f"{b5['residual_ms']:.4f} ms")
    b6 = timing["B6"]
    print(f"  B6: auto plan (slices, cols, chunk, bytes) {tuple(b6['plan'])}; "
          f"by plan " + ", ".join(
              f"slices={s} {plan[:3]} {ms:.5f}"
              for s, (plan, ms) in b6["slices_ms"].items())
          + f" ms; float64 {b6['f64_ms']:.5f} ms; the hybrid residual "
          f"({b6['residual_nnz']:.0f} entries) {b6['residual_ms']:.5f} ms; "
          f"a hot column in every row {b6['hot_ms']:.5f} ms; the longest "
          f"chain of one column in a shard as drawn {b6['chain']}")
    b4 = timing["B4"]
    print(f"  B4 (epsilon-like 8 x 128 x 2000): auto plan (cluster, width) "
          f"{b4['plan']} {b4['ms']:.4f} ms; by cluster size " + ", ".join(
              f"{c}: {t:.4f}" for c, t in b4["cluster_ms"].items())
          + f" ms; frozen mode (no Gram) {b4['frozen_ms']:.4f} ms; the Gram "
          f"alone as torch.bmm in full float32 {b4['bmm_ms']:.4f} ms; "
          f"cluster sizes held against the plain version: " + "; ".join(
              f"{str(dt)[6:]} {cs}" for dt, cs in held.items()))

    # --- phase 6: the block path through its entry points
    launched, per_round, eps_fused = phase_block_path(
        [("demo", demo_argv, demo_seq, demo_h),
         ("rcv1-like", rcv1_argv, rcv1_seq, rcv1_h)], eps)
    seq_ms = [r.trajectory.records[-1].wall_time / 200 * 1e3
              for r in rcv1_seq]
    print(f"phase 6: rcv1-like ms per round, block path vs sequential "
          f"(evals included): CoCoA+ {per_round['rcv1-like'][0]:.3f} vs "
          f"{seq_ms[0]:.3f}, CoCoA {per_round['rcv1-like'][1]:.3f} vs "
          f"{seq_ms[1]:.3f}")

    # --- phase 7: B2 and B1's prox mode against their plain versions
    t0 = time.perf_counter()
    ln, ld, lk = LASSO_SHAPE
    lasso_ds, lasso_b, lam_max = synth_lasso_columns(ln, ld, lk, seed=0,
                                                     device="cuda")
    tall, tall_b, tall_max = synth_lasso_columns(*TALL_LASSO_SHAPE, seed=1,
                                                 device="cuda")
    eps_h = EPS_SHAPE[0] // EPS_SHAPE[2] // 10
    lasso_h = ld // lk // 10
    f32, f64 = torch.float32, torch.float64
    demo_dense = {dt: shard_dataset(demo, 4, layout="dense", dtype=dt,
                                    device="cuda") for dt in (f32, f64)}
    demo_cols = {dt: shard_columns(demo, 4, dtype=dt, device="cuda",
                                   layout="sparse")[0] for dt in (f32, f64)}
    torch.cuda.synchronize()
    print(f"phase 7: lasso designs {ln} x {ld} and "
          f"{TALL_LASSO_SHAPE[0]} x {TALL_LASSO_SHAPE[1]} and the demo's "
          f"dense and column shards made on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    dual = [(mode, sigma, loss, 1.0) for mode, sigma in MODES
            for loss in LOSSES]
    prox = [("prox", None, "lasso", l2) for l2 in PROX_L2]
    worst7 = {}
    eps_sets = {f32: eps, f64: as_dtype(eps, f64)}
    plans = phase_dense_kernel({
        "demo dense": (demo_dense, demo_h, 1e-3, demo.n, dual),
        "epsilon-like": (eps_sets, eps_h, 1e-3, eps.n, dual),
        "epsilon-like short": (eps_sets, 2, 1e-3, eps.n, dual),
        "epsilon-like odd": (eps_sets, 13, 1e-3, eps.n, dual),
        "lasso design": ({f32: lasso_ds, f64: as_dtype(lasso_ds, f64)},
                         lasso_h, 0.3 * lam_max, 1, prox),
        "tall lasso design": ({f32: tall, f64: as_dtype(tall, f64)}, 40,
                              0.3 * tall_max, 1, prox),
        "demo dense columns": (
            {dt: shard_columns(demo, 4, dtype=dt, device="cuda",
                               layout="dense")[0] for dt in (f32, f64)},
            max(1, int(0.1 * demo.num_features / 4)), 0.1, 1, prox),
    }, worst7)
    del eps_sets
    check(any(h < s for (_, s, _), h in plans.values()),
          "no B2 case with fewer steps than ring slots")
    check(any(s > 1 and h % s for (_, s, _), h in plans.values()),
          "no B2 case whose steps are not a multiple of the ring's depth")
    streamed = {key[1] for key, ((_, _, chunk), _) in plans.items()
                if key[0] == "tall lasso design"
                and chunk < TALL_LASSO_SHAPE[0]}
    check(streamed == {"float32", "float64"},
          f"the tall lasso design's rows were not streamed in chunks in "
          f"both dtypes ({streamed})")
    prox_plans = phase_sparse_prox(
        demo_cols, max(1, int(0.1 * demo.num_features / 4)), 0.1, worst7)
    b2 = {"epsilon-like": dense_timing(eps, eps_h, 1e-3, eps.n, "plus",
                                       "hinge", 1.0, 20),
          "lasso design": dense_timing(lasso_ds, lasso_h, 0.3 * lam_max, 1,
                                       "prox", "lasso", 0.0, 50),
          "demo dense": dense_timing(demo_dense[f32], demo_h, 1e-3, demo.n,
                                     "plus", "hinge", 1.0, 50),
          "demo dense f64": dense_timing(demo_dense[f64], demo_h, 1e-3,
                                         demo.n, "plus", "hinge", 1.0, 50),
          "tall lasso design": dense_timing(tall, 40, 0.3 * tall_max, 1,
                                            "prox", "lasso", 0.0, 20)}
    print(f"phase 7: all B2 and B1-prox cases agree (max_abs_err B2 "
          f"{worst7['B2']:.3e}, B1 prox {worst7['B1']:.3e}); two B2 "
          f"launches, and every plan timed, agree bit for bit; B1 prox "
          f"plans: " + ", ".join(f"{p} W={w}" for p, w in sorted(prox_plans)))
    print("  B2 plans (state_in_smem, stages, chunk) by shape, dtype, state "
          "asked into shared memory, stages asked: " + "; ".join(
              f"{name} {dt} {smem} {asked}: {plan} H={h}"
              for (name, dt, smem, asked), (plan, h) in plans.items()
              if asked is None))
    for name, t in b2.items():
        print(f"  B2 {name}: " + "; ".join(
            f"{plan} {t['plans'][plan]} {ms:.4f} ms "
            f"({ms * 1e3 / t['h']:.3f} us per step)"
            for plan, ms in t["times"].items())
            + f", plain {t['plain_ms']:.2f} ms, bound {t['bound'][0]:.5f} ms "
            f"({t['bound'][1]}: {t['n_bytes']} B, {t['rows']} distinct "
            f"sampled rows)")

    # --- phase 8: the dense sequential path, epsilon-like at full width
    launched8, per_round8 = phase_dense_path(eps, eps_fused)

    # --- phase 9: the new entry points: the menu and the lasso objective
    launched9, _, results9 = phase_entry_points(DEMO_TRAIN, DEMO_TEST)
    launched_lasso, _, lasso_runs = phase_lasso_design(lasso_ds, lasso_b,
                                                       lam_max)
    launched9.update(launched_lasso)

    # --- phase 10: the hybrid hot/cold layout (--hotCols)
    t0 = time.perf_counter()
    rcv1_w, rcv1_split = hybrid.resolve_hot_cols("auto", rcv1, 8, f32)
    demo_w, _ = hybrid.resolve_hot_cols("auto", demo, 4, f32)

    def hybrid_sets(data, k, width):
        return {dt: shard_dataset(data, k, layout="sparse", dtype=dt,
                                  device="cuda", hot_cols=width)
                for dt in (f32, f64)}

    rcv1_hyb = hybrid_sets(rcv1, 8, rcv1_w)
    demo_hyb = hybrid_sets(demo, 4, demo_w)
    demo_full = {dt: column0_panel(ds) for dt, ds in
                 hybrid_sets(demo, 4, demo.num_features).items()}
    torch.cuda.synchronize()
    print(f"phase 10: rcv1-like panel {rcv1_w} columns "
          f"({rcv1_split['coverage'] * 100:.1f}% of the nonzeros, "
          f"{rcv1_hyb[f32].X_hot.numel() * 4 / 1e6:.0f} MB in float32), "
          f"residual width {rcv1_hyb[f32].sp_indices.shape[-1]} (mean nnz "
          f"{rcv1_split['residual_mean_nnz']:.1f}); demo panel {demo_w} "
          f"columns, residual width {demo_hyb[f32].sp_indices.shape[-1]}; "
          f"made on the card in {time.perf_counter() - t0:.1f} s")
    hyb_plans = phase_hybrid_kernel({
        "rcv1-like hybrid": (rcv1_hyb, rcv1_h, 1e-4, rcv1.n, dual),
        "demo hybrid": (demo_hyb, demo_h, 1e-3, demo.n, dual + prox),
        "demo all columns hot, column 0": (
            demo_full, demo_h, 1e-3, demo.n,
            [("plus", None, "hinge", 1.0), ("cocoa", None, "logistic", 1.0)]),
    }, worst)
    check({plan[3] for plan, _ in hyb_plans} == {True, False},
          "B1h was not held with its panel lanes both in registers and "
          "in memory")
    phase_block_sparse("rcv1-like hybrid", rcv1, 8, rcv1_h, 1e-4, worst,
                       hot_cols=rcv1_w)
    ht = hybrid_timing(rcv1, rcv1_hyb[f32], 8, rcv1_h, 1e-4)
    b1h_stages = {"rcv1-like hybrid": stage_timing(rcv1_hyb[f32], 8, rcv1_h,
                                                   1e-4),
                  "demo hybrid": stage_timing(demo_hyb[f32], 4, demo_h,
                                              1e-3)}
    del rcv1_hyb, demo_hyb, demo_full
    print(f"phase 10: all B1h cases agree (max_abs_err {worst['B1h']:.3e}), "
          f"B5/B3/B6 on the residual too; rcv1-like f32 plus/hinge round: "
          f"B1h {ht['ms']:.4f} ms (state in global memory "
          f"{ht['global_ms']:.4f} ms), unsplit B1 {ht['unsplit_ms']:.4f} ms "
          f"on the same draws (in turns), plain {ht['plain_ms']:.2f} ms, "
          f"bound {ht['bound'][0]:.5f} ms ({ht['bound'][1]}: "
          f"{ht['n_bytes']} B, {ht['rows']} distinct sampled rows)")
    print(f"  B1h plans (dw_in_smem, stages, slot, hot_in_regs) held: "
          + ", ".join(f"{p} W={w}" for p, w in sorted(hyb_plans)))
    for name, t in b1h_stages.items():
        print_stage_timing(f"B1h {name} f32 plus/hinge by plan, frozen last",
                           t, rcv1_h if name.startswith("rcv1") else demo_h)
    launched10, per_round10 = phase_hybrid_path(rcv1_argv, rcv1_seq, rcv1_w,
                                                DEMO_TRAIN, DEMO_TEST)
    hyb_seq = per_round10["rcv1-like hybrid sequential"]
    hyb_block = per_round10["rcv1-like hybrid block"]
    print(f"phase 10: rcv1-like ms per round, hybrid vs unsplit (evals "
          f"included): sequential CoCoA+ {hyb_seq[0]:.3f} vs {seq_ms[0]:.3f}, "
          f"CoCoA {hyb_seq[1]:.3f} vs {seq_ms[1]:.3f}; block CoCoA+ "
          f"{hyb_block[0]:.3f} vs {per_round['rcv1-like'][0]:.3f}, CoCoA "
          f"{hyb_block[1]:.3f} vs {per_round['rcv1-like'][1]:.3f}")

    # --- phase 11: ProxCoCoA+ through the block round
    t0 = time.perf_counter()
    designs11 = {
        "lasso design": (lasso_ds, 0.3 * lam_max),
        "tall lasso design": (tall, 0.3 * tall_max),
        "demo dense columns": (shard_columns(
            demo, 4, dtype=f32, device="cuda", layout="dense")[0], 0.1)}
    plans11 = phase_prox_block_kernels(designs11, demo_cols, worst)
    wide_b5 = phase_wide_gram(worst)
    prox_ms = prox_block_timing(designs11, demo_cols)
    print(f"phase 11: B3, B4, B5 and B6 in mode prox/lasso at l2 "
          f"{PROX_L2} agree with their plain versions (max_abs_err "
          + ", ".join(f"{n} {worst[n]:.3e}" for n in ("B3", "B4", "B5",
                                                      "B6"))
          + f"; phases 5, 10 and 11) in {time.perf_counter() - t0:.1f} s; "
          f"two launches of each bit for bit; plans held (kernel, dtype, "
          f"B, n or W, plan): " + ", ".join(str(p) for p in sorted(plans11)))
    print("  B5 at wide rows (K=2 x 128, CUDA-graph replay; plan (T, "
          "slots, chunk, cap, bytes), passes, ms): " + "; ".join(
              f"{dt} W={w} {tuple(plan)} {passes} {ms:.4f}"
              for (dt, w), (plan, passes, ms) in wide_b5.items())
          + "; the widest of each dtype bit for bit across two launches")
    print("  prox/lasso block kernels, float32, ms per launch (B4 by CUDA "
          "events around wrapper calls, B3, B5, B6 by CUDA-graph replay): "
          + "; ".join(f"{name} {ms:.4f}" for name, ms in prox_ms.items()))
    launched11, _ = phase_prox_block_path(
        DEMO_TRAIN, {lay: results9[f"demo lasso {lay}"]
                     for lay in ("dense", "sparse")},
        (lasso_ds, lasso_b, lam_max), lasso_runs, (tall, tall_b, tall_max))
    del tall, designs11

    # --- phase 12: the gap-targeted driver ladder
    t0 = time.perf_counter()
    launched12 = phase_ladder(rcv1, (lasso_ds, lasso_b, lam_max), card)
    print(f"phase 12: all cases ok in {time.perf_counter() - t0:.1f} s")

    # --- phase 13: the captured round loop, the tables made on the card
    t0 = time.perf_counter()
    draw_timing = phase_draw_tables()
    captured13 = phase_captured(rcv1, rcv1_w, eps,
                                (lasso_ds, lasso_b, lam_max))
    retimed = phase_retime(rcv1, demo_argv)
    busy = phase_busy(rcv1, rcv1_w)
    print(f"phase 13: all cases ok in {time.perf_counter() - t0:.1f} s; "
          f"busy shares (device ms / wall ms per round, profiler on): "
          + ", ".join(f"{label} {b['busy'] * 100:.1f} %"
                      for label, b in busy.items())
          + f"; card {card}")
    (OUT / "chip_smoke_phase13.json").write_text(json.dumps({
        "card": card, "draw": draw_timing, "captured": captured13,
        "retimed": retimed, "busy": busy}, default=str))

    # --- phase 14: the device-resident run (--deviceLoop)
    t0 = time.perf_counter()
    loop14 = phase_device_loop(rcv1, rcv1_w, eps,
                               (lasso_ds, lasso_b, lam_max), card)
    print(f"phase 14: all cases ok in {time.perf_counter() - t0:.1f} s; "
          f"busy shares (device ms / wall ms per round, profiler on): "
          + ", ".join(f"{label} {b['busy'] * 100:.1f} %"
                      for label, b in loop14["busy"].items()))
    (OUT / "chip_smoke_phase14.json").write_text(json.dumps(
        {"card": card, **loop14}, default=str))

    # --- phase 15: checkpoints and --resume
    t0 = time.perf_counter()
    resume15 = phase_resume(rcv1, rcv1_w, (lasso_ds, lasso_b, lam_max), card)
    print(f"phase 15: all cases ok in {time.perf_counter() - t0:.1f} s")
    (OUT / "chip_smoke_phase15.json").write_text(json.dumps(resume15,
                                                            default=str))

    # --- phase 16: --blockPipeline, --evalDense, the parser, DistGD, -m
    t0 = time.perf_counter()
    surface16 = phase_surface(rcv1, demo, eps, (lasso_ds, lasso_b, lam_max),
                              card)
    del eps, lasso_ds
    print(f"phase 16: all cases ok in {time.perf_counter() - t0:.1f} s")
    (OUT / "chip_smoke_phase16.json").write_text(json.dumps(surface16,
                                                            default=str))

    # --- phase 17: telemetry on the card
    t0 = time.perf_counter()
    telemetry17 = phase_telemetry(path, card)
    print(f"phase 17: all cases ok in {time.perf_counter() - t0:.1f} s")
    (OUT / "chip_smoke_phase17.json").write_text(json.dumps(telemetry17,
                                                            default=str))

    # --- phase 18: serving on the card
    t0 = time.perf_counter()
    serving18 = phase_serving(path, rcv1, card)
    print(f"phase 18: all cases ok in {time.perf_counter() - t0:.1f} s")
    (OUT / "chip_smoke_phase18.json").write_text(json.dumps(serving18,
                                                            default=str))

    # --- phase 19: fleet training on the card
    t0 = time.perf_counter()
    fleet19 = phase_fleet_training(rcv1, card)
    print(f"phase 19: all cases ok in {time.perf_counter() - t0:.1f} s")
    (OUT / "chip_smoke_phase19.json").write_text(json.dumps(fleet19,
                                                            default=str))

    # --- phase 20: the gang on the card
    t0 = time.perf_counter()
    gang20 = phase_gang(path, demo_argv, card)
    print(f"phase 20: all cases ok in {time.perf_counter() - t0:.1f} s")
    (OUT / "chip_smoke_phase20.json").write_text(json.dumps(gang20,
                                                            default=str))

    # --- phase 21: streamed ingest and the slab cache
    t0 = time.perf_counter()
    ingest21 = phase_ingest(path, card)
    tmp.cleanup()
    print(f"phase 21: all cases ok in {time.perf_counter() - t0:.1f} s")
    (OUT / "chip_smoke_phase21.json").write_text(json.dumps(ingest21,
                                                            default=str))

    block_launches = {name: sum(c[name] for c in (*launched.values(),
                                                  *launched10.values(),
                                                  *launched11.values(),
                                                  *launched12.values()))
                      for name in ("B3", "B4", "B5", "B6")}
    for name, n in block_launches.items():
        check(n > 0, f"{name} never launched on the block path")
    seq_launches = {name: sum(c[name] for c in (*launched8.values(),
                                                *launched9.values(),
                                                *launched12.values()))
                    for name in ("B1", "B2")}
    ladder_launches = {name: sum(c[name] for c in launched12.values())
                       for name in ("B1", "B2", "B3", "B5", "B6")}
    for name, n in ladder_launches.items():
        check(n > 0, f"{name} never launched from a gap-targeted run")
    check(seq_launches["B2"] > 0, "B2 never launched on the main paths")
    hyb_launches = sum(c["B1h"] for c in launched10.values())
    check(hyb_launches > 0, "B1h never launched on the hybrid main path")
    sources = {"B3": ("chain_block_batched", "block_chain",
                      "cocoa_tpu/ops/pallas_chain.py:190"),
               "B4": ("fused_block", "block_chain",
                      "cocoa_tpu/ops/pallas_chain.py:452"),
               "B5": ("sparse_block_gram", "sparse_block",
                      "cocoa_tpu/ops/pallas_sparse.py:773"),
               "B6": ("sparse_block_apply", "sparse_block",
                      "cocoa_tpu/ops/pallas_sparse.py:909")}
    eps_b2 = b2["epsilon-like"]
    rows = [{
        "name": "sparse_sdca_round", "route": "cuda",
        "source": "cocoa_torch/csrc/sparse_sdca.cu",
        "replaces": "cocoa_tpu/ops/pallas_sparse.py:311",
        "launches": main_launches + seq_launches["B1"],
        "max_abs_err": max(worst_b1, worst7["B1"]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}, {
        "name": "sparse_sdca_hybrid", "route": "cuda",
        "source": "cocoa_torch/csrc/sparse_sdca.cu",
        "replaces": "cocoa_tpu/ops/pallas_sparse.py:311",
        "launches": hyb_launches, "max_abs_err": worst["B1h"],
        "ms": ht["ms"], "plain_ms": ht["plain_ms"],
        "bound_ms": ht["bound"][0], "bound_by": ht["bound"][1],
        "library_ms": None}, {
        "name": "dense_sdca_round", "route": "cuda",
        "source": "cocoa_torch/csrc/dense_sdca.cu",
        "replaces": "cocoa_tpu/ops/pallas_sdca.py:328",
        "launches": seq_launches["B2"], "max_abs_err": worst7["B2"],
        "ms": eps_b2["ms"], "plain_ms": eps_b2["plain_ms"],
        "bound_ms": eps_b2["bound"][0], "bound_by": eps_b2["bound"][1],
        "library_ms": None}]
    for name, (fn, src, tpu) in sources.items():
        t = timing[name]
        rows.append({
            "name": fn, "route": "cuda", "source": f"cocoa_torch/csrc/{src}.cu",
            "replaces": tpu, "launches": block_launches[name],
            "max_abs_err": worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"]})
    draw = draw_timing["rcv1-like"]["reference"]
    draw_launches = main_draws + sum(c["draws"] for c in
                                     captured13.values())
    check(draw_launches > 0, "the draw kernel never launched on a main path")
    rows.append({
        "name": "draw_tables", "route": "cuda",
        "source": "cocoa_torch/csrc/draw_tables.cu",
        "replaces": "cocoa_tpu/solvers/base.py:1571 (XLA, not a Pallas "
                    "kernel)",
        "launches": draw_launches, "max_abs_err": 0.0, "ms": draw["ms"],
        "plain_ms": draw["plain_ms"], "bound_ms": draw["bound"][0],
        "bound_by": draw["bound"][1], "library_ms": None})
    # the device loop's runs (phase 14), the resumed runs (phase 15) and
    # phase 16's runs are main-path runs of these slices
    for row, name in zip(rows, ("B1", "B1h", "B2", "B3", "B4", "B5", "B6",
                                "D")):
        row["launches"] += loop14["launched"][name] + \
            resume15["launched"][name] + surface16["launched"][name] + \
            telemetry17["launched"][name]
    # phase 20's processes count their own launches, job by job
    gang_counts = [job for rank in gang20["counts"].values()
                   for job in rank.values()] + list(
        gang20["nccl_counts"].values())
    launched20 = {name: sum(j[name] for j in gang_counts)
                  for name in ("B1", "B3", "B5", "B6", "D")}
    for row, name in zip(rows, ("B1", "B1h", "B2", "B3", "B4", "B5", "B6",
                                "D")):
        row["launches"] += launched20.get(name, 0) + \
            ingest21["launched"].get(name, 0)
    print("phase 21 launches (in-process runs and the gang's children), in "
          "the counts below: " + ", ".join(
              f"{name} {v}" for name, v in ingest21["launched"].items()))
    print(f"phase 20 launches (the gang's and the NCCL child's processes), "
          f"in the counts below: " + ", ".join(
              f"{name} {v}" for name, v in launched20.items()))
    print(f"phase 14 device-loop launches, in the counts below: " + ", ".join(
        f"{name} {v}" for name, v in loop14["launched"].items()))
    print(f"phase 15 launches (in-process runs), in the counts below: "
          + ", ".join(f"{name} {v}"
                      for name, v in resume15["launched"].items()))
    print(f"phase 16 launches (in-process runs), in the counts below: "
          + ", ".join(f"{name} {v}"
                      for name, v in surface16["launched"].items()))
    print(f"phase 17 launches (in-process runs), in the counts below: "
          + ", ".join(f"{name} {v}"
                      for name, v in telemetry17["launched"].items()))
    print(f"main-path launches: B1 {rows[0]['launches']} (phase 4 "
          f"{main_launches}, phases 9 and 12 {seq_launches['B1']}), B1h "
          f"{hyb_launches} (phase 10), B2 {seq_launches['B2']} (phases 8, "
          f"9 and 12); phase 12 alone: " + ", ".join(
              f"{name} {n}" for name, n in ladder_launches.items())
          + "; B3-B6 " + ", ".join(
              f"{name} {n} (phase 11: "
              f"{sum(c[name] for c in launched11.values())})"
              for name, n in block_launches.items())
          + f"; the draw kernel {draw_launches} (phase 4 {main_draws}, "
          f"phase 13 captured runs {draw_launches - main_draws})")
    # the card once more, near the end of the output
    print(f"card (nvidia-smi name, power.limit): {card}; kernels built in "
          f"{build_s:.1f} s; all phases in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
