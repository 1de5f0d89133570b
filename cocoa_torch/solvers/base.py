"""Shared solver machinery (counterpart of parts of
cocoa_tpu/solvers/base.py): the shard check, the index sampler (host
tables), the chunk size and the chunked round loop."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from cocoa_torch.config import DebugParams, Params
from cocoa_torch.data.sharding import ShardedDataset
from cocoa_torch.utils import prng
from cocoa_torch.utils.logging import Trajectory


def check_shards(ds: ShardedDataset) -> None:
    """Reject empty shards up front (the reference crashes inside the task
    on ``nextInt(0)`` when numSplits > rows)."""
    if np.any(ds.counts <= 0):
        raise ValueError(
            f"every shard needs at least one example; shard sizes are "
            f"{ds.counts.tolist()} (n={ds.n} over K={ds.k} shards) -- "
            f"lower numSplits")


class IndexSampler:
    """Per-round local-coordinate draws, (C, K, H) int32 tables built on
    the host for a chunk of rounds (see utils/prng.py for the modes)."""

    MODES = ("reference", "jax", "permuted")

    def __init__(self, mode: str, seed: int, h: int, counts):
        if mode not in self.MODES:
            raise ValueError(
                f"rng mode must be one of {self.MODES}, got {mode!r}")
        self.mode = mode
        self.seed = seed
        self.h = h
        self.counts = np.asarray(counts)
        if np.any(self.counts <= 0):
            raise ValueError(
                f"all shards must be non-empty, got sizes {self.counts}")

    def chunk_indices(self, t0: int, c: int) -> torch.Tensor:
        """Tables for rounds t0..t0+c-1 (1-based, as the reference)."""
        if self.mode == "reference":
            tab = prng.sample_indices_per_shard(
                self.seed, range(t0, t0 + c), self.h, self.counts)
            return torch.from_numpy(np.ascontiguousarray(
                np.swapaxes(tab, 0, 1)))
        ts = torch.arange(t0, t0 + c, dtype=torch.int64)
        if self.mode == "permuted":
            return prng.permuted_tables(self.seed, ts, self.h, self.counts)
        return prng.hash_tables(self.seed, ts, self.h, self.counts)

    def round_indices(self, t: int) -> torch.Tensor:
        return self.chunk_indices(t, 1)[0]


def chunk_rounds(debug: DebugParams, k: int, h: int) -> int:
    """Rounds per chunk: a chunk ends at each eval, and is capped so one
    chunk's (C, K, H) table stays modest when debugIter is large."""
    cap = max(1, 32_000_000 // max(1, k * h))
    return min(debug.debug_iter if debug.debug_iter > 0 else 50, cap)


def drive(name: str, params: Params, debug: DebugParams, state: tuple,
          round_fn: Callable[[tuple, torch.Tensor, int], tuple],
          eval_fn: Callable[[tuple], tuple], sampler, device, chunk: int,
          quiet: bool = False, start_round: int = 1):
    """The outer loop (CoCoA.scala:39-63 skeleton).  Rounds run in chunks
    that end at each ``debugIter`` boundary: a chunk's (C, K, H) index
    table is built on the host and copied to ``device`` once, the rounds
    run as a Python loop of device work, and the host reads the device
    only at the evaluations.  ``round_fn(state, idxs_kh, t) -> state``
    for round t (1-based); ``sampler`` None gives ``idxs_kh`` None (a
    solver without draws, DistGD).  ``eval_fn(state) -> (primal, gap,
    test_error)``.  Returns (state, Trajectory)."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    traj = Trajectory(name, quiet=quiet)
    t = start_round
    total = params.num_rounds
    di = debug.debug_iter
    while t <= total:
        end = min(total, t + chunk - 1)
        if di > 0:
            end = min(end, ((t - 1) // di + 1) * di)
        tables = ([None] * (end - t + 1) if sampler is None
                  else sampler.chunk_indices(t, end - t + 1).to(device))
        for r, idxs_kh in enumerate(tables, start=t):
            state = round_fn(state, idxs_kh, r)
        t = end + 1
        if di > 0 and end % di == 0:
            primal, gap, test_err = eval_fn(state)
            traj.log_round(end, primal=primal, gap=gap, test_error=test_err)
    return state, traj
