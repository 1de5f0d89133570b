"""Command-line driver (counterpart of cocoa_tpu/cli.py ``parse_args`` /
``main``; reference hingeDriver.scala:11-115).

    python -m cocoa_torch.cli --trainFile=... --testFile=... \\
        --numFeatures=... --numSplits=K --numRounds=T --localIterFrac=... \\
        --lambda=... [--justCoCoA=true] [--math=exact|fast] \\
        [--dtype=float32|float64] [--layout=auto|dense|sparse] \\
        [--rng=reference|jax|permuted] [--debugIter=.. --seed=.. --beta=..
        --gamma=.. --sigma=<float> --loss=hinge|smooth_hinge|logistic
        --smoothing=..] [--device=cuda|cpu] [--blockSize=<int>|auto]

Runs CoCoA+ and then CoCoA with the K shards batched on one device and
prints the reference's round and summary lines.  It runs on CUDA unless
``--device=cpu`` is given, and exits 2 with ``error: ...`` when CUDA is
absent.  ``--blockSize`` (with ``--math=fast``) runs each round as the
block-coordinate round; ``auto`` picks the block size for the layout.
Flags of the JAX CLI that this port does not support yet exit 2
with ``error: --X is not yet ported to cocoa_torch (ROADMAP Queue A)``.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import NamedTuple

import torch

from cocoa_torch.config import REFERENCE_FLAGS, RunConfig
from cocoa_torch.data import load_libsvm, shard_dataset
from cocoa_torch.device import resolve_device
from cocoa_torch.evals import objectives
from cocoa_torch.ops import losses
from cocoa_torch.solvers import run_cocoa
from cocoa_torch.solvers.cocoa import auto_block_size
from cocoa_torch.utils.logging import Trajectory

_PORT_FLAGS = {f: f for f in ("dtype", "layout", "rng", "math", "loss",
                               "smoothing", "sigma", "device")}
_PORT_FLAGS["blockSize"] = "block_size"
# flags of the JAX CLI that this port does not accept yet
_NOT_PORTED = (
    "chkptDir", "sampling", "mesh", "fp", "trajOut", "gapTarget", "resume",
    "scanChunk", "deviceLoop", "master", "processId", "numProcesses",
    "profile", "objective", "l2", "blockPipeline",
    "divergenceGuard", "sigmaSchedule", "warmStart", "accel", "theta",
    "elastic", "stallTimeout", "evalDense", "hotCols", "ingest",
    "ingestCache", "metrics", "events", "quiet", "trace", "flightRecorder",
    "eventsMaxMB", "metricsInterval", "overlapComm", "staleRounds", "fleet",
    "fleetLanes", "serve", "serveBatch", "serveSlaMs", "serveMaxNnz",
    "serveDtype", "serveReplicas", "serveRoute", "traceSample",
    "statusPort")

_BOOL_FIELDS = {"just_cocoa"}
_INT_FIELDS = {"num_features", "num_splits", "chkpt_iter", "num_rounds",
               "debug_iter", "seed"}
_FLOAT_FIELDS = {"lam", "local_iter_frac", "beta", "gamma", "smoothing",
                 "sigma"}
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


class RunResult(NamedTuple):
    algorithm: str
    w: torch.Tensor
    alpha: torch.Tensor
    trajectory: Trajectory


def parse_args(argv: list[str]):
    """--key=value (a bare --flag means true, hingeDriver.scala:13-19).
    Returns (RunConfig, the flags given that are not ported yet)."""
    cfg = RunConfig()
    unported = []
    for arg in argv:
        stripped = arg.lstrip("-")
        key, val = (stripped.split("=", 1) if "=" in stripped
                    else (stripped, "true"))
        if key in _NOT_PORTED:
            unported.append(key)
            continue
        if key in REFERENCE_FLAGS:
            field = REFERENCE_FLAGS[key]
        elif key in _PORT_FLAGS:
            field = _PORT_FLAGS[key]
        else:
            raise SystemExit(f"Invalid argument: --{key}")
        if field in _BOOL_FIELDS:
            if val.lower() not in ("true", "false"):
                raise SystemExit(
                    f"Invalid argument: --{key}={val} (expected true/false)")
            setattr(cfg, field, val.lower() == "true")
        elif field in _INT_FIELDS:
            setattr(cfg, field, int(val))
        elif field in _FLOAT_FIELDS:
            if field == "sigma" and val == "auto":
                unported.append("sigma=auto")
                continue
            setattr(cfg, field, float(val))
        else:
            setattr(cfg, field, val)
    if not cfg.just_cocoa:
        unported.append("justCoCoA=false")
    return cfg, unported


def _check_choices(cfg: RunConfig):
    """The flag values the run needs, checked before any data is read."""
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"--dtype must be one of {tuple(_DTYPES)}, got "
                         f"{cfg.dtype!r}")
    if cfg.layout not in ("auto", "dense", "sparse"):
        raise ValueError(f"--layout must be auto|dense|sparse, got "
                         f"{cfg.layout!r}")
    if cfg.rng not in ("reference", "jax", "permuted"):
        raise ValueError(f"--rng must be reference|jax|permuted, got "
                         f"{cfg.rng!r}")
    if cfg.math not in ("exact", "fast"):
        raise ValueError(f"--math must be exact|fast, got {cfg.math!r}")
    if cfg.num_splits < 1:
        raise ValueError(f"--numSplits must be >= 1, got {cfg.num_splits}")
    losses.validate(cfg.loss, cfg.smoothing)


def _block_size(cfg: RunConfig) -> int:
    """``--blockSize`` as an int (0 for off or auto), with the JAX CLI's
    checks and messages (cocoa_tpu/cli.py:1611-1627)."""
    auto = cfg.block_size.lower() == "auto"
    if auto or not cfg.block_size:
        size = 0
    else:
        try:
            size = int(cfg.block_size)
        except ValueError:
            raise ValueError(f"--blockSize must be an integer or 'auto', got "
                             f"{cfg.block_size!r}") from None
    if size < 0:
        raise ValueError(f"--blockSize must be >= 0, got {size}")
    if (size or auto) and cfg.math != "fast":
        raise ValueError("--blockSize requires --math=fast (the block kernel "
                         "is a margins-decomposition variant)")
    return size


def run(argv: list[str]) -> tuple[int, list[RunResult]]:
    """The CLI's work: (exit code, one RunResult per algorithm run)."""
    cfg, unported = parse_args(argv)
    if unported:
        print(f"error: --{unported[0]} is not yet ported to cocoa_torch "
              f"(ROADMAP Queue A)", file=sys.stderr)
        return 2, []
    try:
        device = resolve_device(cfg.device)
        _check_choices(cfg)
        block_size = _block_size(cfg)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2, []

    # echo flags, as the reference does (hingeDriver.scala:41-48)
    for f in dataclasses.fields(cfg):
        print(f"{f.name}: {getattr(cfg, f.name)}")

    dtype = _DTYPES[cfg.dtype]
    k = cfg.num_splits
    try:
        data = load_libsvm(cfg.train_file, cfg.num_features)
        ds = shard_dataset(data, k=k, layout=cfg.layout, dtype=dtype,
                           device=device)
        test_ds = None
        if cfg.test_file:
            test_ds = shard_dataset(
                load_libsvm(cfg.test_file, cfg.num_features), k=k,
                layout=cfg.layout, dtype=dtype, device=device)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2, []

    if cfg.block_size.lower() == "auto":
        block_size = auto_block_size(ds, dtype)
        print(f"blockSize=auto: using {block_size or 'the sequential path'} "
              f"for the {ds.layout} layout")
    params = cfg.to_params(data.n, k)
    debug = cfg.to_debug()
    results = []
    for plus in (True, False):   # hingeDriver.scala:84-89
        try:
            w, alpha, traj = run_cocoa(ds, params, debug, plus=plus,
                                       test_ds=test_ds, rng=cfg.rng,
                                       math=cfg.math, block_size=block_size)
        except (ValueError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2, results
        traj.summary(*objectives.evaluate(
            ds, w, alpha, params.lam, test_ds=test_ds, loss=params.loss,
            smoothing=params.smoothing))
        results.append(RunResult(traj.algorithm, w, alpha, traj))
    return 0, results


def main(argv=None) -> int:
    return run(sys.argv[1:] if argv is None else argv)[0]


if __name__ == "__main__":
    sys.exit(main())
