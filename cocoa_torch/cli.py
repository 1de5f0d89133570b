"""Command-line driver (counterpart of cocoa_tpu/cli.py ``parse_args`` /
``main``; reference hingeDriver.scala:11-115).

    python -m cocoa_torch.cli --trainFile=... --testFile=... \\
        --numFeatures=... --numSplits=K --numRounds=T --localIterFrac=... \\
        --lambda=... [--justCoCoA=true] [--math=exact|fast] \\
        [--dtype=float32|float64] [--layout=auto|dense|sparse] \\
        [--rng=reference|jax|permuted] [--sampling=auto|device|host]
        [--scanChunk=<int>] [--deviceLoop] [--debugIter=.. --seed=.. --beta=..
        --gamma=.. --sigma=<float> --loss=hinge|smooth_hinge|logistic
        --smoothing=..] [--device=cuda|cpu] [--blockSize=<int>|auto]
        [--objective=svm|lasso --l2=<float>] [--hotCols=auto|off|<n>]
        [--gapTarget=<float> --divergenceGuard=auto|on|off
        --sigma=auto --sigmaSchedule=anneal|trial --warmStart=<s>,<rounds>
        --accel=auto|on|off --theta=fixed|adaptive] [--trajOut=P] [--quiet]
        [--chkptDir=D --chkptIter=<int> [--resume]]
        [--blockPipeline=auto|on|off] [--evalDense[=auto|true|false]]

    python -m cocoa_torch <the same flags>

Runs CoCoA+ and then CoCoA with the K shards batched on one device and
prints the reference's round and summary lines; ``--justCoCoA=false``
then runs the rest of the reference's comparison (hingeDriver.scala:
84-110): mini-batch CD, mini-batch SGD, local SGD and DistGD.
``--objective=lasso`` runs ProxCoCoA+ instead, on the labels as the
regression target with the L1 weight ``--lambda`` and the elastic-net
weight ``--l2``, on the column shards.  It runs on CUDA unless
``--device=cpu`` is given, and exits 2 with ``error: ...`` when CUDA is
absent.  Rounds run in chunks of ``--scanChunk`` (default: the eval
cadence), each chunk on the card one replayed CUDA graph, with its index
tables made on the card (``--sampling=auto``, wherever they are exact;
``host`` builds them on the host and copies them over).
``--deviceLoop`` (bare, or any value but ``false``; needs
``--debugIter`` > 0) runs the evals, the stop test and the driver
ladder on the card too, and reads the card once a super-block of evals
(solvers/base.py ``drive_device``).
``--blockSize`` (with ``--math=fast``) runs each SDCA round,
ProxCoCoA+'s too, as the block-coordinate round; ``auto`` picks the block
size for the layout, and ``--blockPipeline`` (needs ``--blockSize``
unless ``auto``, the default: on when a round spans more than one
block) gathers the next block's rows on a second stream while a block's
kernel runs (dense rows and dense columns).  ``--evalDense`` (sparse
layout) gives the evals a dense twin of the rows; ``auto`` takes it when
it fits a 2 GiB budget and prints its decision.  ``--hotCols`` (sparse layout,
``--objective=svm``) builds the hybrid hot/cold column split
(data/hybrid.py): the hottest columns move into a dense panel and the
padded CSR keeps the cold residual; ``auto`` takes the panel that covers
75% of the nonzeros within a 2 GiB budget.

The driver ladder, as in the JAX CLI: ``--gapTarget=<float>`` stops a
run at the first eval whose duality gap is at or below it;
``--divergenceGuard=auto|on|off`` arms the stall watch's bail-out (auto:
only at a sigma' below K*gamma); ``--sigma=auto`` with
``--sigmaSchedule=anneal|trial`` starts CoCoA+ at K*gamma/2;
``--warmStart=<s>,<rounds>`` runs smooth_hinge(s) first;
``--accel=auto|on|off`` and ``--theta=fixed|adaptive`` the accelerated
outer loop (auto: on for gap-targeted CoCoA+); ``--trajOut=P`` writes
``P.<algorithm>.jsonl`` after each summary; ``--quiet`` silences the
console.

``--chkptDir=D`` saves each algorithm's state every ``--chkptIter``
rounds into ``D`` in the JAX package's checkpoint format
(cocoa_torch/checkpoint.py; the device loop at its super-block
boundaries); ``--resume`` (needs ``--chkptDir``) starts each algorithm
from its newest healthy checkpoint there, printing ``resuming <alg> from
round <r> (<path>)``.  Flags of the JAX CLI that this port does not
support yet exit 2 with ``error: --X is not yet ported to cocoa_torch
(ROADMAP Queue A)``.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from cocoa_torch import checkpoint
from cocoa_torch.config import REFERENCE_FLAGS, RunConfig
from cocoa_torch.data import hybrid, load_libsvm, shard_dataset
from cocoa_torch.data.columns import shard_columns
from cocoa_torch.data.sharding import eval_dense_fits, resolve_layout
from cocoa_torch.device import resolve_device
from cocoa_torch.evals import objectives
from cocoa_torch.ops import losses
from cocoa_torch.solvers import run_cocoa
from cocoa_torch.solvers.cocoa import auto_block_size
from cocoa_torch.solvers.dist_gd import run_dist_gd
from cocoa_torch.solvers.minibatch_cd import run_minibatch_cd
from cocoa_torch.solvers.prox_cocoa import lasso_metrics, run_prox_cocoa
from cocoa_torch.solvers.sgd import run_sgd
from cocoa_torch.utils.logging import Trajectory, config_hash

_PORT_FLAGS = {f: f for f in ("dtype", "layout", "rng", "math", "loss",
                               "smoothing", "sigma", "device", "objective",
                               "l2", "quiet", "accel", "theta", "sampling")}
_PORT_FLAGS.update(blockSize="block_size", hotCols="hot_cols",
                   scanChunk="scan_chunk", deviceLoop="device_loop",
                   gapTarget="gap_target", divergenceGuard="divergence_guard",
                   trajOut="traj_out", sigmaSchedule="sigma_schedule",
                   warmStart="warm_start", resume="resume",
                   blockPipeline="block_pipeline", evalDense="eval_dense")
# flags of the JAX CLI that this port does not accept yet
_NOT_PORTED = (
    "mesh", "fp", "master", "processId", "numProcesses",
    "profile", "elastic", "stallTimeout", "ingest",
    "ingestCache", "metrics", "events", "trace", "flightRecorder",
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
    """One algorithm's result.  ProxCoCoA+ returns its residual r = Ax - b
    as ``w`` and its coordinates x as ``alpha``; the SGD and DistGD
    baselines have no ``alpha`` (None)."""

    algorithm: str
    w: torch.Tensor
    alpha: Optional[torch.Tensor]
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
            setattr(cfg, field, "auto" if field == "sigma" and val == "auto"
                    else float(val))
        else:
            setattr(cfg, field, val)
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


def _block_pipeline(cfg: RunConfig, block_size: int) -> Optional[bool]:
    """``--blockPipeline`` as the solvers' ``block_pipeline`` (None auto,
    True on, False off), with the JAX CLI's checks and messages
    (cocoa_tpu/cli.py:1634-1643): ``auto`` needs no ``--blockSize``."""
    bp = (cfg.block_pipeline or "auto").lower()
    if bp not in ("auto", "on", "off"):
        raise ValueError(f"--blockPipeline must be auto|on|off, got "
                         f"{cfg.block_pipeline!r}")
    if bp != "auto" and not (block_size
                             or cfg.block_size.lower() == "auto"):
        raise ValueError("--blockPipeline controls the block-coordinate "
                         "scan schedule and needs --blockSize")
    return None if bp == "auto" else bp == "on"


def _objective(cfg: RunConfig):
    """(objective, l2) with the JAX CLI's checks and messages
    (cocoa_tpu/cli.py:1101-1105,1664-1681)."""
    objective = (cfg.objective or "svm").lower()
    if objective not in ("svm", "lasso"):
        raise ValueError(f"--objective must be svm|lasso, got {objective!r}")
    if objective == "svm":
        return objective, 0.0
    if cfg.hot_cols is not None:
        raise ValueError("--hotCols does not apply to --objective=lasso "
                         "(column shards already partition the feature "
                         "axis)")
    if cfg.test_file:
        raise ValueError("--testFile does not apply to --objective=lasso "
                         "(no classification error to report)")
    try:
        l2 = float(cfg.l2) if cfg.l2 else 0.0
    except ValueError:
        raise ValueError(f"--l2 must be a float, got {cfg.l2!r}") from None
    if l2 < 0.0:
        raise ValueError(f"--l2 is the elastic-net weight, needs >= 0, "
                         f"got {l2}")
    return objective, l2


def _scan_chunk(cfg: RunConfig) -> None:
    """``--scanChunk`` as an int, with the JAX CLI's message
    (cocoa_tpu/cli.py:1583-1589); absent, the solvers take the eval
    cadence (solvers/base.py ``chunk_rounds``)."""
    if cfg.scan_chunk is None:
        return
    try:
        cfg.scan_chunk = int(cfg.scan_chunk)
    except ValueError:
        raise ValueError(f"--scanChunk must be an integer, got "
                         f"{cfg.scan_chunk!r}") from None


def _quiet(cfg: RunConfig) -> bool:
    return cfg.quiet is not None and cfg.quiet.lower() != "false"


def _device_loop(cfg: RunConfig) -> bool:
    """``--deviceLoop`` with the JAX CLI's rule and message
    (cocoa_tpu/cli.py:1579-1603): on unless its value is ``false``, and
    only with an eval cadence."""
    on = cfg.device_loop is not None and cfg.device_loop.lower() != "false"
    if on and cfg.debug_iter <= 0:
        raise ValueError("--deviceLoop requires --debugIter > 0 (the eval "
                         "cadence is the device loop's chunk axis)")
    return on


def _resume(cfg: RunConfig) -> bool:
    """``--resume`` with the JAX CLI's rule and message
    (cocoa_tpu/cli.py:1607-1610): on unless its value is ``false``, and
    only with a checkpoint directory."""
    on = cfg.resume is not None and cfg.resume.lower() != "false"
    if on and not cfg.chkpt_dir:
        raise ValueError("--resume requires --chkptDir")
    return on


def _restore(cfg: RunConfig, algorithm: str, resume: bool) -> dict:
    """The keywords that resume ``algorithm`` from its newest healthy
    checkpoint, as the JAX CLI's ``restore`` (cocoa_tpu/cli.py:1727-1757):
    ``w_init``, ``start_round``, and ``alpha_init``, ``sched_init`` and
    ``hist_init`` where the checkpoint has them; none without ``--resume``
    or a checkpoint."""
    if not resume:
        return {}
    path = checkpoint.latest(cfg.chkpt_dir, algorithm)
    if path is None:
        return {}
    meta, arrays = checkpoint.load_full(path)
    print(f"resuming {algorithm} from round {meta['round']} ({path})")
    out = dict(w_init=arrays["w"], start_round=meta["round"] + 1)
    if arrays.get("alpha") is not None:
        out["alpha_init"] = arrays["alpha"]
    if meta.get("sched") is not None:
        out["sched_init"] = np.asarray(meta["sched"], np.float32)
    if arrays.get("hist") is not None:
        out["hist_init"] = arrays["hist"]
    return out


def _ladder(cfg: RunConfig) -> dict:
    """The driver ladder's flags resolved, with the JAX CLI's checks and
    messages (cocoa_tpu/cli.py:650-735, 1569-1577, 1645-1657): the
    keywords of ``run_cocoa`` (gap_target, divergence_guard,
    sigma_schedule, warm_start, accel, theta)."""
    gap = cfg.gap_target
    if cfg.sigma == "auto" and not gap:
        raise ValueError("--sigma=auto requires --gapTarget (the σ′ fallback "
                         "triggers on the divergence guard, which runs on the "
                         "gap-target path)")
    schedule = cfg.sigma_schedule
    if schedule is not None and schedule not in ("trial", "anneal"):
        raise ValueError(f"--sigmaSchedule must be trial|anneal, got "
                         f"{schedule!r}")
    if schedule == "trial" and cfg.sigma != "auto":
        raise ValueError("--sigmaSchedule=trial is the --sigma=auto A/B "
                         "control and needs --sigma=auto")
    anneal_engages = (cfg.sigma == "auto"
                      or (isinstance(cfg.sigma, float)
                          and 0 < cfg.sigma < cfg.num_splits * cfg.gamma))
    if schedule == "anneal" and anneal_engages and not gap:
        raise ValueError("--sigmaSchedule=anneal requires --gapTarget (the "
                         "in-loop backoff triggers on the stall watch, which "
                         "runs on the gap-target path)")
    accel = (cfg.accel or "auto").lower()
    if accel not in ("auto", "on", "off"):
        raise ValueError(f"--accel must be auto|on|off, got {cfg.accel!r}")
    theta = (cfg.theta or "fixed").lower()
    if theta not in ("fixed", "adaptive"):
        raise ValueError(f"--theta must be fixed|adaptive, got "
                         f"{cfg.theta!r}")
    if accel == "on" and not gap:
        raise ValueError("--accel=on requires --gapTarget (the momentum "
                         "restart rule monitors the gap trajectory; "
                         "fixed-round benchmark runs stay unaccelerated)")
    if accel == "on" and schedule == "trial":
        raise ValueError("--accel cannot ride --sigmaSchedule=trial (the "
                         "trial is the bit-exact A/B control); use "
                         "--sigmaSchedule=anneal")
    if theta == "adaptive" and (accel == "off" or schedule == "trial"
                                or not gap):
        raise ValueError("--theta=adaptive requires an accelerated "
                         "gap-targeted run (--accel=auto|on with --gapTarget, "
                         "not --sigmaSchedule=trial)")
    warm = None
    if cfg.warm_start:
        parts = cfg.warm_start.split(",")
        try:
            if len(parts) != 2:
                raise ValueError
            warm = (float(parts[0]), int(parts[1]))
        except ValueError:
            raise ValueError(f"--warmStart takes <smoothing>,<rounds> (e.g. "
                             f"0.1,300), got {cfg.warm_start!r}") from None
        if warm[0] <= 0 or warm[1] < 1:
            raise ValueError("--warmStart needs smoothing > 0 and rounds >= 1")
        if cfg.loss != "hinge":
            raise ValueError("--warmStart hands a smooth_hinge phase off to "
                             "hinge and requires --loss=hinge")
        if cfg.debug_iter <= 0:
            raise ValueError("--warmStart requires --debugIter > 0 (the "
                             "in-loop handoff lands on the eval cadence)")
    try:
        gap_target = float(gap) if gap else None
    except ValueError:
        raise ValueError(f"--gapTarget must be a float, got {gap!r}") \
            from None
    if gap_target is not None and cfg.dtype == "bfloat16":
        raise ValueError("--gapTarget cannot be certified at "
                         "--dtype=bfloat16 (the gap is below bf16 "
                         "resolution); use --dtype=float32 or drop "
                         "--gapTarget")
    guard = (cfg.divergence_guard or "auto").lower()
    if guard not in ("auto", "on", "off"):
        raise ValueError(f"--divergenceGuard must be auto|on|off, got "
                         f"{cfg.divergence_guard!r}")
    if guard == "off" and (cfg.sigma == "auto"
                           or (schedule == "anneal" and anneal_engages)):
        raise ValueError("--sigma=auto / --sigmaSchedule=anneal require the "
                         "divergence guard; drop --divergenceGuard=off")
    return dict(gap_target=gap_target, divergence_guard=guard,
                sigma_schedule=schedule, warm_start=warm, accel=accel,
                theta=theta)


def _finish(cfg: RunConfig, traj: Trajectory, run_meta: dict, *summary):
    """The summary, then ``--trajOut``'s file, as the JAX CLI's
    ``finish`` (cocoa_tpu/cli.py:1771-1773)."""
    traj.meta.update(run_meta)
    traj.summary(*summary)
    if cfg.traj_out:
        traj.dump_jsonl(f"{cfg.traj_out}."
                        f"{traj.algorithm.replace(' ', '_')}.jsonl")


def _layout_knobs(cfg: RunConfig, data, k: int, dtype):
    """``--hotCols`` and ``--evalDense`` resolved against the training
    data, with the JAX CLI's rules, lines and messages
    (cocoa_tpu/cli.py:1197-1214,1452-1483): the hot panel on the sparse
    layout only, printing its accounting when it builds one; the twin's
    ``auto`` decided there by :func:`eval_dense_fits` and printed first.
    Returns (panel width, 0 for the plain stream layout; eval twin)."""
    layout = resolve_layout(data, cfg.layout)
    if cfg.hot_cols is not None and layout != "sparse":
        raise ValueError("--hotCols (the hot/cold column split) only "
                         "applies to the sparse layout")
    # JAX's reading (cocoa_tpu/cli.py:1107-1112): off when absent or
    # false, resolved here when auto, on for any other value
    spec = "false" if cfg.eval_dense is None else cfg.eval_dense.lower()
    eval_dense = spec not in ("false", "auto")
    if layout != "sparse":
        return 0, eval_dense
    hot_n, split = hybrid.resolve_hot_cols(cfg.hot_cols, data, k, dtype)
    quiet = _quiet(cfg)
    if spec == "auto":
        eval_dense = eval_dense_fits(data.n, cfg.num_features, k, dtype)
        if not quiet:
            fallback = ("hot panel + residual stream" if hot_n
                        else "per-nonzero gather (no hot panel — "
                             "consider --hotCols=auto)")
            print(f"evalDense=auto: "
                  f"{'dense twin' if eval_dense else fallback} "
                  f"for the certificate margins")
    if hot_n and not quiet:
        print(f"hotCols={split['spec']}: panel {hot_n} columns, "
              f"{split['coverage'] * 100:.1f}% nonzero coverage, "
              f"{split['panel_bytes'] / 2**20:.1f} MiB HBM, residual mean "
              f"nnz {split['residual_mean_nnz']:.1f} (max "
              f"{split['residual_max_nnz']})")
    return hot_n, eval_dense


def _resolve_auto_block(ds, dtype, quiet: bool) -> int:
    """``--blockSize=auto`` against the active dataset (rows for svm,
    columns for lasso), with the JAX CLI's line (cocoa_tpu/cli.py
    ``_resolve_auto_block``)."""
    block_size = auto_block_size(ds, dtype)
    if not quiet:
        print(f"blockSize=auto: using {block_size or 'the sequential path'} "
              f"for the {ds.layout} layout")
    return block_size


def _run_lasso(cfg: RunConfig, l2: float, block_size: int,
               block_pipeline: Optional[bool], dtype, device, ladder: dict,
               run_meta: dict, loop: dict, resume: bool):
    """``--objective=lasso``: ProxCoCoA+ on A's column shards (with
    ``--blockSize``, through the block round), then the JAX CLI's summary
    line from one more certificate."""
    k = cfg.num_splits
    try:
        data = load_libsvm(cfg.train_file, cfg.num_features)
        ds, b = shard_columns(data, k, dtype=dtype, device=device,
                              layout=cfg.layout)
        quiet = _quiet(cfg)
        if cfg.block_size.lower() == "auto":
            block_size = _resolve_auto_block(ds, dtype, quiet)
        # the same H = max(1, localIterFrac*d/K) law, over coordinates
        params = dataclasses.replace(cfg.to_params(data.num_features, k),
                                     loss="lasso", smoothing=l2)
        # the JAX CLI restores (r, x) and the round (cli.py:1699-1716)
        restored = _restore(cfg, "ProxCoCoA+", resume)
        resume_kw = {} if not restored else dict(
            r_init=restored["w_init"], x_init=restored.get("alpha_init"),
            start_round=restored["start_round"])
        x, r, traj = run_prox_cocoa(
            ds, b, params, cfg.to_debug(), rng=cfg.rng, math=cfg.math,
            block_size=block_size, block_pipeline=block_pipeline,
            quiet=quiet, gap_target=ladder["gap_target"],
            divergence_guard=ladder["divergence_guard"], **resume_kw,
            **loop)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2, []
    primal, gap, _ = lasso_metrics(r, x, ds.shard_arrays(), b, cfg.lam,
                                   l2).cpu().tolist()
    _finish(cfg, traj, run_meta, primal, gap)
    return 0, [RunResult(traj.algorithm, r, x, traj)]


def run(argv: list[str], capture=None) -> tuple[int, list[RunResult]]:
    """The CLI's work: (exit code, one RunResult per algorithm run).
    ``capture=False`` runs each chunk of rounds eagerly on the card, not
    as a replayed CUDA graph (chip_smoke.py compares the two); it is no
    flag of the CLI."""
    cfg, unported = parse_args(argv)
    if unported:
        print(f"error: --{unported[0]} is not yet ported to cocoa_torch "
              f"(ROADMAP Queue A)", file=sys.stderr)
        return 2, []
    try:
        device = resolve_device(cfg.device)
        _check_choices(cfg)
        block_size = _block_size(cfg)
        block_pipeline = _block_pipeline(cfg, block_size)
        objective, l2 = _objective(cfg)
        ladder = _ladder(cfg)
        _scan_chunk(cfg)
        device_loop = _device_loop(cfg)
        resume = _resume(cfg)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2, []

    quiet = _quiet(cfg)
    if not quiet:
        # echo flags, as the reference does (hingeDriver.scala:41-48)
        for f in dataclasses.fields(cfg):
            print(f"{f.name}: {getattr(cfg, f.name)}")
    run_meta = {"dataset": cfg.train_file, "seed": cfg.seed,
                "config_hash": config_hash(dataclasses.asdict(cfg))}

    dtype = _DTYPES[cfg.dtype]
    loop = dict(scan_chunk=cfg.scan_chunk, capture=capture,
                device_loop=device_loop)
    if objective == "lasso":
        return _run_lasso(cfg, l2, block_size, block_pipeline, dtype, device,
                          ladder, run_meta, dict(loop, sampling=cfg.sampling),
                          resume)
    k = cfg.num_splits
    try:
        data = load_libsvm(cfg.train_file, cfg.num_features)
        hot_n, eval_dense = _layout_knobs(cfg, data, k, dtype)
        ds = shard_dataset(data, k=k, layout=cfg.layout, dtype=dtype,
                           device=device, hot_cols=hot_n,
                           eval_dense=eval_dense)
        test_ds = None
        if cfg.test_file:
            # the test file gets a panel of the same width over its own
            # hottest columns, and the training set's twin decision, as
            # in the JAX CLI
            test_ds = shard_dataset(
                load_libsvm(cfg.test_file, cfg.num_features), k=k,
                layout=cfg.layout, dtype=dtype, device=device,
                hot_cols=hot_n, eval_dense=eval_dense)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2, []

    if cfg.block_size.lower() == "auto":
        block_size = _resolve_auto_block(ds, dtype, quiet)
    params = cfg.to_params(data.n, k)
    debug = cfg.to_debug()
    draws = dict(rng=cfg.rng, sampling=cfg.sampling, **loop)
    sdca = dict(test_ds=test_ds, math=cfg.math, block_size=block_size,
                block_pipeline=block_pipeline, quiet=quiet, **draws)
    def restore(algorithm):
        return _restore(cfg, algorithm, resume)

    # hingeDriver.scala:84-110, in the JAX CLI's order (cli.py:1807-1836);
    # as there, only CoCoA+ and CoCoA take the gap target, and each
    # algorithm restores its own checkpoint when it starts
    runs = [lambda: run_cocoa(ds, params, debug, plus=True, **sdca, **ladder,
                              **restore("CoCoA+")),
            lambda: run_cocoa(ds, params, debug, plus=False, **sdca,
                              **ladder, **restore("CoCoA"))]
    if not cfg.just_cocoa:
        runs += [
            lambda: run_minibatch_cd(
                ds, params, debug,
                divergence_guard=ladder["divergence_guard"], **sdca,
                **restore("Mini-batch CD")),
            lambda: run_sgd(ds, params, debug, local=False,
                            test_ds=test_ds, quiet=quiet, **draws,
                            **restore("Mini-batch SGD")),
            lambda: run_sgd(ds, params, debug, local=True, test_ds=test_ds,
                            quiet=quiet, **draws, **restore("Local SGD")),
            lambda: run_dist_gd(ds, params, debug, test_ds=test_ds,
                                quiet=quiet, **loop, **restore("Dist SGD"))]
    results = []
    for run_alg in runs:
        try:
            out = run_alg()
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2, results
        w, traj = out[0], out[-1]
        alpha = out[1] if len(out) == 3 else None
        _finish(cfg, traj, run_meta, *_summary(ds, test_ds, w, alpha, params))
        results.append(RunResult(traj.algorithm, w, alpha, traj))
    return 0, results


def _summary(ds, test_ds, w, alpha, params):
    """The end-of-run (primal, gap, test error) as the JAX CLI's
    ``finish`` computes them: each device sum combined on the host in
    float64."""
    kw = dict(loss=params.loss, smoothing=params.smoothing)
    primal = objectives.primal_objective(ds, w, params.lam, **kw)
    gap = None if alpha is None else \
        primal - objectives.dual_objective(ds, w, alpha, params.lam, **kw)
    err = None if test_ds is None else \
        objectives.classification_error(test_ds, w)
    return primal, gap, err


def main(argv=None) -> int:
    return run(sys.argv[1:] if argv is None else argv)[0]


if __name__ == "__main__":
    sys.exit(main())
