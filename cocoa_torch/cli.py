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
        [--events=P [--eventsMaxMB=<int>] [--flightRecorder=auto|on|off]]
        [--metrics=P [--metricsInterval=<s>]] [--trace]
        [--profile=DIR[,START,STOP]]
        [--elastic=N[,shrink][,devices=1] [--stallTimeout=<s>]]

    python -m cocoa_torch.cli --serve[=PORT] --chkptDir=D --numFeatures=N
        [--serveBatch=64,256,1024] [--serveSlaMs=50] [--serveMaxNnz=<n>]
        [--serveDtype=f32|bf16|int8] [--hotCols=auto --trainFile=F]
        [--serveReplicas=<n> --serveRoute=rr|tenant] [--traceSample=<n>]
        [--statusPort=PORT --metrics=P] [--events=P] [--device=cuda|cpu]

    python -m cocoa_torch.cli --fleet=MANIFEST.jsonl --numSplits=K
        --numRounds=T --debugIter=C [--fleetLanes=vmap|map]
        [--localIterFrac=.. --dtype=.. --math=exact|fast --rng=..
        --sigma=<float>|auto --sigmaSchedule=anneal --accel=on
        --gapTarget=<float> --trajOut=P --events=P --metrics=P --trace]
        [--device=cuda|cpu]

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
round <r> (<path>)``.

Telemetry (cocoa_torch/telemetry/), as in the JAX CLI: ``--events=P``
appends the typed event stream to the JSONL ``P`` (``run_start`` with
the run's manifest, one ``ingest`` per loaded file, ``round_eval``,
``sigma_backoff``, ``checkpoint_write``, ``run_end``, ...; capped at
``--eventsMaxMB`` with a ``.1`` rollover) and, unless
``--flightRecorder=off``, dumps the last events to ``P.flightrec`` on a
divergence, an unhandled exception or SIGTERM; ``--metrics=P`` keeps a
Prometheus textfile at ``P`` (written at most every ``--metricsInterval``
seconds); ``--trace`` adds timed ``span`` events (needs ``--events`` or
``--metrics``); ``--profile=DIR`` records the whole run with
``torch.profiler`` into ``DIR``, ``--profile=DIR,START,STOP`` the rounds
[START, STOP), opened and closed at the evals (under ``--deviceLoop`` at
the super-block fetches, where its evals reach the host).  The bus, the
tracer and the process's exit hooks are put back as they were when
:func:`run` returns.

``--serve`` (cocoa_torch/serving/) answers margin queries on a TCP line
protocol from the newest validated CoCoA+ checkpoint in ``--chkptDir``,
hot-swapping each newer generation a trainer writes there, with the JAX
CLI's serve surface: static buckets (``--serveBatch``), admission under
``--serveSlaMs``, ``--serveDtype=bf16|int8`` with its margin-error
certificate, the hot panel (``--hotCols`` with ``--trainFile``), a
``(T, d)`` catalogue, a router over ``--serveReplicas`` replica
processes (``--serveRoute``), ``--traceSample`` and the ``--statusPort``
ops plane; any training flag beside it exits 2 with the JAX CLI's
message.

``--elastic=N`` (or ``N,shrink``, or ``shrink`` with ``--numProcesses``)
turns the process into the supervisor of a gang of N workers of this
CLI (cocoa_torch/elastic.py): it resolves no device and joins no gang,
relaunches the gang from the latest checkpoint when a worker dies,
reforms it at fewer workers after its restart budget (at the first
loss with ``shrink``), and with ``--stallTimeout=<s>`` also restarts a
gang whose checkpoints and metrics stop moving; its events join
``--events``, its gauges ``<metrics>.gang``.

``--overlapComm[=auto|on|off]`` writes the device loop's checkpoints on
a thread while the next super-block runs (a single process with
``--deviceLoop``; elsewhere ``on`` says on stderr why it has no effect).
``--staleRounds=0`` is the synchronous round this CLI always runs;
``S > 0`` exits 2 with the JAX CLI's pointer to the host-exchange gang
harness (tests/torch_elastic_worker.py ``--real=cocoa``).

``--fleet`` (cocoa_torch/data/fleet.py, solvers/fleet.py) trains every
tenant of a schema-validated JSONL manifest (its own dataset ref,
lambda and gap target) through one loop on the card, one captured graph
replayed, each tenant frozen once it certifies: a line per tenant, the
models/s line, and ``--trajOut``'s ``P.fleet.jsonl``.  ``--fleetLanes``
picks batched lanes (``vmap``) or a loop of the solo round's code over
them (``map``, each lane its solo run bit for bit); ``--sigma=auto``
anneals each tenant's sigma', ``--accel=on`` runs each tenant's secant
jumps.  The flags that mean nothing there exit 2 with the JAX CLI's
messages.  Flags of the JAX CLI that this port does not support yet exit
2 with ``error: --X is not yet ported to cocoa_torch (ROADMAP Queue
A)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from cocoa_torch import checkpoint, serving
from cocoa_torch.config import REFERENCE_FLAGS, RunConfig
from cocoa_torch.data import hybrid, load_libsvm, shard_dataset
from cocoa_torch.data import ingest as ingest_lib
from cocoa_torch.data.columns import shard_columns
from cocoa_torch.data.sharding import eval_dense_fits, resolve_layout_stats
from cocoa_torch.data.slab_cache import SlabCache
from cocoa_torch.device import resolve_device
from cocoa_torch.evals import objectives
from cocoa_torch.ops import losses
from cocoa_torch.parallel import distributed
from cocoa_torch.parallel.mesh import local_part, make_mesh
from cocoa_torch.solvers import run_cocoa
from cocoa_torch.solvers.cocoa import auto_block_size
from cocoa_torch.solvers.dist_gd import run_dist_gd
from cocoa_torch.solvers.minibatch_cd import run_minibatch_cd
from cocoa_torch.solvers.prox_cocoa import lasso_metrics, run_prox_cocoa
from cocoa_torch.solvers.sgd import run_sgd
from cocoa_torch.serving.watcher import emit_model_swap
from cocoa_torch.telemetry import aggregate
from cocoa_torch.telemetry import events as tele_events
from cocoa_torch.telemetry import profiling
from cocoa_torch.telemetry import recorder as flightrec_lib
from cocoa_torch.telemetry import tracing
from cocoa_torch.utils.logging import Trajectory, config_hash

_PORT_FLAGS = {f: f for f in ("dtype", "layout", "rng", "math", "loss",
                               "smoothing", "sigma", "device", "objective",
                               "l2", "quiet", "accel", "theta", "sampling")}
_PORT_FLAGS.update(blockSize="block_size", hotCols="hot_cols",
                   scanChunk="scan_chunk", deviceLoop="device_loop",
                   gapTarget="gap_target", divergenceGuard="divergence_guard",
                   trajOut="traj_out", sigmaSchedule="sigma_schedule",
                   warmStart="warm_start", resume="resume",
                   blockPipeline="block_pipeline", evalDense="eval_dense",
                   events="events", metrics="metrics", trace="trace",
                   flightRecorder="flight_recorder",
                   eventsMaxMB="events_max_mb",
                   metricsInterval="metrics_interval", profile="profile")
# flags of the JAX CLI that this port does not accept yet
_NOT_PORTED = ("fp",)
# the round-barrier levers (``--overlapComm``, ``--staleRounds``): no
# RunConfig field, read from the flags given (:func:`_exchange_flags`)
_EXCHANGE_FLAGS = ("overlapComm", "staleRounds")
# the elastic supervisor's flags (``--elastic``, ``--stallTimeout``): no
# RunConfig field, read from the flags given; the supervisor strips them
# from its workers' command line (elastic.py ``strip_elastic_flags``)
_ELASTIC_FLAGS = ("elastic", "stallTimeout")
# how the training text reaches the device (``--ingest``) and the slab
# cache (``--ingestCache``): no RunConfig field, read from the flags given
_INGEST_FLAGS = ("ingest", "ingestCache")
# the gang's flags (``--master`` and its rank, ``--mesh``): no RunConfig
# field, read from the flags given; beside ``--fleet`` (the fleet's
# tenant mesh axis) they are not ported yet
_GANG_FLAGS = ("mesh", "master", "processId", "numProcesses")
# the serving loop's flags (``--serve``): no RunConfig field, read from
# the flags given (``cfg._given``), as the JAX CLI reads its extras
_SERVE_FLAGS = ("serve", "serveBatch", "serveSlaMs", "serveMaxNnz",
                "serveDtype", "serveReplicas", "serveRoute", "traceSample",
                "statusPort")
# fleet training's flags (``--fleet``): no RunConfig field either
_FLEET_FLAGS = ("fleet", "fleetLanes")
# the run manifest's config (the JAX CLI's ``cfg_manifest``): these
# RunConfig fields always, as the JAX CLI holds its dataclass's; every
# other flag given, by its flag name, as the string given
_MANIFEST_FIELDS = (*REFERENCE_FLAGS.values(), "dtype", "layout", "rng",
                    "sampling", "math", "loss", "smoothing", "sigma",
                    "device")

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
    Returns (RunConfig, the flags given that are not ported yet); the
    flags given, as strings, are the config's ``_given`` (no field: the
    flag echo does not show it)."""
    cfg = RunConfig()
    unported = []
    given = {}
    for arg in argv:
        stripped = arg.lstrip("-")
        key, val = (stripped.split("=", 1) if "=" in stripped
                    else (stripped, "true"))
        given[key] = val
        if key in _NOT_PORTED:
            unported.append(key)
            continue
        if (key in _SERVE_FLAGS or key in _FLEET_FLAGS or key in _GANG_FLAGS
                or key in _INGEST_FLAGS or key in _ELASTIC_FLAGS
                or key in _EXCHANGE_FLAGS):
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
    if "fleet" in given:
        unported += [key for key in given if key in _GANG_FLAGS]
    cfg._given = given
    return cfg, unported


def _exchange_flags(cfg: RunConfig) -> str:
    """``--overlapComm`` (auto | on | off; a bare flag means on) after the
    JAX CLI's checks of it and of ``--staleRounds``, with its messages
    (cocoa_tpu/cli.py:342-384).  The CLI's consumer of ``--overlapComm``
    is the device loop's checkpoint write (:func:`_overlap_io`).
    ``--staleRounds`` must be an integer >= 0, and S > 0 is refused: this
    path sums dw in one all-reduce a round, which cannot be split, and
    bounded staleness rides the host-exchange gang harness
    (tests/torch_elastic_worker.py --real=cocoa)."""
    given = getattr(cfg, "_given", {})
    flag = (given.get("overlapComm") or "off").lower()
    if flag == "true":
        flag = "on"   # bare --overlapComm
    if flag not in ("auto", "on", "off"):
        raise ValueError(f"--overlapComm must be auto|on|off, got "
                         f"{given.get('overlapComm')!r}")
    if given.get("staleRounds") is not None:
        try:
            stale_rounds = int(given["staleRounds"])
        except ValueError:
            stale_rounds = -1
        if stale_rounds < 0:
            raise ValueError(f"--staleRounds takes an integer >= 0, got "
                             f"{given['staleRounds']!r}")
        if stale_rounds > 0:
            raise ValueError(
                "--staleRounds > 0 rides the host-exchange aggregation path "
                "(the chaos gang harness, tests/_gang_worker.py "
                "--real=cocoa); this CLI path aggregates Δw inside the "
                "compiled collective, which is synchronous by construction "
                "— drop the flag (docs/DESIGN.md §15)")
    return flag


def _overlap_io(cfg: RunConfig, mesh, device_loop: bool) -> bool:
    """``--overlapComm`` resolved for this process, as the JAX CLI
    resolves it (cocoa_tpu/cli.py:1778-1797): the checkpoint-write
    overlap runs only in a single process with ``--deviceLoop``; ``on``
    that cannot take effect says why on stderr."""
    flag = _exchange_flags(cfg)
    if flag == "off":
        return False
    single = mesh is None or mesh.size == 1
    overlap_io = single and device_loop
    if flag == "on" and not overlap_io:
        if not single:
            print("overlapComm: checkpoint-write overlap disabled on the "
                  "multi-process path (the save's alpha allgather is a "
                  "collective); exchanges overlap via the gang "
                  "host-aggregation path instead", file=sys.stderr)
        else:
            print("note: --overlapComm's CLI consumer is the "
                  "device-resident driver's checkpoint-write overlap — pass "
                  "--deviceLoop (the host-stepped path has no effect to "
                  "enable)", file=sys.stderr)
    return overlap_io


def _manifest_config(cfg: RunConfig) -> dict:
    """The run's config as its manifest and config hash carry it, the
    JAX CLI's layout (cocoa_tpu/cli.py:1026-1027): the fields of
    :data:`_MANIFEST_FIELDS`, then each other flag given, by its name."""
    out = {f: getattr(cfg, f) for f in _MANIFEST_FIELDS}
    for key, val in getattr(cfg, "_given", {}).items():
        if (key in _PORT_FLAGS and _PORT_FLAGS[key] not in out
                or key in _SERVE_FLAGS or key in _FLEET_FLAGS
                or key in _GANG_FLAGS or key in _INGEST_FLAGS):
            out[key] = val
    return out


class _Telemetry(NamedTuple):
    """The telemetry flags resolved (:func:`_telemetry_flags`)."""

    trace: bool
    flight_recorder: str       # auto | on | off
    events_max_bytes: Optional[int]
    metrics_interval: float


def _telemetry_flags(cfg: RunConfig) -> _Telemetry:
    """``--trace``, ``--flightRecorder``, ``--eventsMaxMB`` and
    ``--metricsInterval`` checked up front, with the JAX CLI's rules and
    messages (cocoa_tpu/cli.py:280-335)."""
    trace = cfg.trace is not None and cfg.trace.lower() != "false"
    if trace and not (cfg.events or cfg.metrics):
        raise ValueError("--trace records spans through the telemetry sinks "
                         "and needs --events (for trace_report/Perfetto) or "
                         "--metrics (for the phase-seconds gauges)")
    mode = (cfg.flight_recorder or "auto").lower()
    if mode == "true":
        mode = "on"   # bare --flightRecorder
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"--flightRecorder must be auto|on|off, got "
                         f"{cfg.flight_recorder!r}")
    if mode == "on" and not cfg.events:
        raise ValueError("--flightRecorder=on needs --events (the dump lands "
                         "at <events>.flightrec, and the supervisor-side dump "
                         "tails the per-process event streams)")
    max_bytes = None
    if cfg.events_max_mb:
        try:
            max_bytes = int(cfg.events_max_mb) << 20
        except ValueError:
            max_bytes = 0
        if max_bytes <= 0:
            raise ValueError(f"--eventsMaxMB takes a positive integer of "
                             f"mebibytes, got {cfg.events_max_mb!r}")
        if not cfg.events:
            raise ValueError("--eventsMaxMB caps the --events JSONL and "
                             "needs --events")
    interval = 0.0
    if cfg.metrics_interval:
        try:
            interval = float(cfg.metrics_interval)
        except ValueError:
            interval = -1.0
        if interval < 0:
            raise ValueError(f"--metricsInterval takes seconds >= 0, got "
                             f"{cfg.metrics_interval!r}")
        if not cfg.metrics:
            raise ValueError("--metricsInterval debounces the --metrics "
                             "textfile and needs --metrics")
    return _Telemetry(trace, mode, max_bytes, interval)


@contextlib.contextmanager
def _telemetry(cfg: RunConfig, tel: _Telemetry, rank: int = 0):
    """The run's telemetry, as the JAX CLI sets it up for process
    ``rank`` (cocoa_tpu/cli.py:996-1023): the bus's JSONL sink (rank 0
    owns ``<events>``, rank p writes ``<events>.p<p>``), the metrics
    textfile on rank 0 only, the tracer tagging its spans with the
    worker, and the flight recorder under ``--flightRecorder=auto|on``.  An exception that leaves the run dumps
    the recorder (the JAX CLI's excepthook sees it at the top of its
    process).  On the way out the bus and the tracer are put back as they
    were, and the recorder's excepthook and SIGTERM handler removed."""
    bus = tele_events.get_bus()
    tracer = tracing.get_tracer()
    saved, traced = bus.saved(), (tracer.enabled, tracer.worker)
    events_path = (flightrec_lib.worker_stream_path(cfg.events, rank)
                   if cfg.events else None)
    metrics_path = cfg.metrics if rank == 0 and cfg.metrics else None
    rec = None
    try:
        if events_path or metrics_path:
            bus.configure(jsonl_path=events_path,
                          metrics_path=metrics_path,
                          max_bytes=tel.events_max_bytes,
                          metrics_interval_s=tel.metrics_interval)
        if tel.trace:
            tracer.configure(enabled=True, worker=rank)
        if events_path and tel.flight_recorder != "off":
            rec = flightrec_lib.install(bus, events_path)
        yield bus
    except Exception as e:
        if rec is not None:
            rec.dump("unhandled_exception", error=type(e).__name__)
        raise
    finally:
        if rec is not None:
            rec.uninstall()
        bus.restore(saved)
        tracer.enabled, tracer.worker = traced


def _run_start(bus, cfg_manifest: dict, run_meta: dict, dataset: str,
               device, layout_split, reports: list, mesh=None,
               cache_events=()) -> None:
    """The ``run_start`` event, then one ``ingest`` event per loaded file
    and one ``ingest_cache`` event per file the slab cache saw, as the JAX
    CLI emits them once the layout is resolved (cocoa_tpu/cli.py:
    1548-1566): the manifest is the run's config (with ``layout_split``
    on the sparse layout, which the config hash then covers) and the
    torch/device environment, with the train file's ingest record beside
    the split."""
    if layout_split is not None:
        cfg_manifest["layout_split"] = layout_split
        run_meta["config_hash"] = config_hash(cfg_manifest)
    if not bus.active():
        return
    manifest = tele_events.run_manifest(cfg_manifest, dataset=dataset,
                                        device=device, mesh=mesh)
    if layout_split is not None:
        manifest["layout_split"] = dict(layout_split)
    if reports:
        manifest["ingest"] = reports[0].as_fields()
    bus.emit("run_start", manifest=manifest)
    for rep in reports:
        bus.emit("ingest", **rep.as_fields())
    for fields in cache_events:
        bus.emit("ingest_cache", **fields)


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
    """(objective, l2, the slab cache or None) with the JAX CLI's checks
    and messages (cocoa_tpu/cli.py:1101-1105,1119-1160,1664-1681)."""
    objective = (cfg.objective or "svm").lower()
    if objective not in ("svm", "lasso"):
        raise ValueError(f"--objective must be svm|lasso, got {objective!r}")
    cache = _ingest_cache(cfg, objective)
    if objective == "svm":
        return objective, 0.0, cache
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
    return objective, l2, cache


def _ingest_cache(cfg: RunConfig, objective: str):
    """``--ingestCache=DIR`` armed (its directory made) and ``--ingest``
    checked, with the JAX CLI's rules and messages (cocoa_tpu/cli.py:
    1119-1160): the cache is the SVM rows' alone, and ``--ingest`` takes
    stream|whole|auto, ``stream`` not with the lasso.  Returns the
    :class:`SlabCache` or None; the mode itself is resolved once the gang
    is known (:func:`_ingest_svm`)."""
    given = getattr(cfg, "_given", {})
    cache = None
    if given.get("ingestCache"):
        if objective == "lasso":
            raise ValueError("--ingestCache does not apply to "
                             "--objective=lasso (the column shards "
                             "transpose the row slabs per run — nothing "
                             "shard-keyed to cache); drop the flag")
        try:
            cache = SlabCache(str(given["ingestCache"]))
        except OSError as e:
            raise ValueError(f"--ingestCache={given['ingestCache']!r}: "
                             f"{e}") from None
    ingest_lib.resolve_ingest_mode(given.get("ingest"), None,
                                   objective=objective,
                                   cached=cache is not None)
    return cache


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
    ``finish`` (cocoa_tpu/cli.py:1771-1773); in a gang rank 0 alone
    writes the file, which every rank's trajectory would fill alike."""
    traj.meta.update(run_meta)
    traj.summary(*summary)
    if cfg.traj_out and not (distributed.initialized()
                             and torch.distributed.get_rank() != 0):
        traj.dump_jsonl(f"{cfg.traj_out}."
                        f"{traj.algorithm.replace(' ', '_')}.jsonl")


def _layout_knobs(cfg: RunConfig, n: int, total_nnz: int, hist, k: int,
                  dtype):
    """``--layout``, ``--hotCols`` and ``--evalDense`` resolved from the
    training file's counts alone (n, its nonzeros, its column histogram),
    with the JAX CLI's rules and messages (cocoa_tpu/cli.py:1216-1242
    ``resolve_stats_knobs``): the one resolver of the whole-file, the
    streamed and the cached builds.  The hot panel is on the sparse
    layout only; the twin's ``auto`` is decided by :func:`eval_dense_fits`.
    Returns (layout, panel width, 0 for the plain stream layout; eval
    twin)."""
    layout = resolve_layout_stats(n, cfg.num_features, total_nnz,
                                  cfg.layout)
    if cfg.hot_cols is not None and layout != "sparse":
        raise ValueError("--hotCols (the hot/cold column split) only "
                         "applies to the sparse layout")
    # JAX's reading (cocoa_tpu/cli.py:1107-1112): off when absent or
    # false, resolved here when auto, on for any other value
    eval_dense = _eval_dense_spec(cfg) not in ("false", "auto")
    hot_n = 0
    if layout == "sparse":
        hot_n = hybrid.resolve_hot_width(cfg.hot_cols, hist, n, k, dtype)
        if _eval_dense_spec(cfg) == "auto":
            eval_dense = eval_dense_fits(n, cfg.num_features, k, dtype)
    return layout, hot_n, eval_dense


def _eval_dense_spec(cfg: RunConfig) -> str:
    return "false" if cfg.eval_dense is None else cfg.eval_dense.lower()


def _announce_eval(cfg: RunConfig, layout: str, hot_n: int,
                   eval_dense: bool) -> None:
    """The JAX CLI's ``evalDense=auto: ...`` line on the sparse layout."""
    if layout != "sparse" or _eval_dense_spec(cfg) != "auto" or _quiet(cfg):
        return
    fallback = ("hot panel + residual stream" if hot_n
                else "per-nonzero gather (no hot panel — "
                     "consider --hotCols=auto)")
    print(f"evalDense=auto: {'dense twin' if eval_dense else fallback} "
          f"for the certificate margins")


def _announce_hot(cfg: RunConfig, split, hot_n: int) -> None:
    """The JAX CLI's ``hotCols=...: panel ...`` line when a panel builds."""
    if not hot_n or _quiet(cfg):
        return
    print(f"hotCols={split['spec']}: panel {hot_n} columns, "
          f"{split['coverage'] * 100:.1f}% nonzero coverage, "
          f"{split['panel_bytes'] / 2**20:.1f} MiB HBM, residual mean "
          f"nnz {split['residual_mean_nnz']:.1f} (max "
          f"{split['residual_max_nnz']})")


class _Loaded(NamedTuple):
    """What the SVM runs' ingest built (:func:`_ingest_svm`)."""

    ds: object
    test_ds: object
    n: int                   # the training set's examples
    split: Optional[dict]    # the layout split's record (sparse layout)
    reports: list            # one IngestReport per loaded file
    cache_events: list       # one ``ingest_cache`` record per cached file


def _ingest_svm(cfg: RunConfig, k: int, dtype, device, mesh, mode: str,
                cache) -> _Loaded:
    """The training and test files as this rank's shards, by the resolved
    ``--ingest`` mode, as the JAX CLI builds them (cocoa_tpu/cli.py:
    1244-1545): ``stream`` scans the file (pass 1), resolves the knobs
    from the index and parses only this rank's shards; ``whole`` parses
    the whole file, first trying a build from the slab cache alone when
    its index is cached (no byte read), and publishes what it builds."""
    part = local_part(mesh)
    procs = 1 if mesh is None else mesh.size
    d = cfg.num_features
    reports, cache_events = [], []

    def record_cache(path, status, info):
        if cache is not None:
            cache_events.append(dict(
                path=path, status=status, shards_cached=info.shards_cached,
                shards_total=info.shards_total,
                bytes_mapped=info.cache_bytes_mapped,
                seconds_saved=info.seconds_saved))

    def split_of(counts, hot_n, ds, max_row_nnz, n):
        """The layout split's record; the residual is the whole row
        without a panel."""
        return hybrid.stats_from_counts(
            cfg.hot_cols, counts, hot_n,
            ds.residual_max_nnz if hot_n else max_row_nnz, n, k, dtype)

    if mode == "stream":
        def stream(index, hot_n, eval_dense):
            ds, info = ingest_lib.stream_shard_dataset(
                index.path, d, k, layout=cfg.layout, dtype=dtype,
                device=device, part=part, eval_dense=eval_dense,
                hot_cols=hot_n, index=index, cache=cache)
            ds.mesh = mesh
            # a warm run pays no scan and no parse: a scanned index
            # makes a shard hit partial
            status = "off" if cache is None else (
                "partial" if info.cache_status == "hit" and index.scan_bytes
                else info.cache_status)
            reports.append(ingest_lib.stream_report(index, info, procs,
                                                    status))
            record_cache(index.path, status, info)
            return ds, info

        index = ingest_lib.build_index(cfg.train_file, d, cache=cache)
        layout, hot_n, eval_dense = _layout_knobs(
            cfg, index.n, index.total_nnz, index.hist, k, dtype)
        _announce_eval(cfg, layout, hot_n, eval_dense)
        ds, _ = stream(index, hot_n, eval_dense)
        split = None
        if layout == "sparse":
            split = split_of(index.hist, hot_n, ds,
                             int(index.row_nnz.max(initial=0)), index.n)
            _announce_hot(cfg, split, hot_n)
        test_ds = None
        if cfg.test_file:
            test_ds, _ = stream(ingest_lib.build_index(cfg.test_file, d,
                                                       cache=cache),
                                hot_n, eval_dense)
        return _Loaded(ds, test_ds, index.n, split, reports, cache_events)

    def handle_of(path):
        if cache is None:
            return None
        try:
            return cache.for_file(path, d)
        except OSError:
            return None  # the parse below fails with its own message

    def warm(handle, stats, path, hot_n, eval_dense, t0):
        """(ds, build info) from the cache's artifacts alone, or None."""
        if handle is None or stats is None:
            return None
        layout = resolve_layout_stats(stats.n, d, stats.total_nnz,
                                      cfg.layout)
        got = ingest_lib.load_cached_dataset(
            handle, stats, k, layout=layout, dtype=dtype, device=device,
            part=part, eval_dense=eval_dense, hot_cols=hot_n)
        if got is None:
            return None
        got[0].mesh = mesh
        record_cache(path, "hit", got[1])
        reports.append(ingest_lib.IngestReport(
            mode="whole", path=path, file_bytes=stats.file_bytes,
            processes=procs, parse_seconds=time.perf_counter() - t0,
            bytes_read=0, rows=0, nnz=0, n=stats.n,
            total_nnz=stats.total_nnz,
            peak_rss_bytes=ingest_lib.peak_rss_bytes(), cache="hit"))
        return got

    def cold(handle, path, hot_n, eval_dense, t0, data=None, counts=None):
        """Parse ``path`` (unless ``data`` is its parse, ``counts`` its
        column histogram) and build its shards, publishing each and the
        file's counts to the cache."""
        if data is None:
            data = load_libsvm(path, d)
        if counts is None:
            counts = hybrid.column_counts(data)
        snap = None if cache is None else (cache.shard_hits,
                                           cache.shard_misses,
                                           cache.bytes_mapped)
        ds = shard_dataset(data, k=k, layout=cfg.layout, dtype=dtype,
                           device=device, hot_cols=hot_n,
                           eval_dense=eval_dense, part=part, cache=handle,
                           counts=counts)
        ds.mesh = mesh
        status = "off"
        if handle is not None:
            handle.store_index(hist=counts, n=data.n,
                               total_nnz=int(data.indptr[-1]),
                               max_row_nnz=int(data.max_nnz))
            hits = cache.shard_hits - snap[0]
            misses = cache.shard_misses - snap[1]
            if hits == 0:
                # a partial run paid for its missed shards alone
                handle.store_cost(time.perf_counter() - t0)
            status = "partial" if hits else "miss"
            record_cache(path, status, ingest_lib.StreamBuildInfo(
                rows=0, nnz=0, bytes_read=0, parse_seconds=0.0,
                residual_max_nnz=0, shards_cached=hits,
                shards_total=hits + misses,
                cache_bytes_mapped=cache.bytes_mapped - snap[2],
                cache_status=status))
        reports.append(ingest_lib.whole_report(
            path, data, time.perf_counter() - t0, procs, status))
        return ds

    t_load = time.perf_counter()
    handle = handle_of(cfg.train_file)
    stats = handle.load_index() if handle is not None else None
    got = None
    if stats is not None:
        # the knobs from the cached counts, as the streamed build's
        layout, hot_n, eval_dense = _layout_knobs(
            cfg, stats.n, stats.total_nnz, stats.hist, k, dtype)
        got = warm(handle, stats, cfg.train_file, hot_n, eval_dense, t_load)
    if got is not None:
        ds = got[0]
        n, counts, max_row_nnz = stats.n, stats.hist, int(stats.max_row_nnz)
    else:
        data = load_libsvm(cfg.train_file, d)
        n, counts, max_row_nnz = (data.n, hybrid.column_counts(data),
                                  int(data.max_nnz))
        layout, hot_n, eval_dense = _layout_knobs(
            cfg, n, int(data.indptr[-1]), counts, k, dtype)
        ds = cold(handle, cfg.train_file, hot_n, eval_dense, t_load, data,
                  counts)
        del data
    split = None
    if layout == "sparse":
        _announce_eval(cfg, layout, hot_n, eval_dense)
        split = split_of(counts, hot_n, ds, max_row_nnz, n)
        _announce_hot(cfg, split, hot_n)
    test_ds = None
    if cfg.test_file:
        # the test file gets a panel of the same width over its own
        # hottest columns, and the training set's twin decision
        t_test = time.perf_counter()
        handle = handle_of(cfg.test_file)
        got = warm(handle, handle.load_index() if handle is not None
                   else None, cfg.test_file, hot_n, eval_dense, t_test)
        test_ds = got[0] if got is not None else cold(
            handle, cfg.test_file, hot_n, eval_dense, t_test)
    return _Loaded(ds, test_ds, n, split, reports, cache_events)


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
               run_meta: dict, loop: dict, resume: bool, bus,
               cfg_manifest: dict, mesh=None):
    """``--objective=lasso``: ProxCoCoA+ on A's column shards (with
    ``--blockSize``, through the block round), then the JAX CLI's summary
    line from one more certificate.  As in the JAX CLI, ``run_start``
    carries the train file's ingest record (its parse) and no layout
    split, and ``--profile`` records nothing here."""
    k = cfg.num_splits
    try:
        t_load = time.perf_counter()
        data = load_libsvm(cfg.train_file, cfg.num_features)
        report = ingest_lib.whole_report(
            cfg.train_file, data, time.perf_counter() - t_load,
            1 if mesh is None else mesh.size)
        ds, b = shard_columns(data, k, dtype=dtype, device=device,
                              layout=cfg.layout, part=local_part(mesh))
        ds.mesh = mesh
        _run_start(bus, cfg_manifest, run_meta, cfg.train_file, device,
                   None, [report], mesh)
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
                                   l2, mesh).cpu().tolist()
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
    given = getattr(cfg, "_given", {})
    try:
        tel = _telemetry_flags(cfg)
        _exchange_flags(cfg)
        fleet_lanes = _fleet_checks(cfg)
        serve_flag = _serve_checks(cfg)
        if given.get("stallTimeout") and not given.get("elastic"):
            # without a supervisor nothing acts on the timeout
            raise ValueError("--stallTimeout only acts under --elastic=N "
                             "(the supervisor is what kills and restarts "
                             "a wedged gang)")
        # the supervisor resolves no device: the cards are its workers'
        device = (None if given.get("elastic")
                  else resolve_device(cfg.device))
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2, []
    if fleet_lanes is not None:
        return _fleet(cfg, tel, device, fleet_lanes), []
    if serve_flag is not None:
        return _serve(cfg, tel, device, serve_flag), []
    try:
        _check_choices(cfg)
        block_size = _block_size(cfg)
        block_pipeline = _block_pipeline(cfg, block_size)
        objective, l2, ingest_cache = _objective(cfg)
        ladder = _ladder(cfg)
        _scan_chunk(cfg)
        device_loop = _device_loop(cfg)
        # (dir, start, stop) with the JAX CLI's messages
        # (cocoa_tpu/cli.py:610-624)
        profile = (profiling.parse_profile_flag(cfg.profile) if cfg.profile
                   else (None, None, None))
        if given.get("elastic"):
            # this process becomes the gang's supervisor, before any
            # device, shard or rendezvous
            return _elastic(cfg, tel, argv), []
        resume = _resume(cfg)
        gang = _gang_args(cfg)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2, []
    try:
        mesh = _join_gang(cfg, gang, device, device_loop)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        distributed.shutdown()
        return 2, []
    try:
        return _train(cfg, tel, mesh, device if mesh is None
                      else mesh.device, capture, block_size, block_pipeline,
                      objective, l2, ladder, device_loop, resume, profile,
                      ingest_cache)
    finally:
        if mesh is not None:
            distributed.shutdown()


# --- the elastic supervisor (--elastic, --stallTimeout) -----------------


def _elastic_spec(cfg: RunConfig) -> tuple:
    """(workers, shrink mode: auto | now) from ``--elastic=N[,shrink]
    [,devices=D]`` (or ``shrink`` with ``--numProcesses``), with the JAX
    CLI's rules and messages (cocoa_tpu/cli.py:767-816).  ``devices=D``
    above 1 names several cards in one worker process, which the port
    does not run: its workers own one device each."""
    given = cfg._given
    shrink, n_workers, devices = "auto", None, 1
    for part in str(given["elastic"]).split(","):
        part = part.strip()
        if part == "shrink":
            shrink = "now"
        elif part.startswith("devices="):
            # declared, never probed: the supervisor touches no device
            try:
                devices = int(part[len("devices="):])
            except ValueError:
                devices = 0
            if devices < 1:
                raise ValueError(f"--elastic devices= takes a positive "
                                 f"per-worker device count, got {part!r}")
            if devices > 1:
                raise ValueError(f"--elastic {part}: a port worker drives "
                                 f"one card (one rank a device); several "
                                 f"cards in one process are not run "
                                 f"(ROADMAP, configurations the port does "
                                 f"not run) — use devices=1 and one worker "
                                 f"a card")
        elif part:
            try:
                n_workers = int(part)
            except ValueError:
                raise ValueError(
                    "--elastic takes an integer worker count and/or "
                    "'shrink' and/or 'devices=D' (--elastic=4, "
                    "--elastic=4,shrink, --elastic=shrink, "
                    "--elastic=4,shrink,devices=4), got "
                    f"{given['elastic']!r}") from None
    if n_workers is None:
        # bare shrink: the gang's size is --numProcesses
        if not given.get("numProcesses"):
            raise ValueError("--elastic=shrink needs a gang size; pass "
                             "--elastic=N,shrink or add --numProcesses=N")
        try:
            n_workers = int(given["numProcesses"])
        except ValueError:
            raise ValueError("--numProcesses must be an integer") from None
    if n_workers < 1:
        raise ValueError("--elastic needs at least 1 worker")
    return n_workers, shrink


def _stall_timeout(cfg: RunConfig, tel: _Telemetry) -> Optional[float]:
    """``--stallTimeout`` in seconds (None without it), with the JAX
    CLI's checks, messages and two warnings (cocoa_tpu/cli.py:870-914):
    the watchdog reads checkpoint or metrics progress, cannot tell a
    slow start from a wedge under 120 s, and is blinded by a
    ``--metricsInterval`` near the timeout."""
    raw = cfg._given.get("stallTimeout")
    if not raw:
        return None
    try:
        stall = float(raw)
    except ValueError:
        raise ValueError(f"--stallTimeout must be seconds (float), got "
                         f"{raw!r}") from None
    if stall <= 0:
        raise ValueError("--stallTimeout must be > 0")
    if not cfg.chkpt_dir and not cfg.metrics:
        raise ValueError("--stallTimeout watches checkpoint/metrics "
                         "progress — it needs --chkptDir or --metrics")
    if stall < 120:
        print(f"warning: --stallTimeout={stall:g}s is shorter than a "
              f"typical first-compile + first-checkpoint budget; healthy "
              f"gangs may be killed as stalled — consider >= 120s (and a "
              f"--chkptIter the gang can reach within the timeout)",
              file=sys.stderr)
    interval = tel.metrics_interval
    if cfg.metrics and interval > 0 and interval * 2 > stall:
        print(f"warning: --metricsInterval={interval:g}s debounces the "
              f"metrics progress signal the --stallTimeout={stall:g}s "
              f"watchdog reads; keep the interval well under half the "
              f"timeout (or rely on --chkptDir progress)", file=sys.stderr)
    return stall


def _progress_token(cfg: RunConfig):
    """The supervisor's progress signal, as the JAX CLI's
    (cocoa_tpu/cli.py:845-868): the sorted ``.npz`` names in
    ``--chkptDir`` and the text of worker 0's ``--metrics`` file (which
    moves at every eval), None when neither exists."""
    def token():
        ckpts = None
        if cfg.chkpt_dir and os.path.isdir(cfg.chkpt_dir):
            ckpts = tuple(sorted(f for f in os.listdir(cfg.chkpt_dir)
                                 if f.endswith(".npz")))
        metrics = None
        if cfg.metrics:
            try:
                with open(cfg.metrics) as f:
                    metrics = f.read()
            except OSError:
                pass
        if ckpts is None and metrics is None:
            return None
        return (ckpts, metrics)
    return token


def _elastic(cfg: RunConfig, tel: _Telemetry, argv: list) -> int:
    """The ``--elastic`` run, in the JAX CLI's order and words
    (cocoa_tpu/cli.py:626-633, 752-953): this process supervises a gang
    of port workers (elastic.py) and touches no device.  Its restart and
    resize events join ``--events`` (worker 0's file), its gauges go to
    ``<metrics>.gang``, its spans ride ``--trace``; the bus and the tracer
    are put back when it returns."""
    from cocoa_torch import elastic
    from cocoa_torch.telemetry.metrics import MetricsWriter

    if not cfg.train_file:
        raise ValueError("--trainFile is required")
    if cfg.num_features <= 0:
        raise ValueError("--numFeatures must be positive")
    n_workers, shrink = _elastic_spec(cfg)
    if not cfg.chkpt_dir:
        print("warning: --elastic without --chkptDir restarts from round 1 "
              "on failure (no checkpoints to resume from)", file=sys.stderr)
    stall = _stall_timeout(cfg, tel)
    bus, tracer = tele_events.get_bus(), tracing.get_tracer()
    saved, traced = bus.saved(), (tracer.enabled, tracer.worker)
    gang_writer = None
    try:
        if cfg.events or cfg.metrics:
            # no cap here: worker 0 owns the file's rotation
            bus.configure(jsonl_path=cfg.events)
            if cfg.metrics:
                gang_writer = bus.subscribe(MetricsWriter(
                    cfg.metrics + ".gang", families="gang",
                    flush_interval_s=tel.metrics_interval))
            if tel.trace:
                # no worker tag: trace_report places these spans by pid
                tracer.configure(enabled=True)
        return elastic.supervise(
            elastic.strip_elastic_flags(argv), n_workers,
            resume=bool(cfg.chkpt_dir), progress_token=_progress_token(cfg),
            stall_timeout_s=stall, num_splits=cfg.num_splits,
            shrink=shrink, devices_per_worker=1)
    finally:
        if gang_writer is not None:
            gang_writer.flush()
            gang_writer.stop_heartbeat()
        bus.restore(saved)
        tracer.enabled, tracer.worker = traced


def _gang_args(cfg: RunConfig):
    """``--master``, ``--processId`` and ``--numProcesses`` as the JAX
    CLI reads them (cocoa_tpu/cli.py:957-975)."""
    given = getattr(cfg, "_given", {})
    try:
        proc_id = (int(given["processId"]) if given.get("processId")
                   else None)
        n_procs = (int(given["numProcesses"]) if given.get("numProcesses")
                   else None)
    except ValueError:
        raise ValueError("--processId/--numProcesses must be integers") \
            from None
    return given.get("master"), proc_id, n_procs


def _join_gang(cfg: RunConfig, gang, device, device_loop: bool):
    """Join the gang when ``--master`` names a rendezvous (parallel/
    distributed.py) and build its mesh over every rank; then ``--mesh``
    with the JAX CLI's rules and message (cocoa_tpu/cli.py:1042-1100),
    its devices the gang's ranks (1 in one process).  Returns the mesh,
    None in one process (the JAX package's ``--mesh=1`` path)."""
    mesh = None
    if distributed.maybe_initialize(*gang):
        mesh = make_mesh(None, device)
    raw = getattr(cfg, "_given", {}).get("mesh")
    if raw is not None:
        try:
            size = int(raw)
        except ValueError:
            raise ValueError(f"--mesh must be an integer, got {raw!r}") \
                from None
        world = 1 if mesh is None else mesh.size
        k = cfg.num_splits
        if size != world or (size > 1 and k % size != 0):
            raise ValueError(
                f"--mesh={size} (x fp=1) needs a divisor of numSplits={k} "
                f"and mesh x fp devices (have {world}); use --mesh=1 for "
                f"the single-chip path")
    if (device_loop and mesh is not None and mesh.device.type == "cuda"
            and not mesh.capturable):
        from cocoa_torch.solvers.base import GLOO_DEVICE_LOOP

        raise ValueError(GLOO_DEVICE_LOOP)
    return mesh


def _gang_line(mesh, capture) -> str:
    """The run echo's line for a gang: the rank, the device group's
    backend and whether the chunks are captured."""
    if mesh.device.type != "cuda":
        how = "chunks eager (the CPU)"
    elif not mesh.capturable:
        how = "chunks eager: a gloo all-reduce cannot be captured"
    else:
        how = ("chunks eager (capture=False)" if capture is False
               else "chunks captured with the all-reduce inside")
    return f"gang: {mesh.describe()}; {how}"


def _train(cfg: RunConfig, tel: _Telemetry, mesh, device, capture,
           block_size: int, block_pipeline: Optional[bool], objective: str,
           l2: float, ladder: dict, device_loop: bool, resume: bool,
           profile, ingest_cache=None) -> tuple[int, list[RunResult]]:
    """The training run once the flags are checked and the gang (if any)
    is joined: the echo, the telemetry, then the lasso or the SVM menu."""
    quiet = _quiet(cfg)
    if not quiet:
        _echo(cfg)
        if mesh is not None:
            print(_gang_line(mesh, capture))
    cfg_manifest = _manifest_config(cfg)
    run_meta = {"dataset": cfg.train_file, "seed": cfg.seed,
                "config_hash": config_hash(cfg_manifest)}

    dtype = _DTYPES[cfg.dtype]
    loop = dict(scan_chunk=cfg.scan_chunk, capture=capture,
                device_loop=device_loop)
    rank = 0 if mesh is None else mesh.rank
    with _telemetry(cfg, tel, rank) as bus:
        if objective == "lasso":
            return _run_lasso(cfg, l2, block_size, block_pipeline, dtype,
                              device, ladder, run_meta,
                              dict(loop, sampling=cfg.sampling), resume,
                              bus, cfg_manifest, mesh)
        return _run_svm(cfg, block_size, block_pipeline, dtype, device,
                        ladder, run_meta, loop, resume, bus, cfg_manifest,
                        profile, mesh, ingest_cache)


def _run_svm(cfg: RunConfig, block_size: int,
             block_pipeline: Optional[bool], dtype, device, ladder: dict,
             run_meta: dict, loop: dict, resume: bool, bus,
             cfg_manifest: dict, profile, mesh=None, ingest_cache=None):
    """The SVM runs on the row shards: CoCoA+ and CoCoA, and the rest of
    the reference's menu unless ``--justCoCoA``, under ``--profile``
    when it is given."""
    quiet = _quiet(cfg)
    k = cfg.num_splits
    try:
        if ingest_cache is not None and bus.active():
            ingest_cache.on_corrupt = (
                lambda **kw: bus.emit("ingest_cache_corrupt", **kw))
        mode = ingest_lib.resolve_ingest_mode(
            cfg._given.get("ingest"), mesh, objective="svm",
            cached=ingest_cache is not None)
        got = _ingest_svm(cfg, k, dtype, device, mesh, mode, ingest_cache)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2, []
    ds, test_ds = got.ds, got.test_ds
    _run_start(bus, cfg_manifest, run_meta, cfg.train_file, device,
               got.split, got.reports, mesh, got.cache_events)

    if cfg.block_size.lower() == "auto":
        block_size = _resolve_auto_block(ds, dtype, quiet)
    params = cfg.to_params(got.n, k)
    debug = cfg.to_debug()
    draws = dict(rng=cfg.rng, sampling=cfg.sampling, **loop)
    sdca = dict(test_ds=test_ds, math=cfg.math, block_size=block_size,
                block_pipeline=block_pipeline, quiet=quiet, **draws)
    def restore(algorithm):
        return _restore(cfg, algorithm, resume)

    overlap_io = _overlap_io(cfg, mesh, loop["device_loop"])
    # hingeDriver.scala:84-110, in the JAX CLI's order (cli.py:1807-1836);
    # as there, only CoCoA+ and CoCoA take the gap target and the
    # checkpoint-write overlap, and each algorithm restores its own
    # checkpoint when it starts
    runs = [lambda: run_cocoa(ds, params, debug, plus=True, **sdca, **ladder,
                              overlap_io=overlap_io, **restore("CoCoA+")),
            lambda: run_cocoa(ds, params, debug, plus=False, **sdca,
                              **ladder, overlap_io=overlap_io,
                              **restore("CoCoA"))]
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

    def run_all():
        results = []
        for run_alg in runs:
            try:
                out = run_alg()
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2, results
            w, traj = out[0], out[-1]
            alpha = out[1] if len(out) == 3 else None
            _finish(cfg, traj, run_meta,
                    *_summary(ds, test_ds, w, alpha, params))
            results.append(RunResult(traj.algorithm, w, alpha, traj))
        return 0, results

    profile_dir, start, stop = profile
    if start is not None:
        # --profile=DIR,START,STOP: the round window, opened and closed by
        # the event stream (telemetry/profiling.py); the windower is a bus
        # subscriber, which also activates the bus for the run
        windower = profiling.RoundWindowProfiler(profile_dir, start, stop)
        bus.subscribe(windower)
        try:
            return run_all()
        finally:
            windower.close()
            bus.unsubscribe(windower)
            if not quiet:
                print(f"profiler trace of rounds [{start}, {stop}) "
                      f"written to {profile_dir}")
    if profile_dir:
        # --profile=DIR: the whole run; the trace still lands when a
        # solver raises
        prof = profiling.profiler()
        prof.start()
        try:
            return run_all()
        finally:
            prof.stop()
            profiling.export(prof, profile_dir)
            if not quiet:
                print(f"profiler trace written to {profile_dir}")
    return run_all()


def _echo(cfg: RunConfig) -> None:
    """Echo the flags, as the reference does (hingeDriver.scala:41-48)."""
    for f in dataclasses.fields(cfg):
        print(f"{f.name}: {getattr(cfg, f.name)}")


# --- fleet training (--fleet) --------------------------------------------

# flags that cannot mean anything on the fleet's one loop over tenants,
# with the JAX CLI's pointers (cocoa_tpu/cli.py:410-436)
_FLEET_REJECTED = {
    "elastic": "the elastic supervisor gang-restarts one model's training; "
               "a fleet is thousands of independent models in one dispatch "
               "— shrinking a gang mid-fleet has no defined tenant "
               "semantics (docs/DESIGN.md §16)",
    "resume": "fleet checkpoint/resume is not in the v1 surface",
    "warmStart": "the warm-start loss handoff is a solo-path schedule; "
                 "fleets share one loss phase (docs/DESIGN.md §16)",
    "hotCols": "fleet v1 is dense-layout only",
    "evalDense": "fleet v1 is dense-layout only",
    "ingestCache": "the slab cache is keyed to the solo shard layout; fleet "
                   "tenants sharing a dataset ref already dedupe through the "
                   "in-process memo (data/fleet.py — one parse per distinct "
                   "ref)",
    "blockSize": "the block/Pallas kernels own their shard axes and cannot "
                 "ride the tenant vmap",
    "blockPipeline": "the block/Pallas kernels own their shard axes and "
                     "cannot ride the tenant vmap",
}


def _fleet_checks(cfg: RunConfig) -> Optional[str]:
    """``--fleetLanes`` (vmap | map) when the run is a fleet, else None,
    after the JAX CLI's checks of the fleet's flag surface with its
    messages (cocoa_tpu/cli.py:385-475): ``--fleetLanes`` needs
    ``--fleet``; beside ``--fleet``, ``--serve``, ``--testFile``,
    ``--chkptDir``, the flags of :data:`_FLEET_REJECTED`, ``--trainFile``,
    ``--lambda``, ``--numFeatures`` and ``--objective=lasso`` are
    refused."""
    given = getattr(cfg, "_given", {})
    fleet_path = given.get("fleet")
    lanes = (given.get("fleetLanes") or "vmap").lower()
    if given.get("fleetLanes") and not fleet_path:
        raise ValueError("--fleetLanes picks the fleet's lane execution and "
                         "needs --fleet")
    if lanes not in ("vmap", "map"):
        raise ValueError(f"--fleetLanes must be vmap|map, got "
                         f"{given.get('fleetLanes')!r}")
    if not fleet_path:
        return None
    if given.get("serve"):
        raise ValueError("--serve does not combine with --fleet: the fleet "
                         "is one training dispatch, serving is a long-lived "
                         "query loop — run them as separate processes "
                         "(docs/DESIGN.md §17)")
    if cfg.test_file:
        raise ValueError("--testFile does not combine with --fleet: "
                         "per-tenant test sets are not in the fleet v1 "
                         "surface")
    if cfg.chkpt_dir:
        raise ValueError("--chkptDir does not combine with --fleet: fleet "
                         "checkpoint/resume is not in the v1 surface (the "
                         "run is one dispatch; rerun the fleet instead)")
    for flag, why in _FLEET_REJECTED.items():
        if given.get(flag):
            raise ValueError(f"--{flag} does not combine with --fleet: {why}")
    if cfg.train_file:
        raise ValueError("--fleet names per-tenant datasets in the manifest; "
                         "drop --trainFile")
    if "lambda" in given:
        raise ValueError("--lambda does not combine with --fleet: λ is "
                         "per-tenant and comes from the manifest — a global "
                         "--lambda would silently train different models "
                         "than asked for")
    if "numFeatures" in given:
        raise ValueError("--numFeatures does not combine with --fleet: the "
                         "feature dimension comes from each tenant's dataset "
                         "ref (manifest num_features for file-backed "
                         "tenants)")
    if (cfg.objective or "svm").lower() != "svm":
        raise ValueError("--fleet runs the SVM dual family only "
                         "(--objective=lasso has no fleet path yet)")
    if given.get("overlapComm") and _exchange_flags(cfg) != "off":
        raise ValueError("--overlapComm does not combine with --fleet: the "
                         "whole fleet is ONE dispatch and one fetch — there "
                         "is no per-round exchange or checkpoint write to "
                         "overlap (docs/DESIGN.md §16)")
    return lanes


def _fleet_ladder(cfg: RunConfig):
    """(drive mode, gap target) of a fleet run, after the JAX CLI's checks
    of the ladder's flags that a fleet reaches (cocoa_tpu/cli.py:633-716,
    1893-1937): a fleet takes its gap targets from the manifest, so
    ``--sigma=auto`` and ``--accel=on`` need no ``--gapTarget``; device
    sampling, the adaptive Theta and the sigma' trial are refused; accel
    is off unless ``on``, and does not combine with the anneal."""
    if cfg.loss not in losses.LOSSES:
        raise ValueError(f"--loss must be one of {losses.LOSSES}; use "
                         f"--objective=lasso for the L1 family")
    schedule = cfg.sigma_schedule
    if schedule is not None and schedule not in ("trial", "anneal"):
        raise ValueError(f"--sigmaSchedule must be trial|anneal, got "
                         f"{schedule!r}")
    if schedule == "trial" and cfg.sigma != "auto":
        raise ValueError("--sigmaSchedule=trial is the --sigma=auto A/B "
                         "control and needs --sigma=auto")
    accel = (cfg.accel or "auto").lower()
    if accel not in ("auto", "on", "off"):
        raise ValueError(f"--accel must be auto|on|off, got {cfg.accel!r}")
    theta = (cfg.theta or "fixed").lower()
    if theta not in ("fixed", "adaptive"):
        raise ValueError(f"--theta must be fixed|adaptive, got "
                         f"{cfg.theta!r}")
    if accel == "on" and schedule == "trial":
        raise ValueError("--accel cannot ride --sigmaSchedule=trial (the "
                         "trial is the bit-exact A/B control); use "
                         "--sigmaSchedule=anneal")
    if theta == "adaptive" and (accel == "off" or schedule == "trial"
                                or not cfg.gap_target):
        raise ValueError("--theta=adaptive requires an accelerated "
                         "gap-targeted run (--accel=auto|on with --gapTarget, "
                         "not --sigmaSchedule=trial)")
    if cfg.sampling == "device":
        raise ValueError("--sampling=device does not combine with --fleet "
                         "(the fleet loop host-samples its stacked index "
                         "tables once per run — solvers/fleet.py); use "
                         "--sampling=auto")
    if theta == "adaptive":
        raise ValueError("--theta=adaptive does not combine with --fleet "
                         "(the Θ ladder slices static index-table widths; "
                         "fleet lanes share one table shape — "
                         "docs/DESIGN.md §16)")
    if cfg.sigma == "auto" and schedule == "trial":
        raise ValueError("--sigmaSchedule=trial does not combine with "
                         "--fleet (the trial's restart is a solo-path "
                         "control; fleets anneal in place — "
                         "--sigmaSchedule=anneal)")
    gap_target = None
    if cfg.gap_target:
        try:
            gap_target = float(cfg.gap_target)
        except ValueError:
            raise ValueError(f"--gapTarget must be a float, got "
                             f"{cfg.gap_target!r}") from None
    anneal = (cfg.sigma == "auto"
              or (schedule == "anneal" and isinstance(cfg.sigma, float)
                  and 0 < cfg.sigma < cfg.num_splits * cfg.gamma))
    if accel == "on" and anneal:
        raise ValueError("--accel does not combine with --sigma=auto/"
                         "--sigmaSchedule=anneal on --fleet (fleet accel "
                         "rides the fixed safe σ′; drop one of the two)")
    return ("accel" if accel == "on" else "anneal" if anneal
            else "plain"), gap_target


def _fleet(cfg: RunConfig, tel: _Telemetry, device, lanes: str) -> int:
    """The ``--fleet`` run (cocoa_tpu/cli.py ``_run_fleet_cli``): the
    remaining checks, the flag echo, then under the run's telemetry the
    manifest loaded and stacked (data/fleet.py), the one loop over every
    tenant (solvers/fleet.py), a line per tenant and the models/s line,
    and ``--trajOut``'s ``P.fleet.jsonl``."""
    from cocoa_torch.data.fleet import build_fleet, load_fleet_manifest
    from cocoa_torch.solvers.fleet import run_cocoa_fleet

    try:
        _check_choices(cfg)
        drive_mode, gap_target = _fleet_ladder(cfg)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    quiet = _quiet(cfg)
    if not quiet:
        _echo(cfg)
    cfg_manifest = _manifest_config(cfg)
    manifest_path = cfg._given["fleet"]
    with _telemetry(cfg, tel) as bus:
        try:
            specs = load_fleet_manifest(manifest_path)
            fleet = build_fleet(specs, k=cfg.num_splits,
                                dtype=_DTYPES[cfg.dtype],
                                local_iter_frac=cfg.local_iter_frac,
                                default_gap_target=gap_target, device=device)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if fleet.loss not in ("hinge", "smooth_hinge"):
            print(f"error: fleet v1 runs the hinge family only (manifest "
                  f"loss {fleet.loss!r}); the logistic dual rule divides by "
                  f"λn in a way the traced-λ lane cannot mirror bit-exactly "
                  f"(docs/DESIGN.md §16)", file=sys.stderr)
            return 2
        if cfg.loss != "hinge" and cfg.loss != fleet.loss:
            print(f"error: the fleet's loss comes from the manifest "
                  f"({fleet.loss!r}); drop --loss={cfg.loss} or make them "
                  f"agree", file=sys.stderr)
            return 2
        if bus.active():
            manifest = tele_events.run_manifest(
                cfg_manifest, dataset=manifest_path, device=device)
            manifest["fleet"] = {"tenants": fleet.t, "k": fleet.k,
                                 "n_shard": fleet.n_shard,
                                 "d": fleet.num_features,
                                 "h": fleet.local_iters,
                                 "drive_mode": drive_mode,
                                 "lane_exec": lanes}
            bus.emit("run_start", manifest=manifest)
        params = dataclasses.replace(
            cfg.to_params(0, fleet.k), local_iters=fleet.local_iters,
            loss=fleet.loss, smoothing=fleet.smoothing)
        try:
            result = run_cocoa_fleet(
                fleet, params, cfg.to_debug(), plus=True,
                drive_mode=drive_mode, rng=cfg.rng, math=cfg.math,
                lane_exec=lanes, quiet=quiet)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        certified = int(result.certified.sum())
        stopped = "target" if certified == fleet.t else None
        if bus.active():
            bus.emit("run_end", algorithm=result.algorithm, stopped=stopped)
    if not quiet:
        for ti, tenant in enumerate(result.tenants):
            status = (f"certified @ round {int(result.cert_round[ti])}"
                      if result.certified[ti]
                      else "DIVERGED (stall watch)" if result.stalled[ti]
                      else "not certified")
            print(f"  {tenant}: lambda={fleet.lams[ti]:g} "
                  f"gap={result.final_gap[ti]:.3e} {status}")
        print(f"fleet: {certified}/{fleet.t} tenants certified, "
              f"{result.rounds_run} rounds, {result.wall_s:.2f}s, "
              f"{result.models_per_second:.1f} models/s "
              f"(drive_mode={drive_mode}, lanes={lanes})")
    if cfg.traj_out:
        import json

        with open(f"{cfg.traj_out}.fleet.jsonl", "w") as f:
            f.write(json.dumps({
                "config": "fleet", "type": "fleet",
                "tenants": fleet.t, "certified": certified,
                "rounds": int(result.rounds_run),
                "models_per_second": result.models_per_second,
                "stopped": stopped}) + "\n")
            for ti, tenant in enumerate(result.tenants):
                f.write(json.dumps({
                    "config": f"fleet/{tenant}", "type": "fleet-tenant",
                    "lam": float(fleet.lams[ti]),
                    "gap": float(result.final_gap[ti]),
                    "rounds": (int(result.cert_round[ti])
                               or int(result.rounds_run)),
                    "stopped": ("target" if result.certified[ti]
                                else None)}) + "\n")
    return 0


# --- the serving loop (--serve) ------------------------------------------

# each serving flag, and what it sets; without --serve it is refused
_SERVE_DEPS = (("serveBatch", "sets the static batch buckets"),
               ("serveSlaMs", "sets the p99 latency budget"),
               ("serveMaxNnz", "sets the per-query nonzero budget"),
               ("serveDtype", "sets the serving precision"),
               ("serveReplicas", "scales the scorer fleet"),
               ("serveRoute", "selects the fleet routing policy"),
               ("traceSample", "samples per-query distributed traces"),
               ("statusPort", "serves the live ops plane"))
# the serve surface: every other flag given beside --serve is refused
# (the JAX CLI's whitelist, and the port's --device, which the fleet
# hands to its replicas)
_SERVE_ALLOWED = frozenset((
    "serve", "serveBatch", "serveSlaMs", "serveMaxNnz", "serveDtype",
    "serveReplicas", "serveRoute", "chkptDir", "numFeatures", "trainFile",
    "hotCols", "quiet", "metrics", "events", "trace", "flightRecorder",
    "eventsMaxMB", "metricsInterval", "seed", "traceSample", "statusPort",
    "device"))
# the JAX CLI's pointers for these flags
_SERVE_POINTERS = {
    "elastic": "supervise the background TRAINER with --elastic and point "
               "--serve's --chkptDir at its checkpoints — the server must "
               "stay outside the gang so a resize can never wedge a query "
               "(docs/DESIGN.md §17)",
    "sigmaSchedule": "σ′ schedules belong to the trainer process "
                     "(--sigmaSchedule=trial is a training A/B control; "
                     "the server only reads validated checkpoints)",
    "gapTarget": "the trainer certifies the gap; the server reports it as "
                 "freshness (cocoa_model_gap_age_seconds)",
    "resume": "the server always serves the newest validated generation; "
              "there is nothing to resume",
    "ingestCache": "the slab cache serves TRAINING ingest; put "
                   "--ingestCache on the background trainer's command line "
                   "(the serve-side --trainFile parse only derives the "
                   "query nonzero budget)",
    "dtype": "--dtype is the TRAINING precision; the serving stack "
             "quantizes the model at swap time — set "
             "--serveDtype=f32|bf16|int8 instead (docs/DESIGN.md §20)",
}


def _serve_checks(cfg: RunConfig) -> Optional[str]:
    """The ``--serve`` flag's value, or None when the run does not serve,
    after the JAX CLI's checks with its messages (cocoa_tpu/cli.py:476-607,
    626-632): each serving flag needs --serve; beside --serve only the
    serve surface is accepted; --chkptDir is needed, --hotCols needs
    --trainFile, --serveReplicas a count >= 1 (a warning past the cores),
    --serveRoute rr|tenant and two replicas; --hotCols serves from one
    process; --numFeatures must be positive."""
    given = getattr(cfg, "_given", {})
    serve_flag = given.get("serve")
    for dep, what in _SERVE_DEPS:
        if given.get(dep) and not serve_flag:
            raise ValueError(f"--{dep} {what} of the serving loop and needs "
                             f"--serve")
    if not serve_flag:
        return None
    for key in sorted(set(given) - _SERVE_ALLOWED):
        why = _SERVE_POINTERS.get(
            key, "serving answers queries from the checkpoints in "
                 "--chkptDir; training flags belong to the background "
                 "trainer process (docs/DESIGN.md §17)")
        raise ValueError(f"--{key} does not combine with --serve: {why}")
    if not cfg.chkpt_dir:
        raise ValueError("--serve needs --chkptDir (the checkpoint directory "
                         "the hot-swap watcher polls — point it at the "
                         "background trainer's --chkptDir)")
    if cfg.hot_cols is not None and not cfg.train_file:
        raise ValueError("--serve with --hotCols needs --trainFile: the hot "
                         "panel is the TRAINED column split, resolved from "
                         "the training data's column histogram "
                         "(data/hybrid.py)")
    n_replicas = 1
    if given.get("serveReplicas"):
        try:
            n_replicas = int(given["serveReplicas"])
        except ValueError:
            n_replicas = 0
        if n_replicas < 1:
            raise ValueError(f"--serveReplicas takes a replica count >= 1, "
                             f"got {given['serveReplicas']!r}")
        cores = os.cpu_count() or 1
        if n_replicas > cores:
            print(f"warning: --serveReplicas={n_replicas} oversubscribes "
                  f"the {cores} detected core(s): replicas time-share cores "
                  f"and per-replica scaling efficiency degrades — measure "
                  f"before trusting a fleet this wide", file=sys.stderr)
    if given.get("serveRoute"):
        if given["serveRoute"] not in serving.Router.ROUTES:
            raise ValueError(f"--serveRoute takes one of "
                             f"{'/'.join(serving.Router.ROUTES)}, got "
                             f"{given['serveRoute']!r}")
        if n_replicas < 2:
            raise ValueError("--serveRoute picks how the fleet router "
                             "spreads queries and needs --serveReplicas>=2 "
                             "(one replica has nothing to route between)")
    if n_replicas >= 2 and cfg.hot_cols is not None:
        raise ValueError("--hotCols does not combine with --serveReplicas>=2: "
                         "per-replica hot panels are not in the fleet v1 "
                         "surface — serve the hybrid layout from a single "
                         "process, or drop --hotCols (docs/DESIGN.md §21)")
    if cfg.num_features <= 0:
        raise ValueError("--numFeatures must be positive")
    return serve_flag


def _serve(cfg: RunConfig, tel: _Telemetry, device, serve_flag: str) -> int:
    """The ``--serve`` run: the flag echo, the telemetry, then
    :func:`_run_serve_cli`; the bus, the tracer and the process's hooks
    are put back when it returns."""
    quiet = _quiet(cfg)
    if not quiet:
        _echo(cfg)
    with _telemetry(cfg, tel) as bus:
        return _run_serve_cli(cfg, quiet, bus, _manifest_config(cfg),
                              serve_flag, device)


@contextlib.contextmanager
def _stop_on_signals(stop):
    """SIGTERM and SIGINT call ``stop`` while the block runs; the
    previous handlers come back after."""
    def handler(signum, frame):
        stop()

    prev = [signal.signal(signal.SIGTERM, handler),
            signal.signal(signal.SIGINT, handler)]
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, prev[0])
        signal.signal(signal.SIGINT, prev[1])


def _serve_port(raw, flag: str) -> int:
    """A TCP port flag (0 or the bare flag: ephemeral), or ValueError
    with the JAX CLI's message."""
    try:
        port = 0 if str(raw).lower() == "true" else int(raw)
    except ValueError:
        port = -1
    if port < 0 or port > 65535:
        raise ValueError(f"--{flag} takes a TCP port (0 = ephemeral), got "
                         f"{raw!r}")
    return port


class _ServeSettings(NamedTuple):
    """The serving flags resolved (:func:`_serve_settings`)."""

    port: int
    buckets: tuple
    sla_ms: float
    serve_dtype: str
    n_replicas: int
    route: str
    trace_sample: int
    status_port: Optional[int]


def _serve_settings(cfg: RunConfig, serve_flag: str) -> _ServeSettings:
    """The serving flags as values, with the JAX CLI's checks and messages
    (cocoa_tpu/cli.py:2180-2264)."""
    given = cfg._given
    port = _serve_port(serve_flag, "serve")
    buckets = serving.DEFAULT_BUCKETS
    if given.get("serveBatch"):
        try:
            buckets = tuple(sorted({int(b) for b in
                                    str(given["serveBatch"]).split(",")}))
            if not buckets or buckets[0] < 1 or buckets[-1] > 8192:
                raise ValueError
        except ValueError:
            raise ValueError(f"--serveBatch takes ascending bucket sizes in "
                             f"[1, 8192] (e.g. 64,256,1024), got "
                             f"{given['serveBatch']!r}") from None
    sla_ms = 50.0
    if given.get("serveSlaMs"):
        try:
            sla_ms = float(given["serveSlaMs"])
        except ValueError:
            sla_ms = -1.0
        if sla_ms <= 0:
            raise ValueError(f"--serveSlaMs takes a positive latency budget "
                             f"in ms, got {given['serveSlaMs']!r}")
    serve_dtype = "f32"
    if given.get("serveDtype"):
        serve_dtype = serving.resolve_serve_dtype(given["serveDtype"])
    n_replicas = (int(given["serveReplicas"]) if given.get("serveReplicas")
                  else 1)
    route = given.get("serveRoute") or "rr"
    # 1 in N trace=-prefixed lines traced; 0 off; the bare flag 64
    trace_sample = 0
    if given.get("traceSample"):
        raw = str(given["traceSample"])
        try:
            trace_sample = 64 if raw.lower() == "true" else int(raw)
        except ValueError:
            trace_sample = -1
        if trace_sample < 0:
            raise ValueError(f"--traceSample takes a sampling divisor >= 0 "
                             f"(1 in N traced; 0 = off; bare flag = 64), got "
                             f"{given['traceSample']!r}")
    status_port = None
    if given.get("statusPort") is not None:
        status_port = _serve_port(given["statusPort"], "statusPort")
        if not cfg.metrics:
            raise ValueError("--statusPort serves the ops plane by scraping "
                             "the metrics textfile(s) and needs --metrics")
    return _ServeSettings(port, buckets, sla_ms, serve_dtype, n_replicas,
                          route, trace_sample, status_port)


def _serve_hot_ids(cfg: RunConfig, d: int, quiet: bool):
    """(hot column ids or None, the per-query nonzero budget): with
    ``--hotCols`` and ``--trainFile``, the trained hot/cold split resolved
    from the training data's column histogram as the trainer resolves it;
    then ``--serveMaxNnz``.  The JAX CLI's rules and messages
    (cocoa_tpu/cli.py:2270-2315)."""
    hot_ids = None
    max_nnz = min(serving.DEFAULT_MAX_NNZ, d)
    if cfg.train_file and cfg.hot_cols is not None:
        data = load_libsvm(cfg.train_file, d)
        # queries are not training rows: the data's widest row only
        # raises the default budget
        max_nnz = min(d, max(max_nnz, int(data.max_nnz)))
        counts = hybrid.column_counts(data)
        hot_n = hybrid.resolve_hot_width(cfg.hot_cols, counts, data.n, 1,
                                         _DTYPES[cfg.dtype])
        if hot_n:
            hot_ids = hybrid.hottest_columns(counts, hot_n)
            if not quiet:
                print(f"serve: hot panel over {hot_n} columns — queries "
                      f"ride panel + residual")
    raw = cfg._given.get("serveMaxNnz")
    if raw:
        try:
            max_nnz = int(raw)
        except ValueError:
            max_nnz = 0
        if max_nnz < 1:
            raise ValueError(f"--serveMaxNnz takes a positive per-query "
                             f"nonzero budget, got {raw!r}")
        max_nnz = min(max_nnz, d)
    return hot_ids, max_nnz


def _run_serve_cli(cfg: RunConfig, quiet: bool, bus, cfg_manifest: dict,
                   serve_flag: str, device) -> int:
    """The ``--serve`` run (counterpart of the JAX CLI's
    ``_run_serve_cli``, cocoa_tpu/cli.py:2164-2470): wait for the first
    validated CoCoA+ checkpoint in ``--chkptDir``, put the model on
    ``device``, warm the scorer's buckets, start the hot-swap watcher and
    the micro-batcher, and answer margin queries on the TCP line protocol
    until ``shutdown`` or SIGTERM/SIGINT; with ``--serveReplicas>=2`` a
    router over that many replica processes (:func:`_run_serve_fleet`).
    Every rejection carries the JAX CLI's message and exit code."""
    try:
        st = _serve_settings(cfg, serve_flag)
        d = cfg.num_features
        hot_ids, max_nnz = _serve_hot_ids(cfg, d, quiet)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    algorithm = "CoCoA+"   # the production trainer's checkpoint key

    path = serving.wait_for_model(cfg.chkpt_dir, algorithm,
                                  timeout_s=300.0, quiet=quiet)
    if path is None:
        print(f"error: no validated {algorithm} checkpoint appeared in "
              f"{cfg.chkpt_dir} within 300s — is the background trainer "
              f"running with --chkptDir pointed here?", file=sys.stderr)
        return 1
    w, info = serving.load_model(path)
    w = np.asarray(w)
    # the trained width may exceed --numFeatures by padding (its columns
    # carry no data); a (T, d) checkpoint is a catalogue of T tenants
    n_tenants = int(w.shape[0]) if w.ndim == 2 else None
    if w.ndim not in (1, 2) or w.shape[-1] < d \
            or (w.ndim == 2 and w.shape[0] < 1):
        print(f"error: the serving checkpoint {path} carries w of shape "
              f"{tuple(w.shape)} but --numFeatures={d} — the query "
              f"width must fit inside the trained width, as a (d,) "
              f"model or a (T, d) tenant catalogue (fix the flag "
              f"or point --chkptDir at the right model)",
              file=sys.stderr)
        return 2
    if n_tenants is not None and st.serve_dtype != "f32":
        print(f"error: --serveDtype={st.serve_dtype} does not combine "
              f"with a (T, d) tenant catalogue (this checkpoint: "
              f"{tuple(w.shape)}): per-tenant quantization "
              f"certificates are not in the fleet v1 surface — serve "
              f"the catalogue at f32 (docs/DESIGN.md §21)",
              file=sys.stderr)
        return 2
    if n_tenants is not None and hot_ids is not None:
        print(f"error: --hotCols does not combine with a (T, d) tenant "
              f"catalogue (this checkpoint: {tuple(w.shape)}): "
              f"per-tenant hot panels are not in the fleet v1 surface "
              f"(docs/DESIGN.md §21)", file=sys.stderr)
        return 2

    if bus.active():
        manifest = tele_events.run_manifest(cfg_manifest,
                                            dataset=cfg.chkpt_dir,
                                            device=device)
        manifest["serve"] = {
            "algorithm": algorithm, "buckets": list(st.buckets),
            "sla_ms": st.sla_ms, "max_nnz": max_nnz, "num_features": d,
            "hot_cols": 0 if hot_ids is None else int(len(hot_ids)),
            "serve_dtype": st.serve_dtype, "replicas": st.n_replicas,
            "route": st.route,
            "tenants": 0 if n_tenants is None else n_tenants,
        }
        bus.emit("run_start", manifest=manifest)

    if st.n_replicas >= 2:
        return _run_serve_fleet(cfg, quiet, bus, st, max_nnz, algorithm,
                                n_tenants)

    # the calibration ring the per-swap certificate reads: seeded now,
    # refilled by real traffic
    calib = (serving.CalibrationBuffer(d, max_nnz=max_nnz, seed=cfg.seed)
             if st.serve_dtype != "f32" else None)
    slots = serving.ModelSlots(w, info, dtype=st.serve_dtype,
                               calibration=calib, algorithm=algorithm,
                               device=device)
    scorer = serving.BatchScorer(d, dtype=st.serve_dtype, buckets=st.buckets,
                                 max_nnz=max_nnz, hot_ids=hot_ids,
                                 model_width=int(w.shape[-1]),
                                 n_tenants=n_tenants, device=device)
    emit_model_swap(algorithm, info)   # the initial load
    with tracing.span("serve_warmup", buckets=len(st.buckets)):
        w_dev, scale, _, form = slots.current()
        n_exec = scorer.warmup(w_dev, scale, form)
    if not quiet:
        print(f"serve: model {algorithm} r{info.round} "
              f"(gap={info.gap if info.gap is not None else 'n/a'}) — "
              f"{n_exec} (bucket, form) pairs warmed up, swaps change no "
              f"shape from here")
        if st.serve_dtype != "f32":
            print(f"serve: quantized to {slots.served_dtype} at load "
                  f"(serveDtype={st.serve_dtype}, margin error bound "
                  f"{slots.last_bound:.3g} over the warmup calibration "
                  f"batch)" if slots.served_dtype != "f32" else
                  f"serve: certificate fallback at load — the "
                  f"{st.serve_dtype} margin error bound "
                  f"{slots.last_bound:.3g} could flip a calibrated "
                  f"sign; serving f32 until a generation certifies",
                  flush=True)

    batcher = serving.MicroBatcher(scorer, slots, sla_s=st.sla_ms / 1000.0,
                                   algorithm=algorithm, calibration=calib)

    def note_swap(inf):
        if not quiet:
            print(f"serve: hot-swapped to r{inf.round} "
                  f"(gap={inf.gap if inf.gap is not None else 'n/a'}, "
                  f"swap #{inf.seq})", flush=True)

    watcher = serving.SwapWatcher(slots, cfg.chkpt_dir, algorithm,
                                  poll_s=0.25, on_swap=note_swap).start()
    server = serving.MarginServer(batcher, d, max_nnz, port=st.port,
                                  n_tenants=n_tenants,
                                  trace_sample=st.trace_sample,
                                  algorithm=algorithm)
    host, bound = server.address[0], server.address[1]
    # the announce line is what a supervisor parses: it prints even under
    # --quiet
    catalogue = "" if n_tenants is None else f", tenants={n_tenants}"
    print(f"serve: listening on {host}:{bound} "
          f"(buckets={','.join(str(b) for b in st.buckets)}, "
          f"slaMs={st.sla_ms:g}, maxNnz={max_nnz}, dtype={st.serve_dtype}"
          f"{catalogue})", flush=True)

    # the gap-age gauge is rendered at write time: a periodic rewrite
    # keeps it climbing while the trainer is dead and the server idle
    writer = getattr(bus, "metrics_writer", None)
    if writer is not None:
        writer.start_heartbeat(5.0)
    # --statusPort: the ops plane over this process's own textfile
    status = None
    if st.status_port is not None:
        status = aggregate.StatusServer(
            lambda: {"server": cfg.metrics}, sla_s=st.sla_ms / 1000.0,
            port=st.status_port, algorithm=algorithm).start()
        print(f"serve: status listening on "
              f"{status.address[0]}:{status.address[1]}", flush=True)
    try:
        with _stop_on_signals(server.stop):
            server.serve_forever()
    finally:
        if status is not None:
            status.stop()
        if writer is not None:
            writer.stop_heartbeat()
        watcher.stop()
        batcher.stop()
        server.close()
    if bus.active():
        bus.emit("run_end", algorithm=algorithm, stopped="shutdown")
    if not quiet:
        print(f"serve: shut down after {batcher.requests_total} "
              f"request(s) in {batcher.batches_total} batch(es), "
              f"{watcher.swaps_total} hot-swap(s), final gap age "
              f"{slots.gap_age_s():.1f}s")
    return 0


def _run_serve_fleet(cfg: RunConfig, quiet: bool, bus, st: _ServeSettings,
                     max_nnz: int, algorithm: str, n_tenants) -> int:
    """``--serveReplicas>=2`` (counterpart of the JAX CLI's
    ``_run_serve_fleet``, cocoa_tpu/cli.py:2037-2163): spawn that many
    single-process serve replicas of this CLI on ``--device`` against the
    same ``--chkptDir``, put the router on the requested port, and relay
    the line protocol until ``shutdown`` or SIGTERM.  Replica i writes its
    events and metrics beside the front door's with the suffix ``.r<i>``
    (a respawn reuses the slot); the router samples ``--traceSample`` and
    ``--statusPort`` scrapes every textfile with the router's liveness."""
    rep_argv = [f"--chkptDir={cfg.chkpt_dir}",
                f"--numFeatures={cfg.num_features}",
                "--serveBatch=" + ",".join(str(b) for b in st.buckets),
                f"--serveSlaMs={st.sla_ms:g}", f"--serveMaxNnz={max_nnz}",
                f"--serveDtype={st.serve_dtype}", f"--device={cfg.device}",
                "--quiet"]
    extra_fn = None
    if cfg.events or cfg.metrics:
        def extra_fn(i):
            argv = []
            if cfg.events:
                argv.append(f"--events={cfg.events}.r{i}")
            if cfg.metrics:
                argv.append(f"--metrics={cfg.metrics}.r{i}")
            return argv

    def echo(s):
        # replica pids and ports print even under --quiet: a supervisor
        # parses them
        print(f"serve: {s}", flush=True)

    fleet = serving.ServeFleet(rep_argv, st.n_replicas,
                               extra_argv_fn=extra_fn, echo=echo)
    try:
        members = fleet.start()
    except RuntimeError as e:
        fleet.stop()
        print(f"error: {e}", file=sys.stderr)
        return 1
    router = serving.Router(members, sla_s=st.sla_ms / 1000.0,
                            route=st.route, port=st.port,
                            algorithm=algorithm,
                            trace_sample=st.trace_sample)
    fleet.attach(router)
    router.emit_initial_state()
    host, bound = router.address[0], router.address[1]
    catalogue = "" if n_tenants is None else f", tenants={n_tenants}"
    print(f"serve: fleet listening on {host}:{bound} "
          f"(replicas={st.n_replicas}, route={st.route}, "
          f"buckets={','.join(str(b) for b in st.buckets)}, "
          f"slaMs={st.sla_ms:g}, maxNnz={max_nnz}, dtype={st.serve_dtype}"
          f"{catalogue})", flush=True)

    writer = getattr(bus, "metrics_writer", None)
    if writer is not None:
        writer.start_heartbeat(5.0)
    status = None
    if st.status_port is not None:
        def sources():
            out = {"router": cfg.metrics}
            for i in range(st.n_replicas):
                out[f"r{i}"] = f"{cfg.metrics}.r{i}"
            return out

        status = aggregate.StatusServer(
            sources, sla_s=st.sla_ms / 1000.0, port=st.status_port,
            algorithm=algorithm,
            liveness_fn=lambda: {r.name: r.live
                                 for r in router.replicas}).start()
        print(f"serve: status listening on "
              f"{status.address[0]}:{status.address[1]}", flush=True)
    try:
        with _stop_on_signals(router.stop):
            router.serve_forever()
    finally:
        if status is not None:
            status.stop()
        if writer is not None:
            writer.stop_heartbeat()
        fleet.stop()
        router.close()
    if bus.active():
        bus.emit("run_end", algorithm=algorithm, stopped="shutdown")
    if not quiet:
        print(f"serve: fleet shut down after {router.forwarded_total} "
              f"forwarded line(s), {router.shed_total} shed, "
              f"{router.requeue_total} requeued, "
              f"{router.failed_total} failed")
    return 0


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
