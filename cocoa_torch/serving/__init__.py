"""Margin serving while training (counterpart of cocoa_tpu/serving/).

A batched margin-scoring path with static buckets and the model as a
plain tensor argument, behind an adaptive micro-batcher, with model
slots that a background watcher hot-swaps atomically from the newest
validated checkpoint generation, so the model a query hits is always
certified and its freshness is exported as gap age.  ``--serve`` on the
CLI wires the whole stack; the pieces compose on their own for tests:

- scorer.py   -- BatchScorer / ModelSlots / parse_query (the hot path)
- batcher.py  -- MicroBatcher (admission under the SLA, bucket choice)
- watcher.py  -- SwapWatcher / wait_for_model (checkpoint -> slot)
- server.py   -- MarginServer (the TCP line protocol)
- quantize.py -- swap-time bf16/int8 packing and the per-swap
                 margin-error certificate (``--serveDtype``)
- router.py   -- Router / Replica (the fleet's front door: tenant
                 routing, admission shedding, requeue on death)
- fleet.py    -- ServeFleet (replica subprocesses and their respawn)
"""

from cocoa_torch.serving.batcher import MicroBatcher, PendingQuery
from cocoa_torch.serving.fleet import ReplicaProc, ServeFleet
from cocoa_torch.serving.router import Replica, Router
from cocoa_torch.serving.quantize import (SERVE_DTYPES, CalibrationBuffer,
                                          resolve_serve_dtype)
from cocoa_torch.serving.scorer import (DEFAULT_BUCKETS, DEFAULT_MAX_NNZ,
                                        BatchScorer, ModelInfo, ModelSlots,
                                        QueryError, parse_query,
                                        pick_bucket)
from cocoa_torch.serving.server import MarginServer
from cocoa_torch.serving.watcher import (SwapWatcher, load_model,
                                         wait_for_model)

__all__ = [
    "DEFAULT_BUCKETS", "DEFAULT_MAX_NNZ", "BatchScorer", "ModelInfo",
    "ModelSlots", "QueryError", "parse_query", "pick_bucket",
    "MicroBatcher", "PendingQuery", "MarginServer", "SwapWatcher",
    "load_model", "wait_for_model", "SERVE_DTYPES", "CalibrationBuffer",
    "resolve_serve_dtype", "Router", "Replica", "ServeFleet",
    "ReplicaProc",
]
