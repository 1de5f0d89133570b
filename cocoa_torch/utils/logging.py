"""Run trajectory and the reference's console format (counterpart of
cocoa_tpu/utils/logging.py).

The per-``debugIter`` lines follow CoCoA.scala:52-55 and the end-of-run
block OptUtils.scala:102-126, so the two packages' output compares line
by line.  ``dump_jsonl`` writes the JAX package's trajectory file
(``--trajOut``): a manifest header, then one line per record.

:class:`Trajectory` is a consumer of the event bus
(cocoa_torch/telemetry/events.py): each record it collects is mirrored
as a typed ``round_eval``, ``divergence`` or ``run_end`` event (a no-op
while the bus is unconfigured).  ``--quiet`` silences the console only;
the events are emitted all the same.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

from cocoa_torch.telemetry import events as _events
from cocoa_torch.telemetry.events import _clean, config_hash, \
    environment_manifest


@dataclasses.dataclass
class RoundRecord:
    round: int
    wall_time: Optional[float]  # seconds since the run started
    primal: Optional[float] = None
    gap: Optional[float] = None
    test_error: Optional[float] = None
    sigma: Optional[float] = None  # sigma' in effect after this eval's
                                   # schedule update (scheduled runs only)
    # the sigma' ladder index and the stall-watch counter after this
    # eval's update: they ride the round_eval event, and the JSONL dump
    # leaves them out
    sigma_stage: Optional[int] = None
    stall: Optional[int] = None


_NOT_DUMPED = ("sigma_stage", "stall")
_NOW = object()  # log_round's default wall time: the time of the call


class Trajectory:
    """Per-eval records; one comm-round is one outer round."""

    def __init__(self, algorithm: str, quiet: bool = False, device=None):
        self.algorithm = algorithm
        self.records: list[RoundRecord] = []
        self.quiet = quiet
        self.device = device
        # why the run ended: None = its full round budget; "target" = the
        # gap reached gap_target; "diverged" = the stall watch bailed out
        self.stopped: Optional[str] = None
        # extra header fields for dump_jsonl (dataset, seed, config hash)
        self.meta: dict = {}
        # a captured run's CUDA graphs: (branch, rounds) -> seconds to
        # capture (solvers/base.py ``drive``); not dumped
        self.graphs: dict = {}
        # the run's reads of the device for its evals (one per eval on the
        # chunked loop, one per super-block on the device loop) and the
        # device loop's chunk steps replayed after a stop or a change of
        # branch
        self.fetches = 0
        self.dead_chunks = 0
        # checkpoints written (each one more read of the device, apart
        # from ``fetches``)
        self.saves = 0
        self._t0 = time.perf_counter()

    def _console(self, msg: str):
        if not self.quiet:
            print(msg)

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def mark_diverged(self, t: int, n_evals: int):
        """Record (and report) a divergence/stall bail-out at round ``t``;
        the ``divergence`` event is emitted even under ``quiet``."""
        self.stopped = "diverged"
        _events.get_bus().emit("divergence", algorithm=self.algorithm,
                               t=int(t), n_evals=int(n_evals))
        self._console(f"{self.algorithm}: DIVERGED — best duality gap made no "
                      f"material progress over {n_evals} consecutive "
                      f"evaluations; stopped at round {t} "
                      f"(σ′ set below the safe K·γ bound? see --sigma)")

    def log_round(self, t, primal=None, gap=None, test_error=None,
                  sigma=None, sigma_stage=None, stall=None, wall_time=_NOW,
                  emit=True):
        """Record (and print) an eval; ``wall_time`` defaults to the time
        since the run started, and is None where it was not observed (the
        device loop's evals inside a super-block).  ``emit=False`` leaves
        out the ``round_eval`` event: the device loop's rows were emitted
        by its :class:`~cocoa_torch.telemetry.events.DeviceTap`."""
        self.records.append(RoundRecord(
            round=t, wall_time=self.elapsed() if wall_time is _NOW
            else wall_time, primal=primal, gap=gap,
            test_error=test_error, sigma=sigma, sigma_stage=sigma_stage,
            stall=stall))
        if emit:
            _events.get_bus().emit(
                "round_eval", algorithm=self.algorithm, t=int(t),
                primal=primal, gap=gap, test_error=test_error, sigma=sigma,
                sigma_stage=sigma_stage, stall=stall)
        if self.quiet:
            return
        print(f"Iteration: {t}")
        if primal is not None:
            print(f"primal objective: {primal}")
        if gap is not None:
            print(f"primal-dual gap: {gap}")
        if test_error is not None:
            print(f"test error: {test_error}")

    def summary(self, primal, gap=None, test_error=None):
        """The end-of-run block and the ``run_end`` event (emitted even
        under ``quiet``)."""
        _events.get_bus().emit(
            "run_end", algorithm=self.algorithm, primal=primal, gap=gap,
            test_error=test_error, stopped=self.stopped,
            rounds=self.records[-1].round if self.records else 0,
            elapsed_s=self.elapsed())
        if self.quiet:
            return
        out = f"{self.algorithm} has finished running. Summary Stats: "
        out += f"\n Total Objective Value: {primal}"
        if gap is not None:
            out += f"\n Duality Gap: {gap}"
        if test_error is not None:
            out += f"\n Test Error: {test_error}"
        print(out + "\n")

    def manifest(self) -> dict:
        """The dump header: algorithm, record count, the torch/device
        provenance and ``meta``; ``config_hash`` defaults to a hash of the
        meta itself."""
        man = {"algorithm": self.algorithm,
               "records": len(self.records),
               **environment_manifest(self.device),
               **self.meta}
        man.setdefault("config_hash", config_hash(
            {"algorithm": self.algorithm, **self.meta}))
        return man

    def dump_jsonl(self, path: str):
        """One manifest header line, then one line per record; the last
        record carries the ``stopped`` reason (null = the full round
        budget)."""
        with open(path, "w") as f:
            f.write(json.dumps({"manifest": _clean(self.manifest())}) + "\n")
            for j, r in enumerate(self.records):
                d = {"algorithm": self.algorithm,
                     **{k: v for k, v in dataclasses.asdict(r).items()
                        if k not in _NOT_DUMPED}}
                if j == len(self.records) - 1:
                    d["stopped"] = self.stopped
                f.write(json.dumps(_clean(d)) + "\n")
