"""Run trajectory and the reference's console format (counterpart of
cocoa_tpu/utils/logging.py, without the telemetry bus).

The per-``debugIter`` lines follow CoCoA.scala:52-55 and the end-of-run
block OptUtils.scala:102-126, so the two packages' output compares line
by line.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class RoundRecord:
    round: int
    wall_time: float            # seconds since the run started
    primal: Optional[float] = None
    gap: Optional[float] = None
    test_error: Optional[float] = None


class Trajectory:
    """Per-eval records; one comm-round is one outer round."""

    def __init__(self, algorithm: str, quiet: bool = False):
        self.algorithm = algorithm
        self.records: list[RoundRecord] = []
        self.quiet = quiet
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def log_round(self, t, primal=None, gap=None, test_error=None):
        self.records.append(RoundRecord(round=t, wall_time=self.elapsed(),
                                        primal=primal, gap=gap,
                                        test_error=test_error))
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
        if self.quiet:
            return
        out = f"{self.algorithm} has finished running. Summary Stats: "
        out += f"\n Total Objective Value: {primal}"
        if gap is not None:
            out += f"\n Duality Gap: {gap}"
        if test_error is not None:
            out += f"\n Test Error: {test_error}"
        print(out + "\n")
