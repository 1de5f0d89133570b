"""Algorithm and run configuration (counterpart of cocoa_tpu/config.py).

``Params`` and ``DebugParams`` mirror the reference's core datatypes
(OptClasses.scala:21-42); ``RunConfig`` holds the CLI flag set this port
accepts, and ``REFERENCE_FLAGS`` maps the reference flag names onto it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union


@dataclasses.dataclass
class Params:
    """Algorithmic parameters: K shards, H = ``local_iters`` local steps per
    round, T = ``num_rounds``."""

    n: int                      # global number of training examples
    num_rounds: int = 200       # T
    local_iters: int = 1        # H
    lam: float = 0.01           # lambda, L2 regularisation
    beta: float = 1.0           # CoCoA averaging scale (beta/K)
    gamma: float = 1.0          # CoCoA+ aggregation scale
    loss: str = "hinge"         # "hinge" | "smooth_hinge" | "logistic"
    smoothing: float = 1.0      # smooth_hinge parameter s
    # sigma' override: None = the safe K*gamma, a float, or "auto"
    # (solvers/cocoa.py run_cocoa)
    sigma: Optional[Union[float, str]] = None


@dataclasses.dataclass
class DebugParams:
    debug_iter: int = 10        # evaluate every this many rounds; <=0 disables
    seed: int = 0
    chkpt_iter: int = 201       # checkpoint every this many rounds
                                # (num_rounds + 1 disables)
    chkpt_dir: str = ""         # empty disables checkpointing
                                # (hingeDriver.scala:55-59)


@dataclasses.dataclass
class RunConfig:
    """The CLI flag set of this port: the reference flags plus the
    numeric/layout knobs of the JAX CLI that the port supports, and
    ``device``."""

    train_file: str = ""
    test_file: str = ""
    num_features: int = 0
    num_splits: int = 1          # K
    chkpt_dir: str = ""
    chkpt_iter: int = 100
    just_cocoa: bool = True
    lam: float = 0.01            # --lambda
    num_rounds: int = 200
    local_iter_frac: float = 1.0
    beta: float = 1.0
    gamma: float = 1.0
    debug_iter: int = 10
    seed: int = 0

    dtype: str = "float32"       # float32 | float64 | bfloat16
    layout: str = "auto"         # dense | sparse (padded CSR) | auto
    rng: str = "reference"       # reference | jax | permuted
    sampling: str = "auto"       # where the index tables are made: auto |
                                 # device | host (solvers/base.py
                                 # resolve_sampling)
    scan_chunk: Optional[int] = None  # --scanChunk: rounds a chunk (None:
                                 # the eval cadence, capped)
    device_loop: Optional[str] = None  # --deviceLoop: evals and the ladder
                                 # on the device (on unless "false")
    math: str = "exact"          # exact | fast
    loss: str = "hinge"
    smoothing: float = 1.0
    sigma: Union[float, str] = 0.0  # 0 = the safe K*gamma; a float, or auto
    device: str = "cuda"         # cuda | cpu
    block_size: str = ""         # --blockSize: "" (off), an int, or auto
    block_pipeline: str = ""     # --blockPipeline: auto | on | off
    objective: str = "svm"       # svm | lasso (ProxCoCoA+)
    l2: str = ""                 # --l2: the elastic-net weight ("" = 0)
    hot_cols: Optional[str] = None  # --hotCols: auto | off | <n> (sparse)
    eval_dense: Optional[str] = None  # --evalDense: the dense eval twin
                                 # (sparse): off if absent or false, auto,
                                 # on for any other value
    # the driver ladder's flags, as the JAX CLI's strings ("" or None =
    # not given); checked and resolved by cli.py ``_ladder``
    gap_target: str = ""         # --gapTarget: stop at this duality gap
    divergence_guard: str = ""   # --divergenceGuard: auto | on | off
    traj_out: str = ""           # --trajOut: JSONL trajectory path prefix
    quiet: Optional[str] = None  # --quiet: silence the console
    sigma_schedule: Optional[str] = None  # --sigmaSchedule: anneal | trial
    warm_start: str = ""         # --warmStart: <smoothing>,<rounds>
    accel: str = ""              # --accel: auto | on | off
    theta: str = ""              # --theta: fixed | adaptive
    resume: Optional[str] = None  # --resume: restore each algorithm from
                                 # the newest checkpoint in chkpt_dir

    def to_params(self, n: int, k: int) -> Params:
        """H = max(1, localIterFrac * n / K) as in hingeDriver.scala:70-71."""
        h = max(1, int(self.local_iter_frac * n / k))
        return Params(
            n=n,
            num_rounds=self.num_rounds,
            local_iters=h,
            lam=self.lam,
            beta=self.beta,
            gamma=self.gamma,
            loss=self.loss,
            smoothing=self.smoothing,
            sigma=("auto" if self.sigma == "auto"
                   else self.sigma if self.sigma > 0 else None),
        )

    def to_debug(self) -> DebugParams:
        """The debug parameters; without ``chkpt_dir`` the checkpoint
        cadence is past the last round, as in the JAX package."""
        chkpt_iter = (self.chkpt_iter if self.chkpt_dir
                      else self.num_rounds + 1)
        return DebugParams(debug_iter=self.debug_iter, seed=self.seed,
                           chkpt_iter=chkpt_iter, chkpt_dir=self.chkpt_dir)


# reference CLI flag name -> RunConfig field (hingeDriver.scala:22-38)
REFERENCE_FLAGS = {
    "trainFile": "train_file",
    "testFile": "test_file",
    "numFeatures": "num_features",
    "numSplits": "num_splits",
    "chkptDir": "chkpt_dir",
    "chkptIter": "chkpt_iter",
    "justCoCoA": "just_cocoa",
    "lambda": "lam",
    "numRounds": "num_rounds",
    "localIterFrac": "local_iter_frac",
    "beta": "beta",
    "gamma": "gamma",
    "debugIter": "debug_iter",
    "seed": "seed",
}
