"""Mini-batch SDCA / dual coordinate descent (counterpart of
cocoa_tpu/solvers/minibatch_cd.py; reference MinibatchCD.scala).

The skeleton of CoCoA with the local solver against a frozen w (mode
``frozen``, MinibatchCD.scala:104) and both updates scaled by beta/(K*H)
(MinibatchCD.scala:32,43,128): the ``frozen`` member of the SDCA family's
driver, so it runs every path CoCoA runs -- both math modes, the dense
and sparse SDCA kernels and the block round (``block_size``).
"""

from __future__ import annotations

from typing import Optional

from cocoa_torch.config import DebugParams, Params
from cocoa_torch.data.sharding import ShardedDataset
from cocoa_torch.solvers.cocoa import _alg_config, run_sdca_family


def run_minibatch_cd(ds: ShardedDataset, params: Params, debug: DebugParams,
                     test_ds: Optional[ShardedDataset] = None,
                     rng: str = "reference", w_init=None, alpha_init=None,
                     start_round: int = 1, math: str = "exact",
                     quiet: bool = False, block_size: int = 0,
                     block_pipeline: Optional[bool] = None,
                     gap_target: Optional[float] = None,
                     divergence_guard: str = "auto",
                     scan_chunk: Optional[int] = None,
                     sampling: str = "auto", capture: Optional[bool] = None,
                     device_loop: bool = False):
    """Train from w = 0, alpha = 0, or from ``w_init``/``alpha_init`` at
    round ``start_round`` (a resumed run); returns (w, alpha, Trajectory).
    ``block_pipeline``, ``gap_target``, ``divergence_guard``,
    ``scan_chunk``, ``sampling``, ``capture`` and ``device_loop`` as in
    :func:`cocoa_torch.solvers.cocoa.run_sdca_family` (the guard's
    ``auto`` never arms here: the frozen subproblem reads no sigma')."""
    return run_sdca_family(
        ds, params, debug, "Mini-batch CD",
        _alg_config(params, ds.k, None, mode="frozen"), test_ds=test_ds,
        rng=rng, w_init=w_init, alpha_init=alpha_init,
        start_round=start_round, math=math, quiet=quiet,
        block_size=block_size, block_pipeline=block_pipeline,
        gap_target=gap_target, divergence_guard=divergence_guard,
        scan_chunk=scan_chunk, sampling=sampling, capture=capture,
        device_loop=device_loop)
