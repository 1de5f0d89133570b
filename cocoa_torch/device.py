"""Device selection: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  Raises when CUDA is asked for (or
    defaulted to) and absent: the port never falls back to the CPU on its
    own, because a CPU run is not what a GPU user asked to measure."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' "
            "(--device=cpu on the CLI) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev
