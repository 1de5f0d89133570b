"""PyTorch/CUDA port of cocoa_tpu: CoCoA+/CoCoA for L2-regularised
classification, with the duality-gap certificate.

The JAX package ``cocoa_tpu`` is the reference; this package mirrors its
module and function names so a reader can find each counterpart, and
imports neither ``jax`` nor anything of ``cocoa_tpu``.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"`` (``--device=cpu`` on
the CLI).  On a CPU tensor every kernel wrapper runs its plain PyTorch
version; on a CUDA tensor it launches its hand-written kernel or raises.
"""

from cocoa_torch.device import resolve_device

__all__ = ["resolve_device"]
