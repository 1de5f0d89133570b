from cocoa_torch.solvers.cocoa import run_cocoa

__all__ = ["run_cocoa"]
