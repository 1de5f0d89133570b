from cocoa_torch.solvers.cocoa import run_cocoa
from cocoa_torch.solvers.fleet import FleetResult, run_cocoa_fleet

__all__ = ["run_cocoa", "FleetResult", "run_cocoa_fleet"]
