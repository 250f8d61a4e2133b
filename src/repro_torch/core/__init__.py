from repro_torch.core import load_balancers, reps
from repro_torch.core.load_balancers import REGISTRY, LoadBalancer, SwitchLB, make_lb
from repro_torch.core.reps import REPSConfig, REPSOracle, REPSState

__all__ = [
    "load_balancers", "reps", "REGISTRY", "LoadBalancer", "SwitchLB", "make_lb",
    "REPSConfig", "REPSOracle", "REPSState",
]
