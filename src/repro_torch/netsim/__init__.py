from repro_torch.netsim import failures, interop, metrics, workloads
from repro_torch.netsim.config import TICK_NS, SimConfig, ns_to_ticks, us_to_ticks
from repro_torch.netsim.engine import (
    FailureSchedule, SimState, Simulator, TickDraws, TickTrace, Workload,
)
from repro_torch.netsim.fleet import FleetRunner
from repro_torch.netsim.interop import sim_state_from_numpy, sim_state_to_numpy
from repro_torch.netsim.metrics import RunSummary, summarize
from repro_torch.netsim.mixed import MixedLB
from repro_torch.netsim.topology import Topology, ecmp_hash, ecmp_hash_np, mix32

__all__ = [
    "failures", "interop", "metrics", "workloads",
    "TICK_NS", "SimConfig", "ns_to_ticks", "us_to_ticks",
    "FailureSchedule", "SimState", "Simulator", "TickDraws", "TickTrace", "Workload",
    "FleetRunner",
    "sim_state_from_numpy", "sim_state_to_numpy",
    "RunSummary", "summarize", "MixedLB",
    "Topology", "ecmp_hash", "ecmp_hash_np", "mix32",
]
