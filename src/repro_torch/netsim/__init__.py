from repro_torch.netsim import failures, interop, metrics, telemetry, workloads
from repro_torch.netsim.config import TICK_NS, SimConfig, ns_to_ticks, us_to_ticks
from repro_torch.netsim.engine import (
    FailureSchedule, Probe, ScenarioArrays, SimState, Simulator, TickDraws, TickTrace, Workload,
    stack_scenarios,
)
from repro_torch.netsim.fleet import FleetRunner, FleetTelemetry
from repro_torch.netsim.interop import sim_state_from_numpy, sim_state_to_numpy
from repro_torch.netsim.metrics import RunSummary, summarize, summarize_sketch
from repro_torch.netsim.mixed import MixedLB
from repro_torch.netsim.telemetry import (
    CounterTotals, Histogram, RecoveryTracker, RunningScalars, TelemetryProgram, TelemetrySpec,
    WindowedSeries, sketch_bin_index, sketch_percentile,
)
from repro_torch.netsim.topology import Topology, ecmp_hash, ecmp_hash_np, mix32

__all__ = [
    "failures", "interop", "metrics", "telemetry", "workloads",
    "TICK_NS", "SimConfig", "ns_to_ticks", "us_to_ticks",
    "FailureSchedule", "Probe", "ScenarioArrays", "SimState", "Simulator", "TickDraws",
    "TickTrace", "Workload", "stack_scenarios",
    "FleetRunner", "FleetTelemetry",
    "sim_state_from_numpy", "sim_state_to_numpy",
    "RunSummary", "summarize", "summarize_sketch", "MixedLB",
    "CounterTotals", "Histogram", "RecoveryTracker", "RunningScalars",
    "TelemetryProgram", "TelemetrySpec", "WindowedSeries",
    "sketch_bin_index", "sketch_percentile",
    "Topology", "ecmp_hash", "ecmp_hash_np", "mix32",
]
