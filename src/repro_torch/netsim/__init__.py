from repro_torch.netsim import (
    chaos, failures, interop, metrics, soak, sweep, telemetry, tracer, workloads,
)
from repro_torch.netsim.chaos import (
    ARCHETYPES, ChaosCampaign, ChaosFault, ChaosInvariants, ChaosScenario, InvariantMonitor,
    Violation, known_bad_scenario, record_digest, scenario_record,
)
from repro_torch.netsim.config import TICK_NS, SimConfig, ns_to_ticks, us_to_ticks
from repro_torch.netsim.engine import (
    FailureSchedule, Probe, ScenarioArrays, SimState, Simulator, TickDraws, TickEvents, TickTrace,
    Workload, stack_scenarios,
)
from repro_torch.netsim.fleet import FleetRunner, FleetTelemetry
from repro_torch.netsim.interop import sim_state_from_numpy, sim_state_to_numpy
from repro_torch.netsim.metrics import RunSummary, summarize, summarize_sketch
from repro_torch.netsim.mixed import MixedLB
from repro_torch.netsim.sweep import (
    BucketPlan, CellShape, PackerConfig, PackPlan, SweepCase, SweepEngine, SweepResult,
    est_row_tick_cost, measured_costs_from_bench, pack,
)
from repro_torch.netsim.soak import SoakConfig, SoakRunner
from repro_torch.netsim.telemetry import (
    CounterTotals, Histogram, RecoveryTracker, RunningScalars, TelemetryProgram, TelemetrySpec,
    WindowedSeries, sketch_bin_index, sketch_percentile,
)
from repro_torch.netsim.topology import Topology, ecmp_hash, ecmp_hash_np, mix32
from repro_torch.netsim.tracer import TracerProgram, TraceSpec

__all__ = [
    "chaos", "failures", "interop", "metrics", "soak", "sweep", "telemetry", "tracer", "workloads",
    "TICK_NS", "SimConfig", "ns_to_ticks", "us_to_ticks",
    "FailureSchedule", "Probe", "ScenarioArrays", "SimState", "Simulator", "TickDraws",
    "TickEvents", "TickTrace", "Workload", "stack_scenarios",
    "FleetRunner", "FleetTelemetry",
    "sim_state_from_numpy", "sim_state_to_numpy",
    "RunSummary", "summarize", "summarize_sketch", "MixedLB", "SoakConfig", "SoakRunner",
    "SweepCase", "SweepEngine", "SweepResult",
    "BucketPlan", "CellShape", "PackerConfig", "PackPlan",
    "est_row_tick_cost", "measured_costs_from_bench", "pack",
    "CounterTotals", "Histogram", "RecoveryTracker", "RunningScalars",
    "TelemetryProgram", "TelemetrySpec", "WindowedSeries",
    "sketch_bin_index", "sketch_percentile",
    "ARCHETYPES", "ChaosCampaign", "ChaosFault", "ChaosInvariants", "ChaosScenario",
    "InvariantMonitor", "Violation", "known_bad_scenario", "record_digest", "scenario_record",
    "Topology", "ecmp_hash", "ecmp_hash_np", "mix32", "TracerProgram", "TraceSpec",
]
