from repro_torch.ft import reps_channels, straggler
from repro_torch.ft.reps_channels import (
    ChannelSim,
    ChannelSimConfig,
    OpsChannelScheduler,
    RepsChannelScheduler,
    run_cross_pod_reduce,
)
from repro_torch.ft.straggler import LatencyECN, StepWatchdog

__all__ = [
    "reps_channels", "straggler", "ChannelSim", "ChannelSimConfig",
    "OpsChannelScheduler", "RepsChannelScheduler", "run_cross_pod_reduce",
    "LatencyECN", "StepWatchdog",
]
