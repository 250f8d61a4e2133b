"""The paper's simulation configurations (counterpart of
``repro.configs.arcane_paper``, §4.1)."""
from repro_torch.netsim.config import SimConfig

# 128-node 2-tier fat tree, 1:1 oversubscription (the paper's main config)
FATTREE_128 = SimConfig(
    n_hosts=128, hosts_per_tor=16, uplinks_per_tor=16, tiers=2,
)

# 1024-node 2-tier
FATTREE_1024 = SimConfig(
    n_hosts=1024, hosts_per_tor=32, uplinks_per_tor=32, tiers=2,
)

# 128-node 3-tier (fig 18)
FATTREE_128_3T = SimConfig(
    n_hosts=128, hosts_per_tor=16, tiers=3,
    tors_per_pod=2, aggs_per_pod=4, agg_uplinks=4,
)

# 4:1 oversubscribed variant
FATTREE_128_OVERSUB4 = SimConfig(
    n_hosts=128, hosts_per_tor=16, uplinks_per_tor=4, tiers=2,
)

# CI-scale variants (small, fast defaults for tests)
FATTREE_64_CI = SimConfig(
    n_hosts=64, hosts_per_tor=8, uplinks_per_tor=8, tiers=2,
    evs_size=256, queue_capacity=64, init_cwnd_pkts=50, max_cwnd_pkts=100,
    rto_ticks=500, max_msg_pkts=1024,
)
FATTREE_32_CI = SimConfig(
    n_hosts=32, hosts_per_tor=8, uplinks_per_tor=8, tiers=2,
    evs_size=256, queue_capacity=48, init_cwnd_pkts=40, max_cwnd_pkts=80,
    rto_ticks=400, max_msg_pkts=512,
)
