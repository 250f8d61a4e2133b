"""Scale mode: one sweep row of 10**5 or 10**6 connections (the reference's
``benchmarks/scale_smoke.py``), on one card or with its connection axis
split over several ranks.

``scale_workload`` builds the reference's many-connection workload
(single-packet messages, each host starting one connection every 3
ticks), ``scale_cfg`` the fabric both benchmarks run it on (FATTREE_128's
shape: 128 hosts, 16 per ToR, 16 uplinks; RTO 854, queue 85) in scale mode
(``conn_sharding=True``: the sparse active set, the packet table sized by
slot lifetime, NP = A = 262144 here), and ``run_row`` runs it as one
``SweepEngine`` row (``collect="none"``) with REPS.  The row
``scale/engine_conns{N}`` reports ticks/s, the completed connections, NP,
A, the kernels' launches per tick and, on the card, the peak memory
(``torch.cuda.max_memory_allocated``); the packed REPS state is held to
<= 25 B/conn first (``table1_footprint.measure_scale``).

``--scale-conn-devices N`` (the reference's ``BENCH_SCALE_CONN_DEVICES``)
runs the row with ``SweepEngine(conn_devices=N)`` on N ranks started by
``repro_torch.distrib.ranks.run_ranks`` with the backend ``--scale-backend``
names (``gloo`` for ranks that share one card or the CPU, ``nccl`` for one
card each); the row reports ``conn_devices`` as the reference's does, and
each rank's peak memory and per-connection state bytes.

    python -m repro_torch.bench.run --only scale                        # 10**5, 300 ticks
    python -m repro_torch.bench.run --only scale --scale-conns 1000000 --scale-ticks 1000
    python -m repro_torch.bench.run --only scale --scale-conn-devices 2 --scale-backend gloo
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bench.common import Rows
from repro_torch.bench.table1_footprint import measure_scale
from repro_torch.kernels import ops
from repro_torch.netsim import SimConfig, SweepCase, SweepEngine
from repro_torch.netsim.engine import CONN_LEAVES, Workload

PKT_TABLE_BYTES_MAX = 64e6  # the reference's check that NP follows the lifetime bound


def scale_workload(n_conns: int, n_hosts: int, stagger: int = 3) -> Workload:
    """``n_conns`` single-packet messages spread round robin over the hosts,
    each host starting one connection every ``stagger`` ticks: the active
    set stays O(hosts x lifetime) while the connection tables carry all
    ``n_conns``."""
    i = np.arange(n_conns, dtype=np.int64)
    src = (i % n_hosts).astype(np.int32)
    r = i // n_hosts  # the connection's rank on its host
    dst = ((src + 1 + r % (n_hosts - 1)) % n_hosts).astype(np.int32)
    return Workload(src=src, dst=dst, msg_pkts=np.ones(n_conns, np.int32),
                    start=(r * stagger).astype(np.int32), dep=np.full(n_conns, -1, np.int32),
                    name=f"scale{n_conns}")


def scale_cfg() -> SimConfig:
    return SimConfig(n_hosts=128, hosts_per_tor=16, uplinks_per_tor=16, conn_sharding=True)


def run_row(conns: int, ticks: int, device=None, conn_devices: int = 1):
    """One REPS row of ``scale_workload(conns, 128)`` for ``ticks`` ticks
    through ``SweepEngine(collect="none")``; returns ``(engine, result,
    info)``, ``info`` the row's numbers (this rank's memory).  With
    ``conn_devices`` > 1, every rank of the running process group calls
    it."""
    cfg = scale_cfg()
    case = SweepCase(f"scale/row{conns}", scale_workload(conns, cfg.n_hosts), "reps",
                     ticks=ticks, seeds=(0,))
    cuda = device in (None, "cuda") or torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = SweepEngine(cfg, [case], device=device, conn_devices=conn_devices)
    ops.reset_launch_counts()
    res = eng.run(collect="none")
    counts = ops.launch_counts()
    wall = time.time() - t0
    sim = eng.buckets[0].sim
    st = res.state_for(case.name)
    done = int(st.c_done.sum())
    if done <= 0:
        raise AssertionError("scale row made no progress")
    if sim.NP * 11 * 4 >= PKT_TABLE_BYTES_MAX:  # the lifetime bound, not NC, sizes it
        raise AssertionError(f"packet table ballooned: NP={sim.NP}")
    # what this rank holds per connection: its block of the bitmaps (its
    # own drop row included) and of the nine per-connection vectors
    carry = eng.bucket_carry(eng.buckets[0])
    bitmap = carry.c_rtx.nbytes + carry.c_rcv.nbytes
    vectors = sum(getattr(carry, k).nbytes for k in CONN_LEAVES)
    info = dict(conns=conns, ticks=ticks, done=done, NP=sim.NP, A=sim.A,
                NC_padded=sim.wl.n_conns, conn_devices=conn_devices,
                exec_wall_s=res.exec_wall_s, wall_s=wall,
                ticks_per_sec=ticks / max(res.exec_wall_s, 1e-9),
                launches_per_tick={k: v / ticks for k, v in counts.items()},
                peak_mem_bytes=torch.cuda.max_memory_allocated() if cuda else None,
                bitmap_bytes_per_conn=bitmap / sim.wl.n_conns,
                conn_vector_bytes_per_conn=vectors / sim.wl.n_conns)
    del carry
    return eng, res, info


def _row_on_rank(rank: int, conns: int, ticks: int, device, conn_devices: int) -> dict:
    """``run_row`` on one rank of a ``run_ranks`` group: its numbers."""
    return run_row(conns, ticks, device=device, conn_devices=conn_devices)[2]


def run_row_on_ranks(conns: int, ticks: int, conn_devices: int, backend: str, device=None):
    """``run_row`` with its connection axis over ``conn_devices`` new ranks
    (``run_ranks`` with ``backend``); returns each rank's ``info``."""
    from repro_torch.distrib.ranks import run_ranks

    dev = "cuda" if device is None else str(device)
    return run_ranks(_row_on_rank, conn_devices, dev, backend,
                     args=(conns, ticks, dev, conn_devices))


def main(rows=None, conns: int | None = None, ticks: int | None = None, device=None,
         conn_devices: int = 1, backend: str | None = None, **_):
    rows = rows or Rows()
    conns = int(conns or 100_000)
    ticks = int(ticks or 300)
    measure_scale(conns, rows, device=device)  # <= 25 B/conn, round trip exact
    if conn_devices > 1:
        if backend is None:
            raise ValueError("--scale-conn-devices > 1 starts ranks: name their backend "
                             "(--scale-backend gloo or nccl)")
        per_rank = run_row_on_ranks(conns, ticks, conn_devices, backend, device)
        info = dict(per_rank[0], peak_mem_bytes_per_rank=[r["peak_mem_bytes"] for r in per_rank])
    else:
        info = run_row(conns, ticks, device=device)[2]
    mem = "n/a" if info["peak_mem_bytes"] is None else f"{info['peak_mem_bytes'] / 2**30:.3f}GiB"
    per_tick = ",".join(f"{k}:{v:g}" for k, v in info["launches_per_tick"].items() if v)
    rows.add(f"scale/engine_conns{conns}", info["exec_wall_s"] * 1e6,
             f"ticks={ticks};done={info['done']};NP={info['NP']};A={info['A']};"
             f"conn_devices={conn_devices};"
             f"ticks_per_sec={info['ticks_per_sec']:.1f};peak_mem={mem};launches={per_tick}",
             **{k: v for k, v in info.items() if k != "launches_per_tick"})
    return rows
