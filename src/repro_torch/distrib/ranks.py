"""Ranks of a ``torch.distributed`` process group: the port's devices.

The reference makes its devices in one process
(``XLA_FLAGS=--xla_force_host_platform_device_count=N``); in the port a
device is a rank of a process group, and each rank holds its device
explicitly.  ``run_ranks(fn, n, device, backend)`` starts ``n`` ranks as
processes of the ``spawn`` context, sets up the group over
``tcp://localhost``, runs ``fn(rank, *args)`` in each and returns every
rank's result (pickled by value), rank 0 first.

The backend is the caller's to name: ``"nccl"`` for one card per rank,
``"gloo"`` for ranks on the CPU or for several ranks on one card (NCCL
refuses two ranks on one device).  Gloo has no CUDA form of most
collectives, so the collectives below stage a CUDA tensor through the
host under gloo (one copy each way, counted in the caller's time); under
NCCL, or on the CPU, they run on the tensor where it lies.

    def work(rank, device):
        eng = SweepEngine(cfg, cases, device=device)  # devices="auto": the group's ranks
        return eng.run(collect="summary", early_exit=True).summaries()

    per_rank = run_ranks(work, 2, "cpu", "gloo", args=("cpu",))
"""
from __future__ import annotations

import multiprocessing as mp
import pickle
import queue as queue_mod
import socket
import time
import traceback

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def rank_device(device, rank: int) -> torch.device:
    """The device rank ``rank`` holds: the CPU, or card ``rank`` modulo the
    cards present (every rank on ``cuda:0`` on a machine of one card)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.index is not None:
        return dev
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank, n, device, backend, port, args, out):
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=n, **kw)
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, pickle.dumps(result)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, n: int, device, backend: str, args: tuple = (), timeout: float = 900.0) -> list:
    """Run ``fn(rank, *args)`` on ``n`` ranks of a new process group and
    return the results in rank order.

    ``fn`` must be importable by the spawned processes (a module-level
    function).  ``device`` ("cpu" or "cuda") is each rank's device
    (``rank_device``); ``backend`` is ``"gloo"`` or ``"nccl"``, never
    chosen here.  A rank that raises, dies or outlives ``timeout`` seconds
    stops every rank, and the error is raised here with its traceback."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    dev = torch.device(device)
    if backend == "nccl" and (dev.type != "cuda" or torch.cuda.device_count() < n):
        raise ValueError(
            f"nccl takes one card per rank: {n} ranks on {device} with "
            f"{torch.cuda.device_count()} cards (name backend='gloo' for ranks that share one)")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, n, device, backend, port, args, out),
                         daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    results: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < n:
            try:
                rank, ok, payload = out.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n - len(results)} of {n} ranks gave no result in "
                                       f"{timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} raised:\n{payload}")
            results[rank] = pickle.loads(payload)
    finally:
        for p in procs:
            p.join(timeout=10 if len(results) == n else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
    return [results[r] for r in range(n)]


# ---------------------------------------------------------------------------
# Collectives that take a tensor wherever it lies (see the module docstring)
# ---------------------------------------------------------------------------
def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the backend takes it: on the host for gloo if it is on a
    card, bool as uint8, contiguous."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if _staged(x, group):
        x = x.cpu()
    return x.contiguous()


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along ``dim`` in rank
    order, on ``x``'s device and dtype."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    w = _wire(x, group)
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim=dim).to(device=x.device, dtype=x.dtype)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' ``x`` (a new tensor; bool is summed as int32)."""
    if dist.get_world_size(group) == 1:
        return x.to(torch.int32) if x.dtype == torch.bool else x.clone()
    w = x.to(torch.int32) if x.dtype == torch.bool else x
    w = (w.cpu() if _staged(w, group) else w).clone().contiguous()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    return w.to(x.device)


def all_true(flag: bool, group, device) -> bool:
    """Whether ``flag`` holds on every rank of ``group`` (one all-reduce)."""
    t = torch.tensor([0 if flag else 1], dtype=torch.int32, device=device)
    return int(all_reduce_sum(t, group)[0]) == 0
