"""CUDA wrapper of the ``ecmp_hash`` kernel (``csrc/ecmp_hash.cu``).

``out = mix32(flow*0x9E3779B1 ^ ev*0x85EBCA77 ^ salt*0xC2B2AE3D) % nports``
in wrapping uint32 arithmetic: the up-port a switch picks for a packet.
The simulator's routing step hashes inside the ``next_queue`` kernel (the
same ``csrc/ecmp_mix.cuh``); this flat form replaces the Pallas kernel
``repro.kernels.ecmp_hash``; the plain version is
``repro_torch.kernels.ref.ecmp_hash_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import check, stream_ptr

launches = 0  # incremented once per kernel launch, nowhere else


def check_nports(nports) -> int:
    nports = int(nports)
    if nports < 1:
        raise ValueError(f"ecmp_hash needs nports >= 1, got {nports}")
    return nports


def ecmp_hash_cuda(flow: torch.Tensor, ev: torch.Tensor, salt: torch.Tensor,
                   nports: int) -> torch.Tensor:
    """``(K,)`` or ``(B, K)`` int32 ``flow`` / ``ev`` / ``salt`` of one shape
    on one CUDA device -> int32 ports in ``[0, nports)``, the same shape."""
    global launches
    nports = check_nports(nports)
    if not isinstance(flow, torch.Tensor) or flow.dim() not in (1, 2) or flow.device.type != "cuda":
        raise ValueError("ecmp_hash: flow must be a (K,) or (B, K) CUDA tensor")
    dev = flow.device
    for t, name in ((flow, "flow"), (ev, "ev"), (salt, "salt")):
        check("ecmp_hash", t, name, torch.int32, flow.shape, dev)
    out = torch.empty_like(flow)
    rc = build.library().repro_ecmp_hash(
        flow.data_ptr(), ev.data_ptr(), salt.data_ptr(), out.data_ptr(), flow.numel(),
        nports, stream_ptr(dev),
    )
    build.check(rc, "ecmp_hash")
    launches += 1
    return out
