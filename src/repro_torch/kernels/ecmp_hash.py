"""CUDA wrapper of the ``ecmp_hash`` kernel (``csrc/ecmp_hash.cu``).

``out = mix32(flow*0x9E3779B1 ^ ev*0x85EBCA77 ^ salt*0xC2B2AE3D) % nports``
in wrapping uint32 arithmetic: the up-port a switch picks for each packet
of ``Topology.next_queue``.  Replaces the Pallas kernel
``repro.kernels.ecmp_hash``; the plain version is
``repro_torch.kernels.ref.ecmp_hash_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import require

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
    dim = flow.dim()
    if dim not in (1, 2):
        raise ValueError(f"flow must have 1 or 2 dims, got shape {tuple(flow.shape)}")
    require(flow, "flow", torch.int32, dim)
    require(ev, "ev", torch.int32, dim, device=flow.device)
    require(salt, "salt", torch.int32, dim, device=flow.device)
    if ev.shape != flow.shape or salt.shape != flow.shape:
        raise ValueError(
            f"flow {tuple(flow.shape)}, ev {tuple(ev.shape)} and salt "
            f"{tuple(salt.shape)} disagree")
    out = torch.empty_like(flow)
    rc = build.library().repro_ecmp_hash(
        flow.data_ptr(), ev.data_ptr(), salt.data_ptr(), out.data_ptr(), flow.numel(),
        nports, torch.cuda.current_stream(flow.device).cuda_stream,
    )
    build.check(rc, "ecmp_hash")
    launches += 1
    return out
