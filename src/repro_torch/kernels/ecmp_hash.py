"""CUDA wrapper of the ``ecmp_hash`` kernel (``csrc/ecmp_hash.cu``).

``out = mix32(flow*0x9E3779B1 ^ ev*0x85EBCA77 ^ salt*0xC2B2AE3D) % nports``
in wrapping uint32 arithmetic: the up-port a switch picks for a packet.
``nports`` is one int for every lane or an int32 tensor that broadcasts
against ``flow``, one port count per lane (a generated fabric's switches
differ in their up-degree).
The simulator's routing step hashes inside the ``next_queue`` kernel (the
same ``csrc/ecmp_mix.cuh``); this flat form replaces the Pallas kernel
``repro.kernels.ecmp_hash``; the plain version is
``repro_torch.kernels.ref.ecmp_hash_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import check, ptr, stream_ptr

launches = 0  # incremented once per kernel launch, nowhere else


def check_nports(nports):
    """A port count as the kernel takes it: an int ``>= 1`` (checked here),
    or an integer tensor of per-lane counts, returned as it is.  Every lane
    of a tensor must be ``>= 1`` too, but on the card that is the caller's
    contract (as the reference's ``TableTopology`` passes ``maximum(deg,
    1)``): checking it would read the tensor back on the host every call."""
    if isinstance(nports, torch.Tensor) and nports.dim() > 0:
        if nports.dtype.is_floating_point or nports.dtype is torch.bool:
            raise TypeError(f"ecmp_hash: per-lane nports must be an integer tensor, "
                            f"got {nports.dtype}")
        return nports
    nports = int(nports)
    if nports < 1:
        raise ValueError(f"ecmp_hash needs nports >= 1, got {nports}")
    return nports


def ecmp_hash_cuda(flow: torch.Tensor, ev: torch.Tensor, salt: torch.Tensor,
                   nports) -> torch.Tensor:
    """``(K,)`` or ``(B, K)`` int32 ``flow`` / ``ev`` / ``salt`` of one shape
    on one CUDA device -> int32 ports in ``[0, nports)``, the same shape.
    ``nports``: an int, or an int32 tensor on that device that broadcasts
    against ``flow`` (every lane >= 1, unchecked: see ``check_nports``),
    read in place through its broadcast strides."""
    global launches
    nports = check_nports(nports)
    if not isinstance(flow, torch.Tensor) or flow.dim() not in (1, 2) or flow.device.type != "cuda":
        raise ValueError("ecmp_hash: flow must be a (K,) or (B, K) CUDA tensor")
    dev = flow.device
    for t, name in ((flow, "flow"), (ev, "ev"), (salt, "salt")):
        check("ecmp_hash", t, name, torch.int32, flow.shape, dev)
    lanes, strides = None, (0, 0)
    if isinstance(nports, torch.Tensor):
        if nports.dtype is not torch.int32 or nports.device != dev:
            raise ValueError(f"ecmp_hash: per-lane nports must be int32 on {dev}, got "
                             f"{nports.dtype} on {nports.device}")
        # a broadcast view: the kernel reads each lane through its strides
        # (0 along a broadcast axis), so no count is copied
        lanes = torch.broadcast_to(nports, flow.shape)
        strides = (0,) * (2 - flow.dim()) + lanes.stride()
    out = torch.empty_like(flow)
    rc = build.library().repro_ecmp_hash(
        flow.data_ptr(), ev.data_ptr(), salt.data_ptr(), ptr(lanes), out.data_ptr(),
        flow.numel(), 1 if lanes is not None else nports, flow.shape[-1], *strides,
        stream_ptr(dev),
    )
    build.check(rc, "ecmp_hash")
    launches += 1
    return out
