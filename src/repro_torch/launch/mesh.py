"""Meshes (counterpart of ``repro.launch.mesh``).

Functions, not module-level constants, so that importing this module
touches no process-group state.  The production mesh is the reference's
single pod, 16 x 16 = 256 devices ``("data", "model")``, or two pods, 2 x
16 x 16 = 512 ``("pod", "data", "model")``; here its ranks are those of a
*fake* process group (``torch.testing``'s ``"fake"`` backend) in this one
process: its collectives move nothing, and with ``FakeTensorMode`` a step
over it is traced at full size without allocating (``launch.dryrun``).
``release()`` tears the fake group down.
"""
from __future__ import annotations

import socket

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _fake_world(size: int) -> None:
    """A fake default process group of ``size`` ranks (this process rank
    0), replacing an earlier fake one; a real group is left alone and is
    an error."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialized; the production mesh "
                               "needs the fake one")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def make_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake group of
    ``prod(shape)`` ranks (host-side: its tensors are on the CPU)."""
    n = 1
    for s in shape:
        n *= s
    _fake_world(n)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    return make_mesh(*PRODUCTION[multi_pod])


def release() -> None:
    """Tear down the fake process group, if one is up."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def make_host_mesh(model: int = 1, device=None):
    """A ``(world // model, model)`` ``("data", "model")`` mesh over the
    ranks of the process group (one card each; ``device``: the card by
    default, ``"cpu"`` for a group of host processes), initializing a
    group of one rank when none is up (NCCL on the card, gloo on the
    CPU)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    n = dist.get_world_size()
    assert n % model == 0, (n, model)
    return init_device_mesh(dev.type, (n // model, model), mesh_dim_names=("data", "model"))
