"""A simulation state as plain numpy arrays, in both directions.

This is how state crosses between the JAX package and the port (the role
weights play for a model): ``sim_state_to_numpy`` gives one numpy array per
``SimState`` leaf, named by field, with the port's sentinel slots sliced
off, so the dict has exactly the reference's shapes and dtypes;
``sim_state_from_numpy`` rebuilds a port ``SimState`` from such a dict
(adding the sentinels back), whether it came from the port or from a JAX
``SimState`` converted leaf by leaf.  A test can therefore start the port
from any JAX state at tick *t* and compare one step, and compare two states
(JAX vs port, card vs CPU) leaf for leaf.

Scale mode's ``as_idx`` / ``as_count`` cross like every other leaf (they
carry no sentinel slot).  ``topology_spec_to_numpy`` gives a generated
fabric's ``TopologySpec`` (``netsim/topogen.py``) as named arrays, its
regions as ``(name, base, size)`` rows, so that two generators' specs
compare the same way.

The load balancer's state is flattened by path: one entry ``"lb_state"``
when it is a single array (ECMP, OPS), ``"lb_state.<field>"`` per field of
a state dataclass (REPS, PLB, ...) and ``"lb_state.<i>"`` per element of a
tuple (``MixedLB``, ``SwitchLB``), nested as deep as the state is.  Going
back, ``sim_state_from_numpy`` takes the structure from ``lb_like`` (any
state of the same load balancer, e.g. its ``init_state``); without one it
rebuilds a single array or a ``REPSState``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import reps as reps_core
from repro_torch.device import resolve_device
from repro_torch.netsim.engine import STATE_FIELDS, SimState

# leaves carrying a sentinel slot: field -> (axis, padded slot count)
_SENTINEL_AXIS = {"pkt": 1, "qbuf": 0, "c_rtx": 0, "c_rcv": 0, "fl": 0}


def lb_state_to_numpy(lb_state, prefix: str = "lb_state") -> dict[str, np.ndarray]:
    """A load balancer's state as numpy arrays named by path (see above)."""
    out = {}
    _flatten(prefix, lb_state, out)
    return out


def _flatten(prefix: str, x, out: dict) -> None:
    if dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _flatten(f"{prefix}.{f.name}", getattr(x, f.name), out)
    elif isinstance(x, tuple):
        for i, v in enumerate(x):
            _flatten(f"{prefix}.{i}", v, out)
    else:
        out[prefix] = x.cpu().numpy()


def _unflatten(prefix: str, like, arrays: dict, t):
    if dataclasses.is_dataclass(like):
        return type(like)(**{f.name: _unflatten(f"{prefix}.{f.name}", getattr(like, f.name),
                                                arrays, t) for f in dataclasses.fields(like)})
    if isinstance(like, tuple):
        return tuple(_unflatten(f"{prefix}.{i}", v, arrays, t) for i, v in enumerate(like))
    return t(arrays[prefix])


def topology_spec_to_numpy(spec) -> dict:
    """A ``TopologySpec`` (the port's or the reference's: the same fields)
    as plain values: every table, the sizes, the diameter, the parameters
    and the regions as ``(name, base, size)`` tuples."""
    out = {f: np.asarray(getattr(spec, f)) for f in (
        "host_sw", "q_sw", "up_base", "up_deg", "down_next", "salt", "sw_up_span")}
    out.update({f: getattr(spec, f) for f in (
        "name", "params", "n_hosts", "n_tors", "n_switches", "n_queues", "t0_down_base",
        "diameter", "max_up_deg")})
    out["regions"] = [(r.name, r.base, r.size) for r in spec.regions]
    return out


def sim_state_to_numpy(state: SimState) -> dict[str, np.ndarray]:
    out = {}
    for name in STATE_FIELDS:
        leaf = getattr(state, name)
        if name == "lb_state":
            out.update(lb_state_to_numpy(leaf))
            continue
        arr = leaf.cpu().numpy()
        if name in _SENTINEL_AXIS:
            ax = _SENTINEL_AXIS[name]
            arr = np.take(arr, np.arange(arr.shape[ax] - 1), axis=ax)
        out[name] = arr
    return out


def sim_state_from_numpy(arrays: dict[str, np.ndarray], device=None, lb_like=None) -> SimState:
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.array(a), device=dev)  # a writable copy; 0-d stays 0-d
    leaves = {}
    for name in STATE_FIELDS:
        if name == "lb_state":
            if lb_like is None:
                lb_like = (torch.empty(0) if "lb_state" in arrays else
                           reps_core.REPSState(*([torch.empty(0)] * len(reps_core.FIELDS))))
            leaves[name] = _unflatten("lb_state", lb_like, arrays, t)
            continue
        arr = np.asarray(arrays[name])
        if name in _SENTINEL_AXIS:
            ax = _SENTINEL_AXIS[name]
            pad = [(0, 0)] * arr.ndim
            pad[ax] = (0, 1)
            arr = np.pad(arr, pad)
        leaves[name] = t(arr)
    return SimState(**leaves)
