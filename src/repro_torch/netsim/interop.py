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

The load balancer's state is one entry ``"lb_state"`` when it is a single
array (ECMP, OPS) and one entry ``"lb_state.<field>"`` per ``REPSState``
field for REPS.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import reps as reps_core
from repro_torch.device import resolve_device
from repro_torch.netsim.engine import STATE_FIELDS, SimState

# leaves carrying a sentinel slot: field -> (axis, padded slot count)
_SENTINEL_AXIS = {"pkt": 1, "qbuf": 0, "c_rtx": 0, "c_rcv": 0, "fl": 0}


def sim_state_to_numpy(state: SimState) -> dict[str, np.ndarray]:
    out = {}
    for name in STATE_FIELDS:
        leaf = getattr(state, name)
        if name == "lb_state":
            if isinstance(leaf, reps_core.REPSState):
                for f in reps_core.FIELDS:
                    out[f"lb_state.{f}"] = getattr(leaf, f).cpu().numpy()
            else:
                out["lb_state"] = leaf.cpu().numpy()
            continue
        arr = leaf.cpu().numpy()
        if name in _SENTINEL_AXIS:
            ax = _SENTINEL_AXIS[name]
            arr = np.take(arr, np.arange(arr.shape[ax] - 1), axis=ax)
        out[name] = arr
    return out


def sim_state_from_numpy(arrays: dict[str, np.ndarray], device=None) -> SimState:
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.array(a), device=dev)  # a writable copy; 0-d stays 0-d
    leaves = {}
    for name in STATE_FIELDS:
        if name == "lb_state":
            if "lb_state" in arrays:
                leaves[name] = t(arrays["lb_state"])
            else:
                leaves[name] = reps_core.REPSState(
                    **{f: t(arrays[f"lb_state.{f}"]) for f in reps_core.FIELDS}
                )
            continue
        arr = np.asarray(arrays[name])
        if name in _SENTINEL_AXIS:
            ax = _SENTINEL_AXIS[name]
            pad = [(0, 0)] * arr.ndim
            pad[ax] = (0, 1)
            arr = np.pad(arr, pad)
        leaves[name] = t(arr)
    return SimState(**leaves)
