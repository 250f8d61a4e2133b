"""Carry a parameter tree between the packages: the reference's tree as
numpy arrays (``jax.tree.map(np.asarray, params)``) -> the port's, with the
same nested keys, shapes and dtypes."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map_with_path


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """One array; bfloat16 (``ml_dtypes``, which numpy does not know) goes
    through its bits."""
    a = np.array(a, copy=True, order="C")  # writable: a JAX array's view is not
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device=None):
    """The port's parameter tree on ``device`` (the card unless
    ``device="cpu"``) from a nested dict of numpy arrays."""
    dev = resolve_device(device)
    return tree_map_with_path(lambda _, a: tensor_from_numpy(np.asarray(a), dev), tree)


def train_state_from_numpy(params_np, opt_np, device=None):
    """The port's ``(params, opt_state)`` on ``device`` from the reference's
    as numpy: ``opt_np`` is ``{"m": tree, "v": tree, "step": 0-d int32}``
    (``init_opt_state``'s structure)."""
    if np.asarray(opt_np["step"]).shape != () or np.asarray(opt_np["step"]).dtype != np.int32:
        raise ValueError("opt_state['step'] must be a 0-d int32 array")
    return params_from_numpy(params_np, device), params_from_numpy(opt_np, device)
