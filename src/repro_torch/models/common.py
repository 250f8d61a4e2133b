"""Shared model components: norms, RoPE, initializers, dtype policy
(counterpart of ``repro.models.common``)."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import rng
from repro_torch.tree import tree_flatten_with_path, tree_map_with_path, tree_unflatten_like

# elements per threefry draw in dense_init: a chunk's int64 temporaries stay
# near 1 GiB on the card (gemma3-4b's embedding is 671 M values)
INIT_CHUNK = 1 << 24


def rms_norm(x, w, *, eps: float = 1e-6, plus_one: bool = False):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if plus_one else w.float()
    return (y * scale).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd) or (..., S, hd); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs  # (..., S, hd/2)
    while ang.ndim < x.ndim - 1:  # align S with x's seq axis (-3), broadcast heads
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_init(key, shape, in_axis_size=None, dtype=torch.float32, rows=None):
    """``normal(key, shape) / sqrt(fan_in)`` cast to ``dtype``, on the key's
    device, drawn in chunks of ``INIT_CHUNK`` elements of the flat index
    (the same values as one draw).  ``rows=(lo, hi)`` draws only rows
    ``lo:hi`` of the first dimension (the same values as those rows of the
    whole draw: threefry's draws are counter-based).  On the meta device
    there is nothing to draw."""
    shape = tuple(shape)
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(fan_in)))
    lo, hi = (0, shape[0]) if rows is None else rows
    out = torch.empty((hi - lo, *shape[1:]), dtype=dtype, device=key.device)
    if out.is_meta:  # shapes alone (``launch.roofline``, ``launch.dryrun``)
        return out
    flat = out.view(-1)
    n, first = out.numel(), lo * math.prod(shape[1:])
    for s in range(0, n, INIT_CHUNK):
        m = min(INIT_CHUNK, n - s)
        flat[s:s + m] = (rng.normal(key, (m,), start=first + s) * scale).to(dtype)
    return out


def split_keys(key, n):
    return list(rng.split(key, n))


def stack_layers(n_layers: int, layer_init) -> dict:
    """``layer_init(i)``'s trees for i < n_layers stacked along a leading L
    axis, as the reference stacks them for its scan; layer i is drawn and
    written into the stacked leaves before layer i + 1 is drawn."""
    stacked = None
    for i in range(n_layers):
        layer = layer_init(i)
        if stacked is None:
            stacked = tree_map_with_path(lambda _, x: x.new_empty((n_layers, *x.shape)), layer)
        _put(stacked, layer, i)
        del layer
    return stacked


def _put(dst: dict, src: dict, i: int) -> None:
    """``dst[...][i] = src[...]`` leaf by leaf over two nested dicts."""
    for k, v in src.items():
        if isinstance(v, dict):
            _put(dst[k], v, i)
        else:
            dst[k][i] = v


def unstack_layers(layers: dict) -> list[dict]:
    """The stacked layers as one tree per layer: each leaf is unbound once
    along L.  The layers are views; under autograd the backward of the
    unbind is one ``stack`` per leaf, where indexing layer by layer
    (``x[i]``) would give each layer's gradient a zero tensor of the whole
    stack's size, L of them summed."""
    flat = tree_flatten_with_path(layers)
    parts = {k: torch.unbind(v) for k, v in flat.items()}
    n = len(next(iter(parts.values())))
    return [tree_unflatten_like(layers, {k: v[i] for k, v in parts.items()}) for i in range(n)]


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``:
    save the result of a matrix product with no batch dimension (a
    projection), recompute everything else.  ``torch.einsum`` lowers a
    projection such as ``bsd,dhk->bshk`` to a ``bmm`` whose batch is 1, and
    the attention's score and value products and the MoE's per-expert
    products to ``bmm``s with a batch, so the batch size tells them apart."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = {None: None, "dots": _save_dots}


def remat(fn, *args, policy=None):
    """``fn(*args)`` with its activations recomputed in the backward (the
    counterpart of ``jax.checkpoint(fn, policy=...)``): ``policy`` None
    saves only the inputs, ``"dots"`` also the projections' outputs."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; expected one of "
                         f"{sorted(REMAT_POLICIES, key=str)}")
    save = REMAT_POLICIES[policy]
    if save is None:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(create_selective_checkpoint_contexts, save))


def lead_axes(axes):
    """A leading None (the stacked L axis) on every axes tuple of a tree."""
    if isinstance(axes, dict):
        return {k: lead_axes(v) for k, v in axes.items()}
    return (None, *axes)


def cast_tree(tree, dtype):
    return tree_map_with_path(
        lambda _, x: x.to(dtype) if x.is_floating_point() else x, tree)


# jax.nn's sigmoid, silu and softplus as XLA expands them: one rounding per
# operation in the input's dtype.  torch's fused forms round once, and in
# bfloat16 that difference, amplified through a recurrent stack, is the
# largest part of the port's distance from the reference.
def sigmoid(x):
    """``lax.logistic``: ``1 / (1 + exp(-x))``."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    return x * sigmoid(x)


def softplus(x):
    """``jnp.logaddexp(x, 0)``: ``max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def act_fn(name: str):
    if name in ("swiglu", "rwkv_ffn"):
        return silu
    if name == "geglu":  # jax.nn.gelu's default is the tanh form
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)
