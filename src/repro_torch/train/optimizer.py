"""AdamW with global-norm clipping and fp32 moments (counterpart of
``repro.train.optimizer``): explicit trees of tensors, ``m`` and ``v`` shaped
like the parameters, ``step`` a 0-d int32 tensor.

The arithmetic is the reference's as XLA:CPU compiles it inside the jitted
train step, which is not the expressions as written:

* XLA contracts four ``a*b + c`` sites into one fused multiply-add each:
  ``b1*m + (1-b1)*g``, ``b2*v + (1-b2)*g*g``, ``mh/(sqrt(vh)+eps) +
  wd*p`` and ``p - lr*delta``.  The port rounds each once (``_fma``).
* It rewrites ``(m/b1c) / (sqrt(v/b2c) + eps)`` as ``m / (b1c *
  (sqrt(v/b2c) + eps))``, and turns each division by a constant of the
  schedule into a multiplication by its float32 reciprocal; the port
  computes those forms.
* Its ``sqrt`` is correctly rounded; torch's vectorised CPU ``sqrt`` is
  not, so the port takes the root in float64 (``_sqrt``).

Given the same gradients, ``m`` and ``v`` then equal the reference's bit for
bit on the CPU and the parameters all but for an element in 2**29 or so
(a float64 sum rounded twice).  The schedule's cosine is torch's, which
is not XLA's: ``lr`` can differ by an ulp or two in the decay phase
(``tests/test_torch_optimizer.py`` counts them).

``apply_updates`` updates the parameters and the optimizer state in place
(the reference's train step donates both buffers) and works through each
leaf in chunks of ``CHUNK`` elements, so that its float64 temporaries stay
small beside a full-width model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.tree import tree_flatten_with_path, tree_map_with_path

CHUNK = 1 << 24  # elements per chunk of a leaf: ~128 MiB per float64 temporary


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(x: float) -> float:
    """``x`` rounded to float32 (the value a weakly typed constant takes)."""
    return float(np.float32(x))


def _fma(a, x: torch.Tensor, c) -> torch.Tensor:
    """float32 ``a * x + c`` rounded once: ``a`` (a float32 value or a 0-d
    float32 tensor) times ``x`` is exact in float64, and the float64 sum
    rounded to float32 is the fused result unless it falls within 2**-29
    of a float32 tie.  ``c``: a tensor or a float32 value."""
    if isinstance(a, torch.Tensor):
        a = a.double()
    return (x.double() * a + (c.double() if isinstance(c, torch.Tensor) else c)).float()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 ``sqrt`` correctly rounded (as XLA's): torch's vectorised CPU
    ``sqrt`` is within 0.5001 ulp, not exact; the float64 root of a float32
    value rounds to float32 exactly."""
    return torch.sqrt(x.double()).float()


def schedule(cfg: AdamWConfig, step):
    """Linear warmup to ``lr``, then a cosine decay to ``min_lr_frac * lr``
    at ``decay_steps``: a 0-d float32 tensor on ``step``'s device."""
    step = step.float()
    warm = step * _f32(1 / max(cfg.warmup_steps, 1))
    prog = torch.clamp(
        (step - cfg.warmup_steps) * _f32(1 / max(cfg.decay_steps - cfg.warmup_steps, 1)),
        0.0, 1.0)
    cos = torch.cos(prog * _f32(math.pi))
    # min_lr_frac + (1 - min_lr_frac) * 0.5 * (1 + cos), as XLA folds and contracts it
    frac = _fma(_f32(_f32(1 - cfg.min_lr_frac) * 0.5), cos + 1, _f32(cfg.min_lr_frac))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, frac)


def init_opt_state(params) -> dict[str, Any]:
    zeros = lambda t: tree_map_with_path(
        lambda _, p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), t)
    leaf = next(iter(tree_flatten_with_path(params).values()))
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def opt_state_axes(param_axes) -> dict[str, Any]:
    return {"m": param_axes, "v": param_axes, "step": ()}


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_flatten_with_path(tree).values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _local(t):
    """A DTensor's shard on this rank; a plain tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, opt_state):
    """One AdamW step, in place: ``params`` and ``opt_state``'s leaves are
    overwritten and returned.  Returns ``(params, opt_state, metrics)``,
    metrics ``grad_norm`` and ``lr`` (0-d float32 tensors).

    On DTensor leaves (a mesh) each gradient is first placed like its
    parameter (the data-parallel reduction), the global norm's sum is the
    one reduction across shards, and the update runs elementwise on each
    leaf's local shard."""
    params_flat = tree_flatten_with_path(params)
    grads = tree_map_with_path(
        lambda k, g: g.redistribute(g.device_mesh, params_flat[k].placements)
        if isinstance(g, DTensor) and g.placements != params_flat[k].placements else g, grads)
    step = _local(opt_state["step"]).add_(1)
    gnorm = global_norm(grads)
    if isinstance(gnorm, DTensor):
        gnorm = gnorm.full_tensor()
    # a division (``float / tensor`` would multiply by the reciprocal)
    scale = torch.clamp(gnorm.new_tensor(cfg.clip_norm) / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = 1 - torch.pow(_f32(cfg.b1), stepf)
    b2c = 1 - torch.pow(_f32(cfg.b2), stepf)
    c1, c2 = _f32(1 - cfg.b1), _f32(1 - cfg.b2)
    b1, b2, wd = _f32(cfg.b1), _f32(cfg.b2), _f32(cfg.weight_decay)

    flat_g = tree_flatten_with_path(grads)
    flat_m = tree_flatten_with_path(opt_state["m"])
    flat_v = tree_flatten_with_path(opt_state["v"])
    for path, p in params_flat.items():
        pf, gf = _local(p).view(-1), _local(flat_g[path]).reshape(-1)
        mf, vf = _local(flat_m[path]).view(-1), _local(flat_v[path]).view(-1)
        for s in range(0, pf.numel(), CHUNK):
            e = s + CHUNK
            g = gf[s:e].float() * scale
            m = _fma(b1, mf[s:e], g * c1)
            v = _fma(b2, vf[s:e], g * c2 * g)
            q = m / (b1c * (_sqrt(v / b2c) + cfg.eps))
            p32 = pf[s:e].float()
            delta = _fma(wd, p32, q)
            pf[s:e] = _fma(-lr, delta, p32)
            mf[s:e] = m
            vf[s:e] = v
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
