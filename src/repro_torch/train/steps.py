"""Train and serve steps (counterpart of ``repro.train.steps``) for every
family ``build_model`` builds.

train_step: the gradient of the model loss with mixed precision (fp32
master weights cast to ``compute_dtype`` for the forward and backward),
optional microbatch gradient accumulation (a loop over microbatches, the
reference's ``lax.scan``), then the AdamW update.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.common import cast_tree
from repro_torch.models.model_zoo import Model
from repro_torch.train.optimizer import AdamWConfig, apply_updates, init_opt_state
from repro_torch.tree import tree_flatten_with_path, tree_unflatten_like


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    compute_dtype: Any = torch.bfloat16
    remat: bool = True
    remat_policy: Optional[str] = None  # None | "dots"
    microbatches: int = 1  # gradient-accumulation factor


def make_grad_fn(model: Model, tcfg: TrainConfig):
    """Returns ``grad_fn(params, batch) -> (loss, metrics, grads)``: the
    train step's loss and its gradient with respect to ``params`` (fp32
    master weights cast to ``tcfg.compute_dtype`` inside, so the gradients
    come back in the params' dtype), as ``{path: tensor}`` of the leaves
    (``repro_torch.tree`` paths)."""

    def grad_fn(params, batch):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in tree_flatten_with_path(params).items()}
        with torch.enable_grad():
            # The reference puts an optimization barrier here so that XLA
            # casts the parameters once per step; eager PyTorch
            # materialises the cast copy once per call anyway.
            p = cast_tree(tree_unflatten_like(params, leaves), tcfg.compute_dtype)
            b = dict(batch)
            if "embeds" in b:
                b["embeds"] = b["embeds"].to(tcfg.compute_dtype)
            loss, metrics = model.loss_fn(p, b, remat=tcfg.remat,
                                          remat_policy=tcfg.remat_policy)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(zip(leaves, grads))

    return grad_fn


def _microbatch(v, n: int, i: int):
    """Microbatch ``i`` of ``n``: rows ``i * m`` to ``(i + 1) * m`` of ``v``.
    Over a DTensor sharded by rows it is every ``n``-th row from ``i``
    instead, so that each microbatch stays spread over the shards (the
    microbatches' sum is the same)."""
    if isinstance(v, DTensor):
        return v.reshape(v.shape[0] // n, n, *v.shape[1:])[:, i]
    return v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]


def make_train_step(model: Model, tcfg: TrainConfig):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  It updates ``params`` and ``opt_state`` in place (the
    counterpart of the reference launcher's ``donate_argnums=(0, 1)``):
    pass copies to keep the originals.  ``metrics``: ``loss``,
    ``grad_norm``, ``lr``, and with one microbatch ``xent`` and ``aux``
    (0-d tensors)."""
    grad_of = make_grad_fn(model, tcfg)

    def train_step(params, opt_state, batch):
        n = tcfg.microbatches
        if n > 1:
            for i in range(n):
                part = {k: _microbatch(v, n, i) for k, v in batch.items()}
                loss, _, g = grad_of(params, part)
                if i == 0:
                    grads, lsum = g, loss
                else:
                    for k, v in g.items():
                        grads[k].add_(v)
                    lsum = lsum + loss
            # XLA turns the division by the constant n into a multiplication
            # by its float32 reciprocal
            for v in grads.values():
                v.mul_(1.0 / n)
            loss, metrics = lsum * (1.0 / n), {}
        else:
            loss, metrics, grads = grad_of(params, batch)
        params, opt_state, opt_metrics = apply_updates(
            tcfg.opt, params, tree_unflatten_like(params, grads), opt_state)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_serve_steps(model: Model):
    """Returns (prefill_step, decode_step) for batched serving: both run on
    the params cast to bfloat16 (a no-op for bfloat16 params), and decode
    returns ``cache_len + 1``.  The cache is the family's decode state: the
    KV cache of a transformer, RWKV's ``wkv`` / token-shift state, Zamba's
    SSM / conv state and shared-attention ring."""

    def prefill_step(params, batch, max_len: int):
        return model.prefill_fn(cast_tree(params, torch.bfloat16), batch, max_len)

    def decode_step(params, state, tokens, cache_len):
        logits, state = model.decode_fn(cast_tree(params, torch.bfloat16), state, tokens,
                                        cache_len)
        return logits, state, cache_len + 1

    return prefill_step, decode_step


def init_train_state(model: Model, key, dtype=torch.float32):
    """``(params, opt_state)`` from ``key`` on the key's device."""
    params = model.init_params(key, dtype)
    return params, init_opt_state(params)
