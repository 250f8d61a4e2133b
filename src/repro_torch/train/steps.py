"""Serve steps (counterpart of ``repro.train.steps``' ``make_serve_steps``)
for every family ``build_model`` builds; the train step comes with the
training slice (ROADMAP item 14)."""
from __future__ import annotations

import torch

from repro_torch.models.common import cast_tree
from repro_torch.models.model_zoo import Model


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
