"""The reference's MoE routing, recomputed by the lines of its
``_moe_local`` (``src/repro/models/mlp.py``): top-k of the float32
softmax of the router logits, each flat assignment's slot by the cumsum
over the token-major order, kept below ``cap``.  The reference returns
only the layer's output and aux loss; the port's tests compare its routing
with this."""
import jax
import jax.numpy as jnp
import numpy as np
from repro.models import mlp as j_mlp


def reference_routing(x, p, cfg):
    """``(probs (T, E), ids (T, k), keep (T*k,))`` of the reference's MoE
    layer on ``x (B, S, d)`` with layer params ``p``, as JAX arrays (usable
    under ``jit``)."""
    T, E, k = x.shape[0] * x.shape[1], cfg.n_experts, cfg.top_k
    logits = jnp.einsum("td,de->te", x.reshape(T, -1), p["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, ids = jax.lax.top_k(probs, k)
    flat = ids.reshape(-1)
    cap = max(int((T * k / E) * cfg.moe_capacity) + 1, min(T * k, 32))
    onehot = jax.nn.one_hot(flat, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - onehot, flat[:, None], 1)[:, 0]
    return probs, ids, pos < cap


def recording_moe_local(calls: list):
    """The reference's ``_moe_local`` that also hands each call's routing
    to the host (appended to ``calls`` as numpy), for patching over
    ``repro.models.mlp._moe_local`` while a run is traced."""
    orig = j_mlp._moe_local

    def rec(x, p, cfg, n_shards, shard_idx):
        out = orig(x, p, cfg, n_shards, shard_idx)
        jax.debug.callback(lambda *a: calls.append(tuple(map(np.asarray, a))),
                           *reference_routing(x, p, cfg), ordered=True)
        return out

    return rec
