# Frozen copy of the port's plain formulation (src/repro_torch/rng.py), imports
# rewritten to this package; the benchmark's reference.  Do not edit.
"""Bit-exact threefry2x32 draws, as the reference's ``jax.random`` makes them.

The JAX package draws all of its randomness from ``jax.random`` with the
``threefry2x32`` implementation in its *partitionable* mode (the default of
the JAX it was pinned to).  The port must reproduce those bits exactly —
a ``torch.Generator`` gives other numbers from the same seed — so this
module re-implements the five calls the simulator makes:

  ``PRNGKey``  key = (seed >> 32, seed & 0xFFFFFFFF)
  ``fold_in``  key' = threefry(key, (0, data))
  ``split``    key_i = threefry(key, (0, i))              (fold-like split)
  ``random_bits``  bits_i = xor of threefry(key, (i >> 32, i & 0xFFFFFFFF))
  ``randint`` / ``uniform``  JAX's ``_randint`` / ``_uniform`` on those bits.
  ``normal``  JAX's ``_normal_real``: a uniform draw on ``[nextafter(-1, 0), 1)``
              then ``sqrt(2) * erfinv`` (torch's ``erfinv`` is not XLA's: the
              draws agree to ~2e-5, not bit for bit).

A key is an ``int64`` tensor whose last axis has length 2 and holds the two
uint32 words.  Torch has little uint32 arithmetic, so every word is kept in
an ``int64`` lane and masked with ``& 0xFFFFFFFF`` after each add or shift;
multiplications by 32-bit constants are split into 16-bit halves so that no
product leaves the int64 range.  Every function is batched over the leading
axes of its key: ``fold_in(keys (T, 2), 1)`` derives T keys at once, and
``uniform(keys (T, 2), (n,))`` makes a ``(T, n)`` draw — row ``t`` equal to
``uniform(keys[t], (n,))``.  The engine relies on that to draw a whole chunk
of ticks in one pass (the draws depend on the tick, never on the state).
"""
from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher, 20 rounds, on broadcastable int64
    tensors holding uint32 words (``jax._src.prng._threefry2x32_lowering``)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & M32, (x2 + ks[1]) & M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & M32
    return x[0], x[1]


def _mulmod32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for uint32 words without leaving int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: words (0, seed)."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} is outside the int32 range JAX accepts")
    return torch.tensor([0, seed & M32], dtype=torch.int64, device=device)


def _words(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if key.shape[-1] != 2:
        raise ValueError(f"a key's last axis holds 2 words, got shape {tuple(key.shape)}")
    return key[..., 0], key[..., 1]


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``data`` (an int or an integer tensor that
    broadcasts against the key's leading axes) is taken as uint32."""
    k1, k2 = _words(key)
    if isinstance(data, torch.Tensor):
        d = data.to(device=key.device, dtype=torch.int64) & M32
    else:
        d = torch.full_like(k1, int(data) & M32)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> ``(..., num, 2)`` keys (on the meta
    device, their shape alone)."""
    if key.is_meta:
        return key.new_empty((*key.shape[:-1], num, 2))
    k1, k2 = _words(key)
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(k1[..., None], k2[..., None], torch.zeros_like(i), i)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def random_bits(key: torch.Tensor, shape, start: int = 0) -> torch.Tensor:
    """32 random bits per element (``_threefry_random_bits_partitionable``),
    as int64 in ``[0, 2**32)``, shaped ``key.shape[:-1] + shape``.  Element
    ``i`` depends on the key and its flat index alone, so ``start`` draws
    the elements ``start, start + 1, ...`` of any larger draw (a draw made
    in chunks equals the draw made at once)."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    k1, k2 = _words(key)
    i = torch.arange(start, start + n, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(k1[..., None], k2[..., None], i >> 32, i & M32)
    return (y1 ^ y2).reshape(*key.shape[:-1], *shape)


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``.

    JAX splits the key in two, draws 32 bits from each, and folds the pair
    into ``[0, span)`` as ``((hi % span) * mult + lo % span) % span`` in
    wrapping uint32 arithmetic, with ``mult = (2**16 % span)**2 % span``
    whose square also wraps (``jax._src.random._randint``).
    """
    minval, maxval = int(minval), int(maxval)
    span = maxval - minval if maxval > minval else 1
    ks = split(key, 2)
    hi = random_bits(ks[..., 0, :], shape)
    lo = random_bits(ks[..., 1, :], shape)
    mult = ((2**16 % span) ** 2 & M32) % span  # the square wraps in uint32, as in JAX
    off = (_mulmod32(hi % span, mult) + lo % span) & M32
    return (minval + off % span).to(torch.int32)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 over ``[0, 1)``: the
    top 23 bits become the mantissa of a float in ``[1, 2)``, minus one."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(f, min=0.0)


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a float ``p`` (the
    ``"low"`` mode): a float32 ``uniform`` draw compared ``< p`` with ``p``
    rounded to float32, as JAX converts it to the draw's dtype."""
    p32 = torch.tensor(float(p), dtype=torch.float32).item()
    return uniform(key, shape) < p32


# jax.random.normal's uniform range in float32: [nextafter(-1, 0), 1); its
# width 1 - lo rounds to 2.0
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_NORMAL_SPAN = float(np.float32(1.0) - np.float32(_NORMAL_LO))
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(key: torch.Tensor, shape, start: int = 0) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32 (``_normal_real``): the
    uniform draw ``max(lo, f * (1 - lo) + lo)`` over the mantissa float
    ``f`` in ``[0, 1)``, then ``sqrt(2) * erfinv``.  ``start`` as in
    ``random_bits``: large draws are made in chunks of the flat index."""
    bits = random_bits(key, shape, start)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(f * _NORMAL_SPAN + _NORMAL_LO, min=_NORMAL_LO)
    return torch.erfinv(u) * _SQRT2
