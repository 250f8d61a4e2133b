"""repro_torch.rng against jax.random, bit for bit (tolerance 0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import rng

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores


def _jkey(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 3, 12345, 2**31 - 1, -5])
def test_prngkey(seed):
    np.testing.assert_array_equal(rng.PRNGKey(seed, "cpu").numpy(), _jkey(jax.random.PRNGKey(seed)))


def test_fold_in_and_split():
    jk, tk = jax.random.PRNGKey(7), rng.PRNGKey(7, "cpu")
    for data in [0, 1, 2, 3, 4, 5, 777, 123456, 2**31 - 1]:
        np.testing.assert_array_equal(rng.fold_in(tk, data).numpy(), _jkey(jax.random.fold_in(jk, data)))
    for num in [2, 3, 5]:
        np.testing.assert_array_equal(rng.split(tk, num).numpy(), _jkey(jax.random.split(jk, num)))


def test_nested_fold_in_tick_ack_round():
    """The engine's on_ack keys: fold(fold(fold(base, tick), 4), round),
    derived for many ticks at once."""
    jbase, tbase = jax.random.PRNGKey(3), rng.PRNGKey(3, "cpu")
    ticks = torch.arange(0, 400, 37)
    tk = rng.fold_in(rng.fold_in(rng.fold_in(tbase, ticks), 4)[:, None, :], torch.arange(2)[None, :])
    for i, t in enumerate(ticks.tolist()):
        for r in range(2):
            want = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(jbase, t), 4), r)
            np.testing.assert_array_equal(tk[i, r].numpy(), _jkey(want))


@pytest.mark.parametrize("evs_size", [256, 65536])
@pytest.mark.parametrize("shape", [(1,), (127,), (480,), (512,)])
def test_randint(evs_size, shape):
    for seed in (0, 9):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
        tk = rng.fold_in(rng.PRNGKey(seed, "cpu"), 2)
        want = np.asarray(jax.random.randint(jk, shape, 0, evs_size, jnp.int32))
        got = rng.randint(tk, shape, 0, evs_size)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_randint_other_spans():
    jk, tk = jax.random.PRNGKey(1), rng.PRNGKey(1, "cpu")
    for lo, hi in [(0, 7), (0, 1000), (5, 100003), (-3, 3), (4, 4)]:
        want = np.asarray(jax.random.randint(jk, (300,), lo, hi, jnp.int32))
        np.testing.assert_array_equal(rng.randint(tk, (300,), lo, hi).numpy(), want)


@pytest.mark.parametrize("shape", [(1,), (96,), (384,), (512,)])
def test_uniform_float32(shape):
    for seed in (0, 4):
        jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), 11), 1)
        tk = rng.fold_in(rng.fold_in(rng.PRNGKey(seed, "cpu"), 11), 1)
        want = np.asarray(jax.random.uniform(jk, shape))
        got = rng.uniform(tk, shape)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_batched_draws_equal_per_tick_draws():
    """A (T, n) draw from T keys is row for row the per-key draw."""
    tbase = rng.PRNGKey(5, "cpu")
    keys = rng.fold_in(tbase, torch.arange(6))
    u = rng.uniform(rng.fold_in(keys, 1), (33,))
    r = rng.randint(rng.fold_in(keys, 2), (17,), 0, 256)
    for t in range(6):
        kt = rng.fold_in(tbase, t)
        torch.testing.assert_close(u[t], rng.uniform(rng.fold_in(kt, 1), (33,)), rtol=0, atol=0)
        torch.testing.assert_close(r[t], rng.randint(rng.fold_in(kt, 2), (17,), 0, 256), rtol=0, atol=0)


@pytest.mark.parametrize("evs_size", [256, 65536])
@pytest.mark.parametrize("shape", [(48, 8), (128, 4), (5, 3), (1, 1)])
def test_randint_2d(evs_size, shape):
    """MPTCP's (N, subflows) and the flowlet table's (N, table) draws: the
    row-major flattening equals JAX's partitionable counter layout."""
    for seed in (0, 7):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
        tk = rng.fold_in(rng.PRNGKey(seed, "cpu"), 5)
        want = np.asarray(jax.random.randint(jk, shape, 0, evs_size, jnp.int32))
        got = rng.randint(tk, shape, 0, evs_size)
        assert tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)
        batched = rng.randint(torch.stack([tk, tk]), shape, 0, evs_size)  # (2, *shape)
        np.testing.assert_array_equal(batched[1].numpy(), want)


def test_split_four_and_nested_split_draws():
    """BitmapLB's ``split(key, 4)`` resample keys and MPRDMA's / MixedLB's
    ``split(key)`` then ``randint`` on each half, batched over ticks."""
    jk, tk = jax.random.PRNGKey(11), rng.PRNGKey(11, "cpu")
    np.testing.assert_array_equal(rng.split(tk, 4).numpy(), _jkey(jax.random.split(jk, 4)))
    keys = rng.fold_in(tk, torch.arange(3))  # three ticks
    draws = rng.randint(rng.split(keys, 4), (40,), 0, 256)  # (3, 4, 40)
    for t in range(3):
        for i, k in enumerate(jax.random.split(jax.random.fold_in(jk, t), 4)):
            want = np.asarray(jax.random.randint(k, (40,), 0, 256, jnp.int32))
            np.testing.assert_array_equal(draws[t, i].numpy(), want)
