"""The port's balls-into-bins models (repro_torch.core.balls_bins) against
the reference's (repro.core.balls_bins) on the CPU, every output field bit
for bit (tolerance 0), and the Theorem 5.1 property tests repeated on the
port.  ``rng.bernoulli`` against ``jax.random.bernoulli``."""
import jax
import numpy as np
import pytest
import torch

from repro.core import balls_bins as jbb
from repro_torch import rng
from repro_torch.core import balls_bins as tbb

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

OPS_CASES = [(8, 0.99, 400), (32, 0.5, 600), (32, 1.0, 300), (128, 0.99, 200)]
# (n_bins, b, tau, steps, queue_cap, coalesce): the default cap; a small cap
# that one step's arrivals can wrap (repeated enqueue slots); coalescing
REC_CASES = [
    (8, 5, 8, 400, 0, 1), (32, 9, 13, 400, 0, 1), (32, 9, 13, 300, 16, 2),
    (16, 3, 2, 300, 8, 4), (32, 9, 13, 300, 0, 8), (128, 12, 19, 120, 0, 1),
]
EVS_CASES = [(32, 16, 1, 8), (32, 256, 32, 4), (8, 4096, 1, 5), (32, 2**12, 1, 3)]
SEEDS = (0, 1, 7)


def _key(seed):
    return rng.PRNGKey(seed, "cpu")


@pytest.mark.parametrize("p", [0.99, 0.5, 1.0, 0.0, 1 / 3, 1e-3])
@pytest.mark.parametrize("shape", [(1,), (257,), (4, 33)])
def test_bernoulli_matches_jax(p, shape):
    for seed in (0, 5):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
        want = np.asarray(jax.random.bernoulli(jk, p, shape))
        got = rng.bernoulli(rng.fold_in(_key(seed), 0), p, shape)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)


def test_bernoulli_batched_keys_are_rows():
    keys = rng.split(_key(3), 6)
    got = rng.bernoulli(keys, 0.7, (50,))
    for i in range(6):
        jk = jax.random.split(jax.random.PRNGKey(3), 6)[i]
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(jax.random.bernoulli(jk, 0.7, (50,))))


@pytest.mark.parametrize("case", OPS_CASES, ids=lambda c: f"n{c[0]}-lam{c[1]}-s{c[2]}")
def test_ops_bins_matches_reference(case):
    n, lam, steps = case
    for seed in SEEDS:
        want = np.asarray(jbb.simulate_ops_bins(jax.random.PRNGKey(seed), n, lam, steps))
        got = tbb.simulate_ops_bins(_key(seed), n, lam, steps, device="cpu")
        assert got.dtype == torch.int32 and got.shape == (steps,)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", REC_CASES, ids=lambda c: "-".join(map(str, c)))
def test_recycled_bins_matches_reference(case):
    n, b, tau, steps, cap, co = case
    for seed in SEEDS:
        want = jbb.simulate_recycled_bins(jax.random.PRNGKey(seed), n, b, tau, steps, cap, co)
        got = tbb.simulate_recycled_bins(_key(seed), n, b, tau, steps, cap, co, device="cpu")
        assert got._fields == want._fields
        for f in want._fields:
            g = getattr(got, f)
            w = np.asarray(getattr(want, f))
            assert g.dtype == {"frac_remember": torch.float32}.get(f, torch.int32), f
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{f} seed {seed}")


def test_recycled_bins_resolves_repeated_scatter_indices_as_the_reference():
    """The two scatters with repeated indices matter: resolving them the
    other way (the lowest bin id / the first ball wins) gives other numbers
    than JAX on these seeds, and the port's rule gives JAX's."""
    n, b, tau, steps = 16, 3, 2, 300
    src = open(tbb.__file__).read()
    alt = (src.replace('"amax", include_self=True', '"amin", include_self=False')
              .replace("last = rank >= count[t64] - cap", "last = rank < cap"))
    assert alt != src
    ns: dict = {"__name__": "alt_balls_bins"}
    exec(compile(alt, "alt_balls_bins", "exec"), ns)
    differs = 0
    for seed in range(4):
        want = jbb.simulate_recycled_bins(jax.random.PRNGKey(seed), n, b, tau, steps, 8, 1)
        other = ns["simulate_recycled_bins"](_key(seed), n, b, tau, steps, 8, 1, device="cpu")
        differs += not np.array_equal(other.max_load.numpy(), np.asarray(want.max_load))
    assert differs > 0


@pytest.mark.parametrize("case", EVS_CASES, ids=lambda c: "-".join(map(str, c)))
def test_evs_load_imbalance_matches_reference(case):
    ports, evs, flows, trials = case
    for seed in SEEDS[:2]:
        want = np.asarray(jbb.evs_load_imbalance(jax.random.PRNGKey(seed), ports, evs, flows, trials))
        got = tbb.evs_load_imbalance(_key(seed), ports, evs, flows, trials, device="cpu")
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_evs_load_imbalance_chunks_trials(monkeypatch):
    """Trials drawn a few per pass give the one-pass numbers."""
    want = tbb.evs_load_imbalance(_key(2), 32, 256, 8, 7, device="cpu")
    monkeypatch.setattr(tbb, "TRIAL_DRAWS", 2 * 256 * 8)
    got = tbb.evs_load_imbalance(_key(2), 32, 256, 8, 7, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# --- tests/test_property_reps.py's Theorem 5.1 tests, on the port -----------
def test_theorem51_recycled_bins_bounded_on_the_port():
    n = 32
    tau = int(4 * np.log(n))
    b = int(np.ceil(2.4 * np.log(n)))
    tr = tbb.simulate_recycled_bins(_key(0), n, b, tau, steps=4000, device="cpu")
    ops_ml = tbb.simulate_ops_bins(_key(0), n, 0.99, 4000, device="cpu")
    ml = tr.max_load.numpy()
    assert int(ml[-1]) <= 3 * tau
    assert int(ml[2000:].max()) <= 3 * tau
    assert int(ops_ml[-1]) > 3 * tau
    assert float(tr.frac_remember[-1]) > 0.3


def test_ops_bins_stable_below_capacity_on_the_port():
    ml = tbb.simulate_ops_bins(_key(1), 32, 0.5, 3000, device="cpu")
    assert int(ml[-1]) < 20


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbb.simulate_ops_bins(_key(0), 8, 0.5, 10)
