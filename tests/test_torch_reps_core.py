"""repro_torch.core.reps against the reference's JAX functions and its
scalar oracle of the paper's pseudocode (tolerance 0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reps as jreps
from repro_torch import rng
from repro_torch.core import reps as treps
from repro_torch.core.load_balancers import RepsLB

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

FIELDS = treps.FIELDS


def _np(state):
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


def _assert_same(t_state, j_state, where):
    a, b = _np(t_state), _np(j_state)
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{where}: {f}")


@pytest.mark.parametrize("num_pkts_bdp,freezing_timeout", [(32, 1024), (4, 50)])
def test_vectorized_steps_match_jax(num_pkts_bdp, freezing_timeout):
    """Random ACK / timeout / send streams through both implementations,
    with keys drawn the reference's way for the explore EVs."""
    N, steps = 64, 120
    jcfg = jreps.REPSConfig(evs_size=256, num_pkts_bdp=num_pkts_bdp,
                            freezing_timeout=freezing_timeout)
    tcfg = treps.REPSConfig(evs_size=256, num_pkts_bdp=num_pkts_bdp,
                            freezing_timeout=freezing_timeout)
    js, ts = jreps.init_state(jcfg, N), treps.init_state(tcfg, N, device="cpu")
    rs = np.random.RandomState(num_pkts_bdp)
    jkey, tkey = jax.random.PRNGKey(0), rng.PRNGKey(0, "cpu")
    for now in range(steps):
        ack = rs.rand(N) < 0.5
        ev = rs.randint(0, 256, size=N).astype(np.int32)
        ecn = rs.rand(N) < 0.2
        to = rs.rand(N) < 0.08
        send = rs.rand(N) < 0.7
        js = jreps.on_ack(jcfg, js, ack, ev, ecn, jnp.int32(now))
        ts = treps.on_ack(tcfg, ts, torch.as_tensor(ack), torch.as_tensor(ev), torch.as_tensor(ecn), now)
        _assert_same(ts, js, f"on_ack t={now}")
        js = jreps.on_failure_detection(jcfg, js, to, jnp.int32(now))
        ts = treps.on_failure_detection(tcfg, ts, torch.as_tensor(to), now)
        _assert_same(ts, js, f"on_failure_detection t={now}")
        jk = jax.random.fold_in(jkey, now)
        jev, js = jreps.choose_ev(jcfg, js, send, jk)
        tev, ts = treps.choose_ev(tcfg, ts, torch.as_tensor(send), rng.fold_in(tkey, now))
        _assert_same(ts, js, f"choose_ev t={now}")
        np.testing.assert_array_equal(tev.numpy()[send], np.asarray(jev)[send])
    assert bool(ts.is_freezing.any()) or bool((ts.exit_freezing > 0).any())


def test_matches_scalar_oracle():
    """The vectorized algorithm per connection equals the paper's pseudocode."""
    N, steps = 16, 200
    cfg = treps.REPSConfig(evs_size=1 << 16, num_pkts_bdp=6, freezing_timeout=20)
    oracles = [treps.REPSOracle(cfg) for _ in range(N)]
    ts = treps.init_state(cfg, N, device="cpu")
    rs = np.random.RandomState(1)
    for now in range(steps):
        ack, ecn, to, send = (rs.rand(N) < p for p in (0.6, 0.2, 0.1, 0.7))
        ev = rs.randint(0, 1 << 16, size=N).astype(np.int32)
        rand_ev = rs.randint(0, 1 << 16, size=N).astype(np.int32)
        ts = treps.on_ack(cfg, ts, torch.as_tensor(ack), torch.as_tensor(ev), torch.as_tensor(ecn), now)
        ts = treps.on_failure_detection(cfg, ts, torch.as_tensor(to), now)
        evs, ts = treps.choose_ev(cfg, ts, torch.as_tensor(send), rand_ev=torch.as_tensor(rand_ev))
        for i, o in enumerate(oracles):
            if ack[i]:
                o.on_ack(int(ev[i]), bool(ecn[i]), now)
            if to[i]:
                o.on_failure_detection(now)
            if send[i]:
                assert int(evs[i]) == o.on_send(int(rand_ev[i])), (now, i)
        for i, o in enumerate(oracles):
            assert ts.buf_ev[i].tolist() == o.buf_ev
            assert ts.buf_valid[i].tolist() == o.buf_valid
            assert (int(ts.head[i]), int(ts.num_valid[i]), int(ts.explore_counter[i]),
                    bool(ts.is_freezing[i]), int(ts.exit_freezing[i])) == (
                o.head, o.num_valid, o.explore_counter, o.is_freezing, o.exit_freezing)


def test_pack_state_is_byte_identical_and_round_trips():
    N = 50
    rs = np.random.RandomState(3)
    fields = dict(
        buf_ev=rs.randint(0, 65536, size=(N, 8)).astype(np.int32),
        buf_valid=rs.rand(N, 8) < 0.5,
        head=rs.randint(0, 8, size=N).astype(np.int32),
        num_valid=rs.randint(0, 9, size=N).astype(np.int32),
        explore_counter=rs.randint(0, 33, size=N).astype(np.int32),
        is_freezing=rs.rand(N) < 0.5,
        exit_freezing=rs.randint(0, 2**31 - 1, size=N).astype(np.int32),
        n_cached=rs.randint(0, 2, size=N).astype(np.int32),
    )
    jcfg, tcfg = jreps.REPSConfig(), treps.REPSConfig()
    js = jreps.REPSState(**{k: jnp.asarray(v) for k, v in fields.items()})
    ts = treps.REPSState(**{k: torch.as_tensor(v) for k, v in fields.items()})
    packed = treps.pack_state(tcfg, ts)
    np.testing.assert_array_equal(packed, jreps.pack_state(jcfg, js))
    assert packed.shape == (N, 25)
    _assert_same(treps.unpack_state(tcfg, packed, device="cpu"), js, "round trip")
    assert treps.state_footprint_bits(tcfg) == jreps.state_footprint_bits(jcfg)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_reps_lb_refuses_other_ring_depths_where_the_kernel_runs(device):
    """The reps_tick kernel is compiled for an 8-deep ring.  State on a CUDA
    device steps through the kernel, so there a RepsLB of another depth
    raises instead of stepping REPS on the card without it; state on the CPU
    steps through the kernel's plain version, which takes any depth.  The
    device alone decides (no device is needed to ask)."""
    dev = torch.device(device)
    assert RepsLB(buffer_size=8).uses_kernel(dev) == (device == "cuda")
    lb = RepsLB(buffer_size=4)
    if device == "cuda":
        with pytest.raises(ValueError, match="buffer depth 8"):
            lb.uses_kernel(dev)
        return
    assert not lb.uses_kernel(dev)
    state = lb.init_state(6, rng.PRNGKey(0, "cpu"))
    assert tuple(state.buf_ev.shape) == (6, 4)
    send = torch.ones(6, dtype=torch.bool)
    evs, state = lb.choose_ev(state, send, torch.arange(6, dtype=torch.int32), 0)
    assert evs.tolist() == list(range(6))  # nothing cached yet: every send explores
