"""fig15's forced freeze on the port: ``RepsLB``'s ``after_acks`` hook.

The reference's ``ForcedFreezeReps`` overrides ``on_ack``, which the port's
fused ``RepsLB.step`` never calls; the port's applies
``on_failure_detection`` to every connection through the hook, once after
tick ``force_at``'s ACK rounds (the reference does so after each round; for
an all-connections mask at one ``now`` the two orders give the same state).
Held here: every ``SimState`` leaf equal to JAX's ``ForcedFreezeReps``
across ``force_at``, run straight and continued across F; every connection
that could enter freezing at F is freezing after it; one ``reps_tick``
launch per tick without the hook and one more at F with it; an
``on_ack``-only subclass raises; and fig15's two cells at a cut horizon
past F = 900 equal the reference module's."""
import pytest
import torch

from benchmarks.fig15_forced_freezing import ForcedFreezeReps as JForcedFreezeReps
from figure_runs import assert_runs_equal
from repro.configs.arcane_paper import FATTREE_32_CI as J_CFG
from repro.netsim import Simulator as JSimulator
from repro.netsim import workloads as jwl
from repro_torch.bench.fig15_forced_freezing import ForcedFreezeReps
from repro_torch.configs.arcane_paper import FATTREE_32_CI as T_CFG
from repro_torch.core.load_balancers import RepsLB
from repro_torch.kernels import ops as kernel_ops
from repro_torch.netsim import Simulator, interop, workloads
from repro_torch.netsim.engine import add_rows, drop_rows
from test_torch_netsim import assert_states_equal, jax_state_to_numpy

TICKS = 300
MSG = 96  # tornado messages still in flight past every F below


def _sim(lb):
    return Simulator(T_CFG, workloads.tornado(T_CFG.n_hosts, MSG), lb, device="cpu")


def _run(sim, n, state, t0):
    st, _ = sim.run_rows(n, add_rows(state), sim.base_key[None], t0=t0)
    return drop_rows(st)


@pytest.mark.parametrize("force_at", [40, 260])
def test_forced_freeze_equals_reference_across_force_at(force_at):
    jlb = JForcedFreezeReps(force_at=force_at, evs_size=J_CFG.evs_size)
    jst, _ = JSimulator(J_CFG, jwl.tornado(J_CFG.n_hosts, MSG), jlb).run(TICKS)
    sim = _sim(ForcedFreezeReps(force_at=force_at, evs_size=T_CFG.evs_size))
    # ticks [0, F), then F, then the rest (chunks tile a run bit-exactly)
    before = _run(sim, force_at, sim.init_state(), 0)
    after = _run(sim, 1, before, force_at)
    rest = _run(sim, TICKS - force_at - 1, after, force_at + 1)
    assert_states_equal(jax_state_to_numpy(jst), interop.sim_state_to_numpy(rest),
                        f"F={force_at}")
    # every connection that could enter freezing at F did: explore_counter 0
    # and not leaving an earlier freeze at F
    b, a = before.lb_state, after.lb_state
    leaving = b.is_freezing & (force_at > b.exit_freezing)
    can = (b.explore_counter == 0) & ~leaving
    assert bool(can.any())
    assert bool(a.is_freezing[can].all())
    entered = can & ~b.is_freezing
    assert bool(entered.any())
    timeout = sim.lb.cfg.freezing_timeout
    assert bool((a.exit_freezing[entered] == force_at + timeout).all())
    # the unhooked REPS leaves them unfrozen at F (no RTO fires before 400)
    p = _run(_sim(RepsLB(evs_size=T_CFG.evs_size)), 1, before, force_at).lb_state
    assert not bool(p.is_freezing[entered].any())


@pytest.mark.parametrize("hooked", [False, True])
def test_reps_tick_launches_per_tick(hooked, monkeypatch):
    """One ``reps_tick`` call per tick without the hook; one more at F (the
    ACK-only call) with it."""
    calls = []
    real = kernel_ops.reps_tick

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(kernel_ops, "reps_tick", counting)
    lb = (ForcedFreezeReps(force_at=30, evs_size=T_CFG.evs_size) if hooked
          else RepsLB(evs_size=T_CFG.evs_size))
    _sim(lb).run(60)
    assert len(calls) == 60 + hooked


def test_on_ack_only_subclass_raises():
    class OnAckOnly(RepsLB):
        def on_ack(self, state, mask, ev, ecn, now, draw):
            return state

    with pytest.raises(TypeError, match="after_acks"):
        OnAckOnly(evs_size=256)

    class Hooked(OnAckOnly):
        def after_acks(self, state, now):
            return state

    Hooked(evs_size=256)  # with the hook, the override is the subclass's own choice


def test_fig15_runs_equal_reference(monkeypatch):
    """fig15's forced-freeze cell past the forced freeze at tick 900."""
    rows = assert_runs_equal("fig15", monkeypatch, select=(1,), horizon=950)
    assert [r[0] for r in rows] == ["fig15/normal", "fig15/forced_freeze"]


def test_forced_freeze_changes_the_run():
    """The hook acts: the forced run differs from plain REPS after F."""
    forced = _sim(ForcedFreezeReps(force_at=40, evs_size=T_CFG.evs_size)).run(60)[0]
    plain = _sim(RepsLB(evs_size=T_CFG.evs_size)).run(60)[0]
    assert not torch.equal(forced.lb_state.is_freezing, plain.lb_state.is_freezing)
